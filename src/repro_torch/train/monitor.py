"""GQL spectral monitor, the paper's tie-in #2 (counterpart of
``repro.train.monitor``).

During training it brackets, with certified Gauss-Radau bounds,

    g^T (F + lam I)^{-1} g     (natural-gradient norm proxy)

where F is the Gram matrix of per-example gradient sketches (a Fisher
proxy). The operator is never materialised beyond a (B, K) sketch; its
matvec is two small matmuls, and a handful of Lanczos iterations give the
bracket, whose width is its own error certificate.

The sketch projects each gradient leaf onto ``num_probes`` Gaussian
directions. The reference draws leaf i's (num_probes, size) matrix from
``fold_in(key(seed), i)``; at olmo-1b's width one such matrix for an MLP
leaf is 17 GB in f32, so here the matrix is never whole: its entry (r, c)
is a counter-based draw that depends on (seed, i, r, c) alone (an integer
hash of the four, mapped to a normal by the inverse CDF), and the sketch
draws it block by block and accumulates. Any blocking gives the same
bits, and ``seed`` fixes every draw, so a run's sketches stay comparable
across steps. ``projections=`` replaces the draws (the tests feed the
reference's).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from .. import tree
from ..core import bounds as core_bounds
from ..core import operators as core_ops
from ..core import solver as core_solver
from ..core import spectrum as core_spectrum
from ..core import trace as core_trace
from ..core.operators import resolve_device
from ..models.model import value_and_grad

_M32 = 0xFFFFFFFF
_BLOCK_ELEMS = 1 << 25     # projection entries drawn at a time


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without
    overflowing int64."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (xorshift-multiply, two rounds); ``x`` is a
    Python int or an int64 tensor with values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def projection(seed: int, leaf: int, num_probes: int, start: int, stop: int,
               device="cpu") -> torch.Tensor:
    """Columns [start, stop) of leaf ``leaf``'s (num_probes, size) standard
    normal projection, f32 on ``device``."""
    k_leaf = _mix32(_mix32(seed & _M32) ^ (leaf & _M32))
    c = torch.arange(start, stop, dtype=torch.int64, device=device)
    hc = _mix32((c & _M32) ^ _mix32((c >> 32) ^ k_leaf))
    rows = torch.tensor([_mix32(k_leaf ^ _mix32(r)) for r in
                         range(num_probes)], dtype=torch.int64, device=device)
    h = _mix32(hc[None, :] ^ rows[:, None])
    # an odd integer in (-2^24, 2^24) over 2^24: exact in f32, never +-1
    x = (2 * (h >> 8) + 1 - (1 << 24)).to(torch.float32) * 2.0 ** -24
    return math.sqrt(2.0) * torch.erfinv(x)


def gradient_sketch(grads: Any, num_probes: int = 128, seed: int = 0, *,
                    projections=None) -> torch.Tensor:
    """Random-projection sketch of the gradient tree -> (num_probes,) f32:
    sum over leaves i of ``P_i @ g_i / sqrt(size_i)``. ``projections``: a
    sequence of (num_probes, size_i) standard normal matrices, one per
    leaf in tree order, used instead of the draws."""
    out = None
    for i, leaf in enumerate(tree.leaves(grads)):
        g = leaf.reshape(-1).to(torch.float32)
        size = g.numel()
        if projections is not None:
            proj = projections[i]
            if not isinstance(proj, torch.Tensor):
                proj = torch.tensor(proj)
            proj = proj.to(device=g.device, dtype=torch.float32)
            o = (proj / size ** 0.5) @ g
        else:
            w = max(1, _BLOCK_ELEMS // num_probes)
            o = torch.zeros(num_probes, dtype=torch.float32, device=g.device)
            for s in range(0, size, w):
                e = min(size, s + w)
                p = projection(seed, i, num_probes, s, e, g.device)
                o = o + (p / size ** 0.5) @ g[s:e]
        out = o if out is None else out + o
    return out


def _sketch_op(example_sketches: torch.Tensor, lam: float, batched: bool):
    b, k = example_sketches.shape
    s = example_sketches.to(torch.float32)

    if batched:
        # batched over leading dims of x (trace probes run as lanes)
        def matvec(x):
            return (x @ s.T) @ s / b + lam * x
    else:
        def matvec(x):
            return s.T @ (s @ x) / b + lam * x

    diag = torch.sum(s * s, dim=0) / b + lam
    return core_ops.MatvecFn(fn=matvec, n_static=k, diag_vals=diag), diag


def fisher_proxy_bounds(example_sketches: torch.Tensor, probe: torch.Tensor,
                        lam: float = 1e-3, max_iters: int = 24):
    """Bracket probe^T (F + lam I)^-1 probe for F = S^T S / B.

    example_sketches: (B, K) per-example gradient sketches; probe: (K,).
    Returns ``core.bounds.BIFBounds`` (lower/upper certified).
    """
    op, _ = _sketch_op(example_sketches, lam, batched=False)
    est = core_spectrum.lanczos_extremal(op, probe, num_iters=12)
    lam_min = max(lam * 0.5, 0.0) or float(est.lam_min)
    res = core_solver.BIFSolver.create(max_iters=max_iters, rtol=1e-2).solve(
        op, probe, lam_min=lam_min, lam_max=float(est.lam_max))
    return core_bounds.BIFBounds(lower=res.lower, upper=res.upper,
                                 iterations=res.iterations,
                                 converged=res.converged)


def logdet_bounds(example_sketches: torch.Tensor, lam: float = 1e-3,
                  num_probes: int | None = None, max_iters: int = 24):
    """Bracketed ``logdet(F + lam I)`` for the Fisher-proxy Gram matrix
    (the logdet crashing toward ``K log lam`` means the sketches span a
    shrinking subspace), by ``core.trace.trace_quad`` with f = log on the
    same sketch matvec. F is PSD, so ``lam`` floors the spectrum and the
    diagonal sum caps it. ``num_probes=None`` runs the K unit probes (a
    deterministic bracket of the true logdet)."""
    op, diag = _sketch_op(example_sketches, lam, batched=True)
    return core_trace.trace_quad(
        op, "log", num_probes, lam_min=lam * 0.999,
        lam_max=float(torch.sum(diag)), max_iters=max_iters, rtol=1e-6,
        atol=1e-6)


def condition_number_bounds(example_sketches: torch.Tensor, lam: float = 1e-3,
                            num_iters: int = 16):
    """kappa(F + lam I) from ``num_iters`` Lanczos steps on the ones probe.

    ``kappa_lower`` is certified: the Ritz top is at most lam_N and the
    Ritz bottom at least lam_1 (up to f32 rounding). It divides the bare
    Ritz values; the reference divides ``lanczos_extremal``'s interval,
    widened by 1% on both ends, which lands above the truth once Lanczos
    has converged on the top (ROADMAP Queue 3). ``lam_max_est`` is that
    widened top and ``kappa_upper = 1.1 lam_max_est / lam``, both as in
    the reference; ``kappa_upper`` is an estimate, an upper bound only
    while 1.1 lam_max_est >= lam_N."""
    op, _ = _sketch_op(example_sketches, lam, batched=False)
    probe = torch.ones(op.n, dtype=torch.float32,
                       device=example_sketches.device)
    est = core_spectrum.lanczos_extremal(op, probe, num_iters=num_iters)
    ritz = core_spectrum.lanczos_extremal(op, probe, num_iters=num_iters,
                                          slack=0.0)
    kappa_lower = float(ritz.lam_max) / max(float(ritz.lam_min), lam)
    kappa_upper = float(est.lam_max) * 1.1 / lam
    return {"kappa_lower": kappa_lower, "kappa_upper": kappa_upper,
            "lam_max_est": float(est.lam_max)}


def example_sketches(loss_fn, cfg, params, batch, *, n: int,
                     sketch_dim: int, projections=None):
    """(n, sketch_dim) sketches of the gradients of the batch's first
    ``n`` examples, one example at a time."""
    out = []
    for i in range(n):
        mb = tree.map(lambda x: x[i:i + 1], batch)
        _, g = value_and_grad(cfg, params, mb, loss=loss_fn)
        out.append(gradient_sketch(g, num_probes=sketch_dim,
                                   projections=projections))
        del g
    return torch.stack(out)


def make_monitor(loss_fn, cfg, lam: float = 1e-3, sketch_dim: int = 64,
                 per_example: int = 8, *, projections=None, device="cuda"):
    """``monitor_fn(params, batch)`` for ``train.loop``: certified
    natural-gradient-norm and logdet brackets and condition estimates of
    the per-example gradient sketches, as a dict of floats. The batch is
    moved to ``device``, where the parameters must live."""
    dev = resolve_device(device)

    def monitor(params, batch):
        batch = tree.map(lambda x: x.to(dev), batch)
        n = min(per_example, tree.leaves(batch)[0].shape[0])
        sketches = example_sketches(loss_fn, cfg, params, batch, n=n,
                                    sketch_dim=sketch_dim,
                                    projections=projections)
        bif = fisher_proxy_bounds(sketches, sketches.mean(0), lam=lam)
        cond = condition_number_bounds(sketches, lam=lam)
        ld = logdet_bounds(sketches, lam=lam)
        return {"nat_norm_lower": float(bif.lower),
                "nat_norm_upper": float(bif.upper),
                "quad_iters": int(bif.iterations),
                "logdet_lower": float(ld.lower),
                "logdet_upper": float(ld.upper), **cond}

    return monitor
