"""Stochastic trace estimation on the quadrature runtime (counterpart of
``repro.core.trace``).

``tr f(A) = E[z^T f(A) z]`` for Rademacher probes z (Hutchinson), and each
probe's bilinear form gets a retrospective quadrature bracket from the
matfun drive (core/matfun.py): probes run as lanes of the batched driver,
freeze per lane as their brackets resolve, and are resumable probe by
probe.

Two probe regimes:

  * ``num_probes=None``: EXACT mode, the N unit vectors e_i. The probe sum
    is ``tr f(A)``, so the combined bracket is a deterministic
    certificate on the true trace.
  * ``num_probes=P``: Hutchinson mode, P Rademacher probes. Probe i is
    drawn from its own ``torch.Generator`` seeded from ``(key, i)``, so
    the stream is reproducible and extendable: resuming with a larger
    ``num_probes`` adds the probes a direct run would have drawn. Or the
    caller passes the probes themselves (``probes=``, a (P', N) array,
    row i = probe i), which is how a test replays another
    implementation's draws. The deterministic bracket contains the
    probe-sample mean; the statistical interval widens it by a normal
    confidence-interval half-width over the probe midpoints.

Result fields: ``lower``/``upper`` the deterministic bracket on the probe
mean (on the trace itself in exact mode), ``estimate`` the mean of the
probe midpoints, ``stat_lower``/``stat_upper`` the bracket widened by
``z_conf * std(mid) / sqrt(P)``.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import operators as _ops
from . import solver as _solver

Tensor = torch.Tensor

# odd 64-bit constant that spreads (key, index) over the generator seeds
_MIX = 0x9E3779B97F4A7C15


class TraceQuadState(NamedTuple):
    """Probe-by-probe resume handle: which probes ran, and their banked
    brackets (host-side numpy). ``key_fp``/``interval`` fingerprint the
    probe stream and the spectral interval, so a resume with other
    probes or other lam bounds is rejected instead of silently mixing
    incompatible brackets."""
    fn: str
    count: int                 # probes consumed so far
    exact: bool                # unit-vector mode (num_probes=None)
    probe_lower: np.ndarray    # (lanes,) per-lane bracket lowers; a lane
    #                            is one probe (block_size=1) or one
    #                            b-probe block (block_size=b)
    probe_upper: np.ndarray    # (lanes,)
    iterations: np.ndarray     # (lanes,) quadrature iterations per lane
    key_fp: tuple = ()         # probe-stream fingerprint (empty if exact)
    interval: tuple = ()       # (lam_min, lam_max) the brackets used
    block_size: int = 1        # probes per lane; resumes must match


class TraceQuadResult(NamedTuple):
    lower: float               # deterministic bracket on the probe mean
    upper: float
    estimate: float            # mean of per-probe bracket midpoints
    stat_lower: float          # det bracket widened by the CI half-width
    stat_upper: float
    std_error: float           # std(mid) / sqrt(P)  (0.0 in exact mode)
    num_probes: int
    iterations: int            # total quadrature iterations spent
    state: TraceQuadState      # resume handle (probe-by-probe)


def rademacher_probe(key: int, index: int, n: int,
                     dtype=torch.float64) -> Tensor:
    """Probe ``index`` of the reproducible Hutchinson stream of ``key``,
    on the CPU: its own generator, seeded from (key, index)."""
    g = torch.Generator()
    g.manual_seed((int(key) * _MIX + int(index)) % (1 << 63))
    bits = torch.randint(0, 2, (n,), generator=g, dtype=torch.int8)
    return (2 * bits - 1).to(dtype)


def _probes(key, probes, start: int, stop: int, n: int, dtype, device,
            exact: bool) -> Tensor:
    """Rows ``start:stop`` of the probe stream on ``device``. Indices >= n
    in exact mode (block padding of the last block) are zero rows, which
    the block QR deflates: they contribute exactly 0."""
    if exact:
        idx = torch.arange(start, stop, device=device)
        cols = torch.arange(n, device=device)
        return (idx[:, None] == cols[None, :]).to(dtype)
    if probes is not None:
        return probes[start:stop].to(device=device, dtype=dtype)
    return torch.stack([rademacher_probe(key, i, n, dtype)
                        for i in range(start, stop)]).to(device)


def _fingerprint(key, probes, count: int) -> tuple:
    """What the first ``count`` probes were drawn from: the key, or a
    digest of the explicit probes' bytes."""
    if probes is None:
        return ("key", int(key))
    rows = probes[:count].detach().to("cpu", torch.float64).contiguous()
    return ("probes", hashlib.sha256(rows.numpy().tobytes()).hexdigest())


def trace_quad(op, fn: str = "log", num_probes: Optional[int] = None, *,
               lam_min, lam_max, solver: _solver.BIFSolver | None = None,
               max_iters: int = 64, rtol: float = 1e-4, atol: float = 1e-8,
               key: int | None = None, probes=None,
               probe_chunk: int | None = None, confidence: float = 0.95,
               mesh=None, lane_axis: str = "lanes", block_size: int = 1,
               state: TraceQuadState | None = None) -> TraceQuadResult:
    """Bracketed stochastic (or exact-probe) estimate of ``tr f(A)``.

    Probes run as lanes of the batched matfun driver on the operator's
    device: one stacked matvec per quadrature iteration across the probe
    block, lanes frozen as their brackets resolve.

    ``key`` (an int, default 0) seeds the probe stream; ``probes`` (a
    (P', N) array or tensor with P' >= num_probes) replaces it. ``state``
    resumes probe by probe: pass a previous result's ``.state`` with a
    larger ``num_probes`` and the same key (or the same leading probes),
    and only the new probes are solved.

    ``block_size = b > 1`` groups consecutive probes into b-wide blocks
    and runs each block as ONE lane of the block-Krylov driver: a lane
    brackets ``tr Z^T f(A) Z`` over its b probes. ``num_probes`` must be
    a multiple of b; the probe stream is unchanged, so extending a banked
    state adds whole blocks. The CI is over the per-block means (block
    midpoint / b). In exact mode the last block zero-pads past N.

    ``mesh`` (a lane mesh, ``launch.make_lane_mesh``) splits each chunk's
    probe lanes over its ranks (``solve_batch_sharded`` on ``lane_axis``);
    every rank returns the same result.

    ``lam_min``/``lam_max`` must bound the operator's spectrum. The trace
    is of the operator as given: for a ``Masked`` operator the identity
    block contributes ``(N - |Y|) * f(1)``, zero for f = log.
    """
    if mesh is not None:
        from ..launch.mesh import lane_rank
        lane_rank(mesh, lane_axis)   # a lane mesh, or raise now
    b = int(block_size)
    if b < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if solver is None:
        solver = _solver.BIFSolver.create(max_iters=max_iters, rtol=rtol,
                                          atol=atol, fn=fn, block_size=b)
    else:
        if solver.config.fn != fn:
            solver = solver.replace(fn=fn)  # SolverConfig validates the tag
        if solver.config.block_size != b:
            solver = solver.replace(block_size=b)

    n = op.n
    exact = num_probes is None
    total = n if exact else int(num_probes)
    if total < 1:
        raise ValueError(f"num_probes must be >= 1, got {num_probes}")
    if b > 1 and not exact and total % b:
        raise ValueError(
            f"num_probes={total} is not a multiple of block_size={b}; "
            f"block mode consumes whole probe blocks (the banked probe "
            f"stream stays extendable only on block boundaries)")
    if key is None:
        key = 0
    if probes is not None and not exact:
        probes = torch.as_tensor(np.asarray(probes)) \
            if not isinstance(probes, torch.Tensor) else probes
        if probes.ndim != 2 or probes.shape[-1] != n \
                or probes.shape[0] < total:
            raise ValueError(f"probes must be (P, N) with P >= "
                             f"num_probes={total} and N={n}, got "
                             f"{tuple(probes.shape)}")
    key_fp = () if exact else _fingerprint(key, probes, total)
    interval = tuple(torch.as_tensor(x, dtype=torch.float64).cpu()
                     .reshape(-1).tolist() for x in (lam_min, lam_max))

    if state is not None:
        if state.fn != fn or state.exact != exact:
            raise ValueError(
                f"resume state banks fn={state.fn!r} (exact={state.exact}); "
                f"got fn={fn!r} (exact={exact}) — trace states resume the "
                f"estimator they were started as")
        if not exact and state.key_fp != _fingerprint(key, probes,
                                                      state.count):
            raise ValueError(
                "resume state banks probes drawn from a different key; "
                "extending with a new key would mix incompatible probe "
                "streams — pass the original key (or state=None)")
        if state.interval != interval:
            raise ValueError(
                f"resume state banks brackets for the spectral interval "
                f"{state.interval}, got {interval} — mixed intervals "
                f"would mix incomparable brackets (pass state=None)")
        if state.block_size != b:
            raise ValueError(
                f"resume state banks block_size={state.block_size} lane "
                f"brackets; got block_size={b} — block traces are "
                f"tr over b-probe blocks and cannot be re-bucketed "
                f"(pass state=None)")
        if total < state.count:
            raise ValueError(
                f"num_probes={total} < {state.count} probes already banked; "
                f"resuming can only extend")
        done_lo = [state.probe_lower]
        done_hi = [state.probe_upper]
        done_it = [state.iterations]
        start = state.count
    else:
        done_lo, done_hi, done_it = [], [], []
        start = 0

    diag = op.diag()
    dtype, device = diag.dtype, _ops.op_device(op)
    # block mode walks padded probe indices (whole blocks; exact mode's
    # final block zero-pads past N) and rounds the chunk up to blocks
    walk_total = -(-total // b) * b
    chunk = walk_total - start if probe_chunk is None \
        else max(int(probe_chunk), 1)
    if b > 1:
        chunk = -(-chunk // b) * b
    pos = -(-start // b) * b   # banked lanes end on a block boundary
    while pos < walk_total:
        stop = min(pos + chunk, walk_total)
        us = _probes(key, probes, pos, stop, n, dtype, device, exact)
        if b > 1:
            us = us.reshape((stop - pos) // b, b, n)
        if mesh is None:
            res = solver.solve_batch(op, us, lam_min=lam_min,
                                     lam_max=lam_max)
        else:
            res = solver.solve_batch_sharded(op, us, mesh=mesh,
                                             axis=lane_axis,
                                             lam_min=lam_min,
                                             lam_max=lam_max)
        done_lo.append(res.lower.cpu().numpy())
        done_hi.append(res.upper.cpu().numpy())
        done_it.append(res.iterations.cpu().numpy())
        pos = stop

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    lo = np.concatenate(done_lo) if done_lo else np.zeros((0,), np_dtype)
    hi = np.concatenate(done_hi) if done_hi else np.zeros((0,), np_dtype)
    it = np.concatenate(done_it) if done_it else np.zeros((0,), np.int32)

    # exact mode: the SUM over the unit probes is tr f(A); Hutchinson:
    # the MEAN over the lanes, over the probes per lane b, estimates it,
    # and the CI is over the per-lane means mid / b
    mid = 0.5 * (lo + hi)
    if exact:
        mean_lo, mean_hi = float(lo.sum()), float(hi.sum())
        estimate = float(mid.sum())
        se = 0.0
    else:
        lane_mid = mid / b
        mean_lo, mean_hi = float(lo.mean() / b), float(hi.mean() / b)
        estimate = float(lane_mid.mean())
        se = float(np.std(lane_mid, ddof=1) / np.sqrt(len(lane_mid))) \
            if len(lane_mid) > 1 else 0.0
    z = float(torch.special.ndtri(torch.tensor(
        0.5 + 0.5 * confidence, dtype=torch.float64))) if se > 0.0 else 0.0
    half = z * se

    new_state = TraceQuadState(fn=fn, count=total, exact=exact,
                               probe_lower=lo, probe_upper=hi,
                               iterations=it, key_fp=key_fp,
                               interval=interval, block_size=b)
    return TraceQuadResult(
        lower=mean_lo, upper=mean_hi, estimate=estimate,
        stat_lower=mean_lo - half, stat_upper=mean_hi + half,
        std_error=se, num_probes=total,
        iterations=int(it.sum()), state=new_state)


def logdet_quad(op, num_probes: Optional[int] = None, *, lam_min, lam_max,
                **kwargs) -> TraceQuadResult:
    """Bracketed ``logdet(A) = tr log(A)`` (Bai & Golub 1996, on the
    retrospective runtime): ``trace_quad(op, 'log', ...)``."""
    return trace_quad(op, "log", num_probes, lam_min=lam_min,
                      lam_max=lam_max, **kwargs)
