"""Matrix-function quadrature: ``u^T f(A) u`` brackets beyond f(x) = 1/x
(counterpart of ``repro.core.matfun``).

The GQL recurrence (core/gql.py) evaluates ``e_1^T J_i^{-1} e_1`` in O(1)
per iteration, a specialization to f(x) = 1/x. For any f whose
derivatives have constant sign on the spectral interval the same Gauss /
Radau / Lobatto rules bracket ``u^T f(A) u``; this module supplies that:

  * a REGISTRY of spectral functions (inv, log, invsqrt, sqrt) with the
    derivative-sign data that decides which rule bounds from which side;
  * :class:`CoeffHistory`, the per-lane alpha/beta history of the Lanczos
    tridiagonalization riding the solver's ``QuadState``;
  * :func:`estimates` / :func:`bracket`: all four estimates at iteration
    i from one stacked ``torch.linalg.eigh`` of the iteration-i Jacobi
    matrix and its Radau/Lobatto extensions, oriented per the sign table.

Derivative-sign -> bracket-orientation table (on (0, inf)):

  f        s_even  s_odd   lower family          upper family
  inv       +       -      Gauss, Radau-right    Radau-left, Lobatto
  invsqrt   +       -      Gauss, Radau-right    Radau-left, Lobatto
  log       -       +      Radau-left, Lobatto   Gauss, Radau-right
  sqrt      -       +      Radau-left, Lobatto   Gauss, Radau-right

The per-lane ``fnidx`` lets one batched drive mix spectral functions: the
eigensolve does not depend on f, only the ``f(theta)`` contraction does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import gql as _gql

Tensor = torch.Tensor

_EPS = 1e-30


def _safe_inv(x):
    return 1.0 / torch.clamp(x, min=_EPS)


def _safe_log(x):
    return torch.log(torch.clamp(x, min=_EPS))


def _safe_invsqrt(x):
    return torch.rsqrt(torch.clamp(x, min=_EPS))


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


@dataclasses.dataclass(frozen=True)
class SpectralFn:
    """One registry entry: how to evaluate f on Ritz values and which way
    each quadrature rule bounds. ``s_even``/``s_odd``: sign of the
    even/odd derivatives of f on (0, inf); ``guaranteed``: they are of
    constant sign, so the four rules are true bounds. ``apply`` clamps
    its argument away from 0 so padding eigenvalues stay finite."""
    name: str
    index: int
    s_even: int
    s_odd: int
    apply: Callable[[Tensor], Tensor]
    guaranteed: bool = True

    @property
    def gauss_is_lower(self) -> bool:
        return self.s_even > 0


REGISTRY: dict[str, SpectralFn] = {
    "inv": SpectralFn("inv", 0, +1, -1, _safe_inv),
    "log": SpectralFn("log", 1, -1, +1, _safe_log),
    "invsqrt": SpectralFn("invsqrt", 2, +1, -1, _safe_invsqrt),
    "sqrt": SpectralFn("sqrt", 3, -1, +1, _safe_sqrt),
}

_FNS = tuple(REGISTRY.values())
# static orientation table, indexed by fnidx
_GAUSS_IS_LOWER = tuple(f.gauss_is_lower for f in _FNS)


def fn_index(fn: str) -> int:
    if fn not in REGISTRY:
        raise ValueError(f"fn must be one of {tuple(REGISTRY)}, got {fn!r}")
    return REGISTRY[fn].index


def fn_name(index: int) -> str:
    return _FNS[int(index)].name


def fn_indices(fn, shape, device) -> Tensor:
    """Per-lane int32 registry indices: ``fn`` is a registry name (every
    lane) or a per-lane index array broadcast to ``shape``."""
    if isinstance(fn, str):
        return torch.full(shape, fn_index(fn), dtype=torch.int32,
                          device=device)
    idx = torch.as_tensor(fn, dtype=torch.int32, device=device)
    return torch.broadcast_to(idx, shape).clone()


def gauss_is_lower(fnidx: Tensor) -> Tensor:
    """The orientation table looked up per lane."""
    table = torch.as_tensor(_GAUSS_IS_LOWER, device=fnidx.device)
    return table[fnidx.long()]


def select_fn(fnidx: Tensor, values: Callable[[SpectralFn], Tensor]
              ) -> Tensor:
    """``values(f)`` for each lane's registered f: every f is evaluated,
    then the lane's own is kept (``fnidx`` broadcasts from the left)."""
    out = values(_FNS[0])
    for f in _FNS[1:]:
        hit = fnidx == f.index
        out = torch.where(hit.reshape(hit.shape + (1,) * (out.ndim
                                                            - hit.ndim)),
                          values(f), out)
    return out


@dataclasses.dataclass(frozen=True)
class CoeffHistory:
    """Per-lane Lanczos coefficient history riding the QuadState.

    ``alphas``/``betas`` (..., M): entry j holds alpha_{j+1}/beta_{j+1},
    valid for j < it. Writes go to each lane's own ``it`` cursor, so
    budget-frozen lanes that resume later keep a gapless history.
    ``fnidx`` (...,) int32 names each lane's spectral function."""
    alphas: Tensor
    betas: Tensor
    fnidx: Tensor


# fields the per-step writer never rewrites: `fnidx` is set at init
COEFF_REPLACE_EXCLUDED = ("fnidx",)


def init_coeffs(st0, fn, rows: int) -> CoeffHistory:
    """Coefficient storage for a fresh drive: capacity ``rows``
    iterations, row 0 = iteration 1 (``gql_init``'s alpha_1/beta_1).
    ``fn`` is a registry name (all lanes) or a per-lane index array."""
    g = st0.g
    shape = tuple(st0.it.shape)
    al = torch.zeros(shape + (rows,), dtype=g.dtype, device=g.device)
    be = torch.zeros_like(al)
    al[..., 0] = st0.lz.alpha
    be[..., 0] = st0.lz.beta
    return CoeffHistory(alphas=al, betas=be,
                        fnidx=fn_indices(fn, shape, g.device))


def update_coeffs(coeffs: CoeffHistory, st_prev, st_new) -> CoeffHistory:
    """Record the new iteration's (alpha, beta) at each advancing lane's
    own write cursor (its pre-step ``it``); finished lanes don't write."""
    m = coeffs.alphas.shape[-1]
    it = st_prev.it
    hit = (torch.arange(m, dtype=it.dtype, device=it.device)
           == it[..., None]) & (~st_prev.done)[..., None]
    return dataclasses.replace(
        coeffs,
        alphas=torch.where(hit, st_new.lz.alpha[..., None], coeffs.alphas),
        betas=torch.where(hit, st_new.lz.beta[..., None], coeffs.betas))


def _extension_scalars(st, lam_min, lam_max):
    """Modified last-row entries of the Radau/Lobatto extensions of J_i,
    from the pivots the GQL state carries, through the same
    ``gql.extension_coefficients`` the recurrence uses."""
    alpha_lr, alpha_rr, alpha_lo, b2_lo, _ = _gql.extension_coefficients(
        st.lz.beta, st.delta_lr, st.delta_rr, lam_min, lam_max)
    return alpha_lr, alpha_rr, alpha_lo, \
        torch.sqrt(torch.clamp(b2_lo, min=0.0)), st.lz.beta


def _as(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def estimates(coeffs: CoeffHistory, st, lam_min, lam_max) -> Tensor:
    """All four unit-normalized estimates of ``e_1^T f(J) e_1``, stacked
    (..., 4) as (gauss, radau_left, radau_right, lobatto).

    J_i and its three one-row extensions sit in ONE fixed-size (M+1, M+1)
    buffer; rows past the active block are decoupled (off-diagonal 0,
    diagonal 1) so their eigenpairs carry zero weight. The stacked
    (..., 4, M+1, M+1) batch is diagonalized by one ``torch.linalg.eigh``.
    Exhausted lanes collapse all four onto the exact Gauss value."""
    al, be = coeffs.alphas, coeffs.betas
    dtype, dev = al.dtype, al.device
    m = al.shape[-1]
    m1 = m + 1
    it = st.it
    lam_min = _as(lam_min, al)
    lam_max = _as(lam_max, al)

    j1 = torch.arange(m1, dtype=it.dtype, device=dev)
    jm = torch.arange(m, dtype=it.dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    diag_base = torch.where(
        j1 < it[..., None],
        torch.cat([al, torch.ones(al.shape[:-1] + (1,), dtype=dtype,
                                  device=dev)], dim=-1), one)
    off_gauss = torch.where(jm < (it - 1)[..., None], be, zero)
    off_ext = torch.where(jm < it[..., None], be, zero)

    a_lr, a_rr, a_lo, b_lo, _ = _extension_scalars(st, lam_min, lam_max)
    at_ext = j1 == it[..., None]
    at_blo = jm == (it - 1)[..., None]

    def ext_diag(alpha_hat):
        return torch.where(at_ext, alpha_hat[..., None], diag_base)

    diags = torch.stack([diag_base, ext_diag(a_lr), ext_diag(a_rr),
                         ext_diag(a_lo)], dim=-2)            # (..., 4, m1)
    offs = torch.stack([off_gauss, off_ext, off_ext,
                        torch.where(at_blo, b_lo[..., None], off_gauss)],
                       dim=-2)                               # (..., 4, m)

    t = torch.diag_embed(diags) + torch.diag_embed(offs, offset=1) \
        + torch.diag_embed(offs, offset=-1)
    theta, vecs = torch.linalg.eigh(t)
    weights = vecs[..., 0, :] ** 2                           # (..., 4, m1)

    est = select_fn(coeffs.fnidx,
                    lambda f: torch.sum(weights * f.apply(theta), dim=-1))
    # breakdown => the Gauss estimate is exact; collapse the bracket
    return torch.where(st.done[..., None], est[..., :1], est)


def bracket(coeffs: CoeffHistory, st, lam_min, lam_max):
    """Sign-aware views of :func:`estimates`, scaled by ``||u||^2``:
    ``(lower, upper, loose_lower, loose_upper)`` with (lower, upper) the
    tight Radau bracket and the loose pair Gauss/Lobatto."""
    est = estimates(coeffs, st, lam_min, lam_max)
    scale = st.u_norm_sq[..., None]
    est = torch.where(scale > 0.0, est * scale, torch.zeros_like(est))
    g, rl, rr, lo = est[..., 0], est[..., 1], est[..., 2], est[..., 3]
    gl = gauss_is_lower(coeffs.fnidx)
    return (torch.where(gl, rr, rl), torch.where(gl, rl, rr),
            torch.where(gl, g, lo), torch.where(gl, lo, g))


def log_gain_bounds(t, lo_bif: Tensor, hi_bif: Tensor):
    """Bounds on ``log(t - bif)`` given ``bif in [lo_bif, hi_bif]``:
    x -> log(t - x) is decreasing, so the log upper bound comes from the
    BIF lower bound and vice versa; a non-positive argument gives the
    -1e30 sentinel."""
    log = REGISTRY["log"].apply
    big_neg = torch.full((), -1e30, dtype=lo_bif.dtype, device=lo_bif.device)
    arg_hi = t - lo_bif
    arg_lo = t - hi_bif
    hi = torch.where(arg_hi > 0, log(arg_hi), big_neg)
    lo = torch.where(arg_lo > 0, log(arg_lo), big_neg)
    return lo, hi
