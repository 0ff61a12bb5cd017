"""Block-Krylov quadrature: matrix-valued brackets on ``B^T f(A) B``
(counterpart of ``repro.core.block``).

For a starting block ``B = [u_1 .. u_b]`` the block three-term recurrence
builds a block-tridiagonal ``J_k``, and the matrix-valued Gauss and
Gauss-Radau rules ``R_0^T [f(J_k)]_11 R_0`` (and at the Radau extensions)
are Loewner-ordered approximants of ``B^T f(A) B``. Their traces feed the
scalar decision rules unchanged: one certificate per block of b probes.

  * Row convention: blocks are (..., b, N) row stacks, so one
    ``operators.matvec_mrhs`` call advances all b columns per iteration
    (one SpMM, kernel K5, on a blocked-ELL operator under 'pallas').
  * ``block_qr`` is modified Gram-Schmidt with fixed-shape deflation: a
    residual column whose norm falls under the tolerance gets a zero
    basis row and a zero R diagonal. Dead slots stay exact zeros, and a
    fully deflated block is Krylov exhaustion (Gauss is exact).
  * The Radau extensions use the block pivot recurrences
    ``D_{j+1} = A_{j+1} - lam I - B_j D_j^-1 B_j^T`` with
    eigenvalue-clamped inverses; at b = 1 they are gql.py's formulas.
  * ``_gram``/``_rowmat`` reduce by multiply-then-sum, so the b = 1 slot
    reproduces the scalar recurrence's ``sum(v * w)`` bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from . import matfun as _matfun
from . import operators as _ops
from .lanczos import BREAKDOWN_TOL

Tensor = torch.Tensor

_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class BlockState:
    """Per-lane block-Lanczos recurrence state.

    ``q``/``q_prev`` hold Q_{j+1}^T / Q_j^T as (..., b, N) row stacks;
    ``b_cur = B_j``; ``a_hist[..., i] = A_{i+1}``, ``b_hist[..., i] =
    B_{i+1}`` for i < it; ``delta_lr``/``delta_rr`` the last Radau pivot
    blocks of ``J_j - lam_min I`` / ``J_j - lam_max I``; ``r0`` the
    initial QR factor (U = Q_1 R_0); ``live`` the non-deflated slots of
    ``q``; ``done`` full deflation; ``it`` the block iterations done."""
    q_prev: Tensor     # (..., b, N)
    q: Tensor          # (..., b, N)
    b_cur: Tensor      # (..., b, b)
    a_hist: Tensor     # (..., M, b, b)
    b_hist: Tensor     # (..., M, b, b)
    delta_lr: Tensor   # (..., b, b)
    delta_rr: Tensor   # (..., b, b)
    r0: Tensor         # (..., b, b)
    fnidx: Tensor      # (...,) int32 matfun registry index
    live: Tensor       # (..., b) bool
    done: Tensor       # (...,) bool
    it: Tensor         # (...,) int32


# fields the per-step writer never rewrites: both are set at init
BLOCK_REPLACE_EXCLUDED = ("r0", "fnidx")


def _gram(q: Tensor, w: Tensor) -> Tensor:
    """(..., b, N) x (..., b, N) -> (..., b, b): out[l, m] = q_l . w_m,
    multiply-then-reduce (b = 1 bit parity with ``sum(v * w)``)."""
    return torch.sum(q[..., :, None, :] * w[..., None, :, :], dim=-1)


def _rowmat(a: Tensor, q: Tensor) -> Tensor:
    """(..., b, b) @ (..., b, N) row stacks: out[i] = sum_k a[i,k] q_k,
    multiply-then-reduce for the same b = 1 parity."""
    return torch.sum(a[..., :, :, None] * q[..., None, :, :], dim=-2)


def block_qr(z: Tensor, live_in: Tensor, tol):
    """Modified Gram-Schmidt QR of a (..., b, N) row stack with
    fixed-shape deflation: ``Z = R^T @ Q`` in row form.

    Slot i deflates when its orthogonalized residual norm is <= ``tol``
    (or ``live_in[i]`` is False): its basis row and R diagonal are exact
    zeros, while the projections R[l, i] (l < i) are kept. Returns
    ``(q, r, live)``."""
    b = z.shape[-2]
    r = torch.zeros(z.shape[:-2] + (b, b), dtype=z.dtype, device=z.device)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    qs, lives = [], []
    for i in range(b):
        zi = z[..., i, :]
        for l in range(i):  # noqa: E741 (textbook MGS index)
            proj = torch.sum(qs[l] * zi, dim=-1)
            r[..., l, i] = proj
            zi = zi - proj[..., None] * qs[l]
        nrm = torch.linalg.vector_norm(zi, dim=-1)
        alive = live_in[..., i] & (nrm > tol)
        qi = torch.where(alive[..., None],
                         zi / torch.clamp(nrm, min=_EPS)[..., None], zero)
        r[..., i, i] = torch.where(alive, nrm, zero)
        qs.append(qi)
        lives.append(alive)
    return torch.stack(qs, dim=-2), r, torch.stack(lives, dim=-1)


def _clamped_inv(m: Tensor, lower: bool) -> Tensor:
    """Inverse of a (nearly) definite pivot block via eigenvalue
    clamping: ``lower=True`` clamps eigenvalues up to +eps (pivots of
    J - lam_min I), ``lower=False`` down to -eps."""
    ms = 0.5 * (m + m.transpose(-1, -2))
    w, v = torch.linalg.eigh(ms)
    w = torch.clamp(w, min=_EPS) if lower else torch.clamp(w, max=-_EPS)
    return torch.einsum("...as,...s,...cs->...ac", v, 1.0 / w, v)


def _sandwich(b: Tensor, m: Tensor) -> Tensor:
    """B @ M @ B^T for (..., b, b) blocks."""
    return torch.einsum("...ab,...bc,...dc->...ad", b, m, b)


def _lam_block(lam, b: int, like: Tensor) -> Tensor:
    """lam * I_b with lam scalar or per-lane (...,)."""
    lam = torch.as_tensor(lam, dtype=like.dtype, device=like.device)
    return lam[..., None, None] * torch.eye(b, dtype=like.dtype,
                                            device=like.device)


def block_init(op, u: Tensor, lam_min, lam_max, fn, rows: int) -> BlockState:
    """QR of the (..., b, N) starting block + block iteration 1.

    ``rows`` sizes the A/B history (capacity in block iterations).
    Duplicate or zero probe columns deflate at the initial QR; a fully
    zero block is done at iteration one."""
    b = u.shape[-2]
    # relative deflation tolerance, scaled by the largest probe norm
    norms = torch.linalg.vector_norm(u, dim=-1)
    tol0 = BREAKDOWN_TOL * torch.clamp(torch.amax(norms, dim=-1), min=_EPS)
    live0 = torch.ones(u.shape[:-1], dtype=torch.bool, device=u.device)
    q1, r0, live1 = block_qr(u, live0, tol0)

    w = _ops.matvec_mrhs(op, q1)
    a_raw = _gram(q1, w)
    a1 = 0.5 * (a_raw + a_raw.transpose(-1, -2))
    scale = torch.amax(a1.abs(), dim=(-2, -1))
    z = w - _rowmat(a1, q1)
    q2, b1, live2 = block_qr(z, live1,
                             BREAKDOWN_TOL * torch.clamp(scale, min=1.0))

    lane_shape = tuple(u.shape[:-2])
    hist = torch.zeros(lane_shape + (rows, b, b), dtype=u.dtype,
                       device=u.device)
    a_hist, b_hist = hist, hist.clone()
    a_hist[..., 0, :, :] = a1
    b_hist[..., 0, :, :] = b1
    return BlockState(
        q_prev=q1, q=q2, b_cur=b1, a_hist=a_hist, b_hist=b_hist,
        delta_lr=a1 - _lam_block(lam_min, b, a1),
        delta_rr=a1 - _lam_block(lam_max, b, a1),
        r0=r0, fnidx=_matfun.fn_indices(fn, lane_shape, u.device),
        live=live2, done=~torch.any(live2, dim=-1),
        it=torch.ones(lane_shape, dtype=torch.int32, device=u.device))


def block_step(op, st: BlockState, lam_min, lam_max) -> BlockState:
    """One block three-term-recurrence iteration; done lanes pass
    through unchanged (the solver's ``tree_freeze`` applies on top)."""
    b = st.q.shape[-2]
    w = _ops.matvec_mrhs(op, st.q)
    a_raw = _gram(st.q, w)
    a_new = 0.5 * (a_raw + a_raw.transpose(-1, -2))
    scale = torch.amax(a_new.abs(), dim=(-2, -1))
    z = w - _rowmat(a_new, st.q) - _rowmat(st.b_cur, st.q_prev)
    q_next, b_new, live_new = block_qr(
        z, st.live, BREAKDOWN_TOL * torch.clamp(scale, min=1.0))

    # D_{j+1} = A_{j+1} - lam I - B_j D_j^-1 B_j^T
    d_lr = a_new - _lam_block(lam_min, b, a_new) \
        - _sandwich(st.b_cur, _clamped_inv(st.delta_lr, lower=True))
    d_rr = a_new - _lam_block(lam_max, b, a_new) \
        - _sandwich(st.b_cur, _clamped_inv(st.delta_rr, lower=False))

    # history write at the lane's own pre-step `it`
    m = st.a_hist.shape[-3]
    hit = ((torch.arange(m, dtype=st.it.dtype, device=st.it.device)
            == st.it[..., None]) & (~st.done)[..., None])[..., None, None]
    a_hist = torch.where(hit, a_new[..., None, :, :], st.a_hist)
    b_hist = torch.where(hit, b_new[..., None, :, :], st.b_hist)

    upd = ~st.done
    u1 = upd[..., None]
    u2 = upd[..., None, None]
    live = torch.where(u1, live_new, st.live)
    return dataclasses.replace(
        st,
        q_prev=torch.where(u2, st.q, st.q_prev),
        q=torch.where(u2, q_next, st.q),
        b_cur=torch.where(u2, b_new, st.b_cur),
        a_hist=a_hist, b_hist=b_hist,
        delta_lr=torch.where(u2, d_lr, st.delta_lr),
        delta_rr=torch.where(u2, d_rr, st.delta_rr),
        live=live,
        done=st.done | ~torch.any(live, dim=-1),
        it=st.it + upd.to(torch.int32))


def _assemble(st: BlockState, lam_min, lam_max) -> Tensor:
    """Stacked (..., 3, S, S) block-tridiagonal matrices, J_it and its two
    one-block-row Radau extensions, in ONE fixed buffer of S = (M+1)*b
    with a decoupled identity tail past the active blocks. Variant order:
    (gauss, radau_left, radau_right)."""
    ah = st.a_hist
    dtype, dev = ah.dtype, ah.device
    b = ah.shape[-1]
    m = ah.shape[-3]
    m1 = m + 1
    it = st.it
    eye_b = torch.eye(b, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    j1 = torch.arange(m1, dtype=it.dtype, device=dev)
    jm = torch.arange(m, dtype=it.dtype, device=dev)
    in_j1 = (j1 < it[..., None])[..., None, None]
    at_ext = (j1 == it[..., None])[..., None, None]
    in_gauss = (jm < (it - 1)[..., None])[..., None, None]
    in_ext = (jm < it[..., None])[..., None, None]

    # Park dead-slot diagonals at 1.0, like the identity tail: a dead
    # slot's eigenvalue at 0 would sit where the clamped f blows up, and
    # eigh's ~eps eigenvector contamination times 1e30 is O(1) garbage.
    dead_fix = torch.diagonal(ah, dim1=-2, dim2=-1) == 0.0
    a_fixed = ah + dead_fix.to(dtype)[..., None] * eye_b
    hist_pad = torch.cat([a_fixed, torch.broadcast_to(
        eye_b, ah.shape[:-3] + (1, b, b))], dim=-3)
    diag_base = torch.where(in_j1, hist_pad, eye_b)

    # Radau extension blocks  A_hat = lam I + B_it D_it^-1 B_it^T
    a_lr = _lam_block(lam_min, b, ah) \
        + _sandwich(st.b_cur, _clamped_inv(st.delta_lr, lower=True))
    a_rr = _lam_block(lam_max, b, ah) \
        + _sandwich(st.b_cur, _clamped_inv(st.delta_rr, lower=False))
    diag_lr = torch.where(at_ext, a_lr[..., None, :, :], diag_base)
    diag_rr = torch.where(at_ext, a_rr[..., None, :, :], diag_base)

    off_gauss = torch.where(in_gauss, st.b_hist, zero)
    off_ext = torch.where(in_ext, st.b_hist, zero)

    diags = torch.stack([diag_base, diag_lr, diag_rr], dim=-4)
    offs = torch.stack([off_gauss, off_ext, off_ext], dim=-4)

    # scatter the blocks into (..., 3, S, S): block diagonal, B^T above
    # it, B below it
    s = m1 * b
    lead = diags.shape[:-3]
    t = torch.zeros(lead + (m1, b, m1, b), dtype=dtype, device=dev)
    jj = torch.arange(m1, device=dev)
    t[..., jj, :, jj, :] = diags.movedim(-3, 0)
    off_t = offs.transpose(-1, -2)          # B_{j+1}^T above the diagonal
    t[..., jj[:-1], :, jj[1:], :] = off_t.movedim(-3, 0)
    t[..., jj[1:], :, jj[:-1], :] = offs.movedim(-3, 0)
    return t.reshape(lead + (s, s))


def _eig_weights(st: BlockState, lam_min, lam_max):
    """(theta, g) of the stacked variants: Ritz values (..., 3, S) and
    first-block weight vectors g[..., v, :, s] = R_0^T (v1)_s; the
    bracket matrix is ``sum_s f(theta_s) g_s g_s^T``."""
    b = st.a_hist.shape[-1]
    theta, vecs = torch.linalg.eigh(_assemble(st, lam_min, lam_max))
    v1 = vecs[..., :b, :]                                  # (..., 3, b, S)
    g = torch.einsum("...la,...vls->...vas", st.r0, v1)    # (..., 3, b, S)
    return theta, g


def estimates(st: BlockState, lam_min, lam_max) -> Tensor:
    """Traces of the three matrix-valued rules, stacked (..., 3) as
    (gauss, radau_left, radau_right). Exhausted lanes collapse onto the
    exact Gauss value."""
    theta, g = _eig_weights(st, lam_min, lam_max)
    w = torch.sum(g * g, dim=-2)                           # (..., 3, S)
    est = _matfun.select_fn(
        st.fnidx, lambda f: torch.sum(w * f.apply(theta), dim=-1))
    return torch.where(st.done[..., None], est[..., :1], est)


def bracket_matrices(st: BlockState, lam_min, lam_max) -> Tensor:
    """The three (..., 3, b, b) matrix-valued rules themselves."""
    theta, g = _eig_weights(st, lam_min, lam_max)
    fv = _matfun.select_fn(st.fnidx, lambda f: f.apply(theta))
    mats = torch.einsum("...vs,...vas,...vcs->...vac", fv, g, g)
    return torch.where(st.done[..., None, None, None], mats[..., :1, :, :],
                       mats)


def bracket(st: BlockState, lam_min, lam_max):
    """Sign-aware trace views ``(lower, upper, loose_lower, loose_upper)``
    on ``tr B^T f(A) B``. There is no block Lobatto rule, so the loose
    side Lobatto would supply repeats the tight Radau bound."""
    est = estimates(st, lam_min, lam_max)
    g, rl, rr = est[..., 0], est[..., 1], est[..., 2]
    gl = _matfun.gauss_is_lower(st.fnidx)
    lower = torch.where(gl, rr, rl)
    upper = torch.where(gl, rl, rr)
    return (lower, upper, torch.where(gl, g, lower),
            torch.where(gl, upper, g))
