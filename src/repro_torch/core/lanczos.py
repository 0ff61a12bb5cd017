"""Batched Lanczos iteration (counterpart of ``repro.core.lanczos``).

The tridiagonalization driving GQL (paper Alg. 5) and the extremal
eigenvalue estimates (spectrum.py). All state carries arbitrary leading
lane dims; lanes advance in lockstep with masked freezing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BREAKDOWN_TOL = 1e-12


class LanczosState(NamedTuple):
    v_prev: torch.Tensor     # (..., N) u_{i-2}
    v: torch.Tensor          # (..., N) u_{i-1}
    alpha: torch.Tensor      # (...,)  alpha_i
    beta: torch.Tensor       # (...,)  beta_i
    beta_prev: torch.Tensor  # (...,)  beta_{i-1}
    it: torch.Tensor         # (...,)  int32 iteration counter (1-based)
    live: torch.Tensor       # (...,)  bool, False after breakdown


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def lanczos_init(op, u: torch.Tensor) -> LanczosState:
    """First Lanczos step: alpha_1 = u0^T A u0, beta_1 = ||(A - a1 I) u0||."""
    unorm = _norm(u)[..., None]
    v0 = u / torch.clamp(unorm, min=1e-30)
    w = op.matvec(v0)
    alpha1 = torch.sum(v0 * w, dim=-1)
    r = w - alpha1[..., None] * v0
    beta1 = _norm(r)
    live = beta1 > BREAKDOWN_TOL * torch.clamp(alpha1.abs(), min=1.0)
    v1 = torch.where(live[..., None],
                     r / torch.clamp(beta1, min=1e-30)[..., None],
                     torch.zeros((), dtype=r.dtype, device=r.device))
    it = torch.ones(alpha1.shape, dtype=torch.int32, device=u.device)
    return LanczosState(v_prev=v0, v=v1, alpha=alpha1, beta=beta1,
                        beta_prev=torch.zeros_like(beta1), it=it, live=live)


def lanczos_assemble(st: LanczosState, alpha: torch.Tensor,
                     beta: torch.Tensor, r: torch.Tensor) -> LanczosState:
    """Fold one step's raw outputs (``alpha``, ``beta = ||r||``, residual
    ``r``) into the next state: breakdown detection, residual
    normalization and pass-through of frozen lanes. The ONE home for this
    select logic, shared by :func:`lanczos_step` and the fused step
    (``kernels/lanczos_step.py``). Dead lanes may carry garbage in the raw
    inputs; every output masks them back to the old state."""
    still = st.live & (beta > BREAKDOWN_TOL
                       * torch.clamp(alpha.abs(), min=1.0))
    v_new = torch.where(still[..., None],
                        r / torch.clamp(beta, min=1e-30)[..., None],
                        torch.zeros((), dtype=r.dtype, device=r.device))
    keep = st.live
    return LanczosState(
        v_prev=torch.where(keep[..., None], st.v, st.v_prev),
        v=torch.where(keep[..., None], v_new, st.v),
        alpha=torch.where(keep, alpha, st.alpha),
        beta=torch.where(keep, beta, st.beta),
        beta_prev=torch.where(keep, st.beta, st.beta_prev),
        it=st.it + keep.to(torch.int32),
        live=still,
    )


def lanczos_step(op, st: LanczosState,
                 basis: torch.Tensor | None = None) -> LanczosState:
    """One three-term-recurrence step; frozen lanes are passed through.

    ``basis``: optional (..., M, N) stored Lanczos vectors for full
    reorthogonalization (paper Sec. 5.4); rows past the current iteration
    must be zero.
    """
    w = op.matvec(st.v)
    alpha = torch.sum(st.v * w, dim=-1)
    r = w - alpha[..., None] * st.v - st.beta[..., None] * st.v_prev
    if basis is not None:
        # r <- r - V^T (V r): one pass of CLASSICAL Gram-Schmidt, every
        # coefficient taken against the same pre-projection r
        coeff = torch.einsum("...mn,...n->...m", basis, r)
        r = r - torch.einsum("...mn,...m->...n", basis, coeff)
    beta = _norm(r)
    return lanczos_assemble(st, alpha, beta, r)


def tridiag_coefficients(op, u: torch.Tensor, num_iters: int):
    """Run ``num_iters`` Lanczos steps, returning (alphas, betas, valid),
    each (num_iters, ...), with valid[i] marking pre-breakdown entries."""
    st = lanczos_init(op, u)
    al, be, lv = [st.alpha], [st.beta], [st.live]
    for _ in range(num_iters - 1):
        st = lanczos_step(op, st)
        al.append(st.alpha)
        be.append(st.beta)
        lv.append(st.live)
    return torch.stack(al), torch.stack(be), torch.stack(lv)
