"""Gauss Quadrature Lanczos (GQL), paper Alg. 5, batched over lanes
(counterpart of ``repro.core.gql``).

Produces, per iteration i, the four quadrature estimates of
``u^T A^{-1} u``:

    g_i      Gauss             (lower bound, Thm. 2)
    g_i^rr   right Gauss-Radau (lower bound, tighter: Thm. 4)
    g_i^lr   left Gauss-Radau  (upper bound, tighter: Thm. 6)
    g_i^lo   Gauss-Lobatto     (upper bound)

Internally all estimates are for the unit-normalized problem
``e_1^T J_i^{-1} e_1`` and are multiplied by ||u||^2 at the API boundary.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lanczos as _lz

_EPS = 1e-30


class GQLState(NamedTuple):
    lz: _lz.LanczosState
    # Sherman-Morrison recursion state (unit-normalized)
    g: torch.Tensor          # Gauss estimate g_i
    c: torch.Tensor          # prod beta_j / delta_j
    delta: torch.Tensor      # last pivot of J_i
    delta_lr: torch.Tensor   # last pivot of J_i - lam_min I
    delta_rr: torch.Tensor   # last pivot of J_i - lam_max I
    # Per-iteration quadrature estimates (unit-normalized)
    g_rr: torch.Tensor
    g_lr: torch.Tensor
    g_lo: torch.Tensor
    # Scaling + termination
    u_norm_sq: torch.Tensor
    done: torch.Tensor       # lane finished (breakdown or frozen)
    it: torch.Tensor         # int32, iterations completed


def _max(x, eps):
    return torch.clamp(x, min=eps)


def _min(x, eps):
    return torch.clamp(x, max=eps)


def extension_coefficients(beta, d_lr, d_rr, lam_min, lam_max):
    """Golub (1973) modified last-row entries of the Radau/Lobatto
    extensions of J_i: ``(alpha_lr, alpha_rr, alpha_lo, b2_lo, b2)``."""
    b2 = beta * beta
    d_lr_s = _max(d_lr, _EPS)        # last pivot of (J - lmin I) > 0
    d_rr_s = _min(d_rr, -_EPS)       # last pivot of (J - lmax I) < 0
    alpha_lr = lam_min + b2 / d_lr_s
    alpha_rr = lam_max + b2 / d_rr_s
    denom_lo = d_rr_s - d_lr_s       # < 0
    b2_lo = (lam_max - lam_min) * d_lr_s * d_rr_s / denom_lo
    alpha_lo = (lam_max * d_rr_s - lam_min * d_lr_s) / denom_lo
    return alpha_lr, alpha_rr, alpha_lo, b2_lo, b2


def _extensions(g, c, delta, d_lr, d_rr, beta, lam_min, lam_max):
    """Radau/Lobatto estimates for the J_i extended with off-diag ``beta``."""
    alpha_lr, alpha_rr, alpha_lo, b2_lo, b2 = extension_coefficients(
        beta, d_lr, d_rr, lam_min, lam_max)
    delta_s = _max(delta, _EPS)
    c2 = c * c

    def sm(alpha_hat, b2_hat):
        den = delta_s * (alpha_hat * delta_s - b2_hat)
        # sign-preserving, never-zero guard
        safe = torch.where(den >= 0, _max(den, _EPS), _min(den, -_EPS))
        return g + b2_hat * c2 / safe

    return sm(alpha_rr, b2), sm(alpha_lr, b2), sm(alpha_lo, b2_lo)


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def gql_init(op, u: torch.Tensor, lam_min, lam_max) -> GQLState:
    """Iteration i=1 of Alg. 5."""
    lam_min = _as(lam_min, u)
    lam_max = _as(lam_max, u)
    lz = _lz.lanczos_init(op, u)
    u_norm_sq = torch.sum(u * u, dim=-1)

    alpha1, beta1 = lz.alpha, lz.beta
    g1 = 1.0 / _max(alpha1, _EPS)
    c1 = torch.ones_like(alpha1)
    delta1 = alpha1
    d_lr1 = alpha1 - lam_min
    d_rr1 = alpha1 - lam_max
    g_rr, g_lr, g_lo = _extensions(g1, c1, delta1, d_lr1, d_rr1, beta1,
                                   lam_min, lam_max)
    done = ~lz.live
    zero_u = u_norm_sq <= 0.0
    g1 = torch.where(zero_u, torch.zeros_like(g1), g1)
    g_rr = torch.where(done, g1, g_rr)
    g_lr = torch.where(done, g1, g_lr)
    g_lo = torch.where(done, g1, g_lo)
    return GQLState(lz=lz, g=g1, c=c1, delta=delta1, delta_lr=d_lr1,
                    delta_rr=d_rr1, g_rr=g_rr, g_lr=g_lr, g_lo=g_lo,
                    u_norm_sq=u_norm_sq, done=done | zero_u,
                    it=torch.ones_like(lz.it))


def recurrence_update(alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr,
                      lam_min, lam_max):
    """Pure-math body of one Alg. 5 iteration (no Lanczos, no freezing).
    Elementwise over lanes; the reference backend's recurrence."""
    b2p = beta_p * beta_p
    delta_s = _max(delta, _EPS)
    d_lr_s = _max(d_lr, _EPS)
    d_rr_s = _min(d_rr, -_EPS)

    den_g = delta_s * (alpha_n * delta_s - b2p)
    g_new = g + b2p * (c * c) / _max(den_g, _EPS)
    c_new = c * beta_p / delta_s
    delta_new = alpha_n - b2p / delta_s
    d_lr_new = alpha_n - lam_min - b2p / d_lr_s
    d_rr_new = alpha_n - lam_max - b2p / d_rr_s

    g_rr, g_lr, g_lo = _extensions(g_new, c_new, delta_new, d_lr_new,
                                   d_rr_new, beta_n, lam_min, lam_max)
    return g_new, c_new, delta_new, d_lr_new, d_rr_new, g_rr, g_lr, g_lo


def gql_assemble(st: GQLState, lz: _lz.LanczosState, raw) -> GQLState:
    """Fold one iteration's raw recurrence outputs into the next state:
    exact-collapse on Krylov exhaustion, frozen-lane pass-through, and
    done/it bookkeeping. The ONE home for this select logic, shared by
    :func:`gql_step` and the fused step (``kernels/lanczos_step.py``)."""
    (g_new, c_new, delta_new, d_lr_new, d_rr_new, g_rr, g_lr, g_lo) = raw

    # Lanes that just exhausted the Krylov space: the estimate is exact
    # (Lemma 15); collapse the bracket onto g.
    just_died = st.lz.live & ~lz.live
    g_rr = torch.where(just_died, g_new, g_rr)
    g_lr = torch.where(just_died, g_new, g_lr)
    g_lo = torch.where(just_died, g_new, g_lo)

    upd = ~st.done

    def sel(new, old):
        return torch.where(upd, new, old)

    return GQLState(
        lz=lz,
        g=sel(g_new, st.g), c=sel(c_new, st.c),
        delta=sel(delta_new, st.delta),
        delta_lr=sel(d_lr_new, st.delta_lr),
        delta_rr=sel(d_rr_new, st.delta_rr),
        g_rr=sel(g_rr, st.g_rr), g_lr=sel(g_lr, st.g_lr),
        g_lo=sel(g_lo, st.g_lo),
        u_norm_sq=st.u_norm_sq,
        done=st.done | ~lz.live,
        it=st.it + upd.to(torch.int32),
    )


def gql_step(op, st: GQLState, lam_min, lam_max,
             basis: torch.Tensor | None = None, recurrence=None) -> GQLState:
    """Iterations i>=2 of Alg. 5; frozen lanes pass through unchanged.

    ``recurrence`` swaps the scalar-update implementation (same signature
    and return as ``recurrence_update``); the solver routes it through the
    K1 kernel (``kernels/gql_update.py``) on ``backend='pallas'``.
    """
    if recurrence is None:
        recurrence = recurrence_update
    lam_min = _as(lam_min, st.g)
    lam_max = _as(lam_max, st.g)
    lz = _lz.lanczos_step(op, st.lz, basis=basis)
    # lz.alpha / lz.beta are alpha_{i+1} / beta_{i+1}; lz.beta_prev is
    # beta_i.
    raw = recurrence(lz.alpha, lz.beta, lz.beta_prev, st.g, st.c, st.delta,
                     st.delta_lr, st.delta_rr, lam_min, lam_max)
    return gql_assemble(st, lz, raw)


# ---------------------------------------------------------------------------
# Scaled views


def lower_bound(st: GQLState) -> torch.Tensor:
    """Best available lower bound: right Gauss-Radau (Thm. 4)."""
    return st.g_rr * st.u_norm_sq


def lower_bound_gauss(st: GQLState) -> torch.Tensor:
    return st.g * st.u_norm_sq


def upper_bound(st: GQLState) -> torch.Tensor:
    """Best available upper bound: left Gauss-Radau (Thm. 6)."""
    return st.g_lr * st.u_norm_sq


def upper_bound_lobatto(st: GQLState) -> torch.Tensor:
    return st.g_lo * st.u_norm_sq


def gap(st: GQLState) -> torch.Tensor:
    return (st.g_lr - st.g_rr) * st.u_norm_sq
