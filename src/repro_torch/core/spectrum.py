"""Extremal-eigenvalue estimation for the quadrature interval
(counterpart of ``repro.core.spectrum``).

Gauss-Radau/Lobatto need lam_min < lambda_1(A) and lam_max > lambda_N(A):

  * ``gershgorin_bounds`` -- always safe, often loose;
  * ``lanczos_extremal``  -- Ritz values from a few Lanczos steps, widened
    on both ends.

For principal submatrices A_Y, interlacing makes any valid interval for A
valid for every A_Y.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lanczos as _lz


class SpectrumBounds(NamedTuple):
    lam_min: torch.Tensor
    lam_max: torch.Tensor


def gershgorin_bounds(op, probe_rows=None) -> SpectrumBounds:
    """Gershgorin discs from the explicit rows of a dense operator."""
    a = getattr(op, "a", None)
    if a is None:
        raise ValueError("gershgorin_bounds needs an explicit-matrix operator")
    d = torch.diagonal(a, dim1=-2, dim2=-1)
    r = torch.sum(a.abs(), dim=-1) - d.abs()
    return SpectrumBounds(torch.amin(d - r, dim=-1), torch.amax(d + r, dim=-1))


def gershgorin_bounds_spd(op) -> SpectrumBounds:
    """Gershgorin interval clamped for an SPD matrix (f(x)=1/x needs
    lam_min > 0; a tiny positive lam_min only loosens the upper bounds)."""
    est = gershgorin_bounds(op)
    return SpectrumBounds(
        torch.maximum(est.lam_min, est.lam_max * 1e-9 + 1e-30), est.lam_max)


def be_pad(be: torch.Tensor, m: int) -> torch.Tensor:
    """Pad betas (..., m-1) to (..., m) so the k=1 shift lines up."""
    return torch.cat([be, torch.zeros(be.shape[:-1] + (1,), dtype=be.dtype,
                                      device=be.device)], dim=-1)


def lanczos_extremal(op, probe: torch.Tensor, num_iters: int = 16,
                     slack: float = 1e-2) -> SpectrumBounds:
    """Ritz-value interval from ``num_iters`` Lanczos steps on ``probe``,
    widened by ``slack`` on both ends. Batched over leading dims."""
    alphas, betas, valid = _lz.tridiag_coefficients(op, probe, num_iters)
    m = alphas.shape[0]
    al = torch.movedim(alphas, 0, -1)            # (..., m)
    be = torch.movedim(betas, 0, -1)[..., :-1]   # (..., m-1)
    va = torch.movedim(valid, 0, -1)
    # freeze dead coefficients to keep J well-formed
    al = torch.where(va, al, al[..., :1])
    be = torch.where(va[..., 1:], be, torch.zeros((), dtype=be.dtype,
                                                  device=be.device))
    eye = torch.eye(m, dtype=al.dtype, device=al.device)
    up = torch.diag(torch.ones(m - 1, dtype=al.dtype, device=al.device), 1)
    bp = be_pad(be, m)
    J = (al[..., :, None] * eye
         + bp[..., :, None] * up
         + bp[..., None, :] * up.T)
    evals = torch.linalg.eigvalsh(J)
    lo = evals[..., 0]
    hi = evals[..., -1]
    width = torch.maximum(hi - lo, hi.abs() * 1e-3 + 1e-12)
    lam_min = torch.maximum(lo - slack * width, hi * 1e-9 + 1e-30)
    return SpectrumBounds(lam_min, hi + slack * width)


def ridge_bounds(op, ridge: float, probe: torch.Tensor,
                 num_iters: int = 16) -> SpectrumBounds:
    """For kernels built as K + ridge*I the ridge is a certain lower
    bound; the top is estimated by Lanczos."""
    est = lanczos_extremal(op, probe, num_iters=num_iters)
    return SpectrumBounds(torch.as_tensor(ridge * 0.5, dtype=probe.dtype,
                                          device=probe.device), est.lam_max)
