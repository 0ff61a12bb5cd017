"""Fig.-1 trace entry point and the lean result container (counterpart
of ``repro.core.bounds``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import solver as _solver

BIFTrace = _solver.QuadratureTrace


class BIFBounds(NamedTuple):
    lower: torch.Tensor
    upper: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor


def bif_bounds_trace(op, u: torch.Tensor, lam_min, lam_max, num_iters: int,
                     reorth: bool = False) -> BIFTrace:
    """Run exactly ``num_iters`` GQL iterations, returning every estimate
    sequence (sugar over ``BIFSolver.trace``)."""
    return _solver.BIFSolver.create(reorth=reorth).trace(
        op, u, num_iters, lam_min=lam_min, lam_max=lam_max)
