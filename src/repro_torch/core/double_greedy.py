"""Retrospective stochastic double greedy (paper Alg. 8 / 9; counterpart
of ``repro.core.double_greedy``).

Maximizes the (generally non-monotone) submodular F(S) = log det(L_S)
with the 1/2-approximation algorithm of Buchbinder et al., replacing each
pair of exact marginal-gain evaluations with retrospective quadrature
brackets. Decisions match the exact algorithm run with the same uniform
draws. The draws are an input: one uniform per item, from a
``torch.Generator`` or a table. The masks are float32, as the
reference's are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import operators as _ops
from . import solver as _solver
from .dpp import _as_solver, _column, _exact_bif, _masked_dense, _with, \
    _without

Tensor = torch.Tensor


class DGResult(NamedTuple):
    selected: Tensor         # (N,) float mask X_N
    quad_iterations: Tensor
    uncertified: Tensor
    log_det: Tensor          # F(X_N), exact (for reporting)


def _logdet_masked(op, mask: Tensor) -> Tensor:
    return torch.linalg.slogdet(_masked_dense(op, mask))[1]


def double_greedy(op, uniforms, lam_min, lam_max, *, max_iters: int,
                  exact: bool = False, batched: bool = True,
                  solver: _solver.BIFSolver | None = None) -> DGResult:
    """Run Alg. 8 over the ground set [N], in order (sequential by
    definition). ``uniforms`` is a ``torch.Generator`` or an (N,) table:
    item i is added iff ``p_i [Delta^-]_+ <= (1 - p_i) [Delta^+]_+``.

    ``batched=True`` scores each item's X- and Y-side systems as two
    stacked-mask lanes of one batched driver; ``batched=False`` keeps the
    gap-weighted pair driver. Decisions are the same either way."""
    quad = _as_solver(solver, max_iters)
    n = op.n
    d = op.diag()
    dev = d.device
    mdt = torch.float32
    if isinstance(uniforms, torch.Generator):
        uniforms = torch.rand(n, generator=uniforms, dtype=mdt,
                              device=uniforms.device)
    uniforms = torch.as_tensor(uniforms)
    if uniforms.shape != (n,):
        raise ValueError(f"uniforms must be ({n},), one per item, got "
                         f"{tuple(uniforms.shape)}")
    x_mask = torch.zeros(n, dtype=mdt, device=dev)
    y_mask = torch.ones(n, dtype=mdt, device=dev)
    iters, unc = [], []
    for i in range(n):
        y_wo = _without(y_mask, i)               # Y' = Y_{i-1} \ {i}
        col = _column(op, i, n)
        u = col * x_mask                         # vs L_{X_{i-1}}
        v = col * y_wo                           # vs L_{Y'}
        t = d[i]
        p = uniforms[i].to(device=dev, dtype=mdt)
        if exact:
            bif_x = _exact_bif(op, x_mask, u)
            bif_y = _exact_bif(op, y_wo, v)
            big_neg = torch.tensor(-1e30, dtype=t.dtype, device=dev)
            gain_p = torch.where(t - bif_x > 0, torch.log(torch.clamp(
                t - bif_x, min=1e-30)), big_neg)
            gain_m = -torch.where(t - bif_y > 0, torch.log(torch.clamp(
                t - bif_y, min=1e-30)), big_neg)
            add = p * torch.clamp(gain_m, min=0.0) <= \
                (1 - p) * torch.clamp(gain_p, min=0.0)
            res = _solver.JudgeResult(
                decision=add,
                certified=torch.ones((), dtype=torch.bool, device=dev),
                iterations=torch.zeros((), dtype=torch.int32, device=dev))
        elif batched:
            op2 = _ops.stack_masks(op, torch.stack([x_mask, y_wo]))
            res = quad.judge_double_greedy_batch(
                op2, torch.stack([u, v]), t, p, lam_min=lam_min,
                lam_max=lam_max)
        else:
            res = quad.judge_double_greedy(
                _ops.Masked(op, x_mask), u, _ops.Masked(op, y_wo), v, t, p,
                lam_min=lam_min, lam_max=lam_max)
        if bool(res.decision):
            x_mask = _with(x_mask, i)
        else:
            y_mask = y_wo
        iters.append(res.iterations)
        unc.append((~res.certified).to(torch.int32))
    ld = _logdet_masked(op, x_mask) if isinstance(op, _ops.Dense) \
        else torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    return DGResult(selected=x_mask,
                    quad_iterations=torch.sum(torch.stack(iters),
                                              dtype=torch.int32),
                    uncertified=torch.sum(torch.stack(unc),
                                          dtype=torch.int32),
                    log_det=ld)
