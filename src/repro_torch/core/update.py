"""Incremental update/downdate of the selected set's Cholesky factor
(counterpart of ``repro.core.update``).

The chain drivers (greedy MAP, DPP/k-DPP moves) score Schur complements
``L_ii - L_{Y,i}^T L_Y^{-1} L_{Y,i}`` against a set Y that changes by one
item per round. This module keeps the Cholesky factor of the selected
principal submatrix ``L_Y`` under single-item add/remove, so every exact
BIF against Y is two triangular solves.

The layout is the reference's: the factor lives in a
``capacity x capacity`` buffer, slots ``0..count-1`` are occupied in
insertion order, empty slots hold identity rows/columns and the sentinel
index ``n`` (read as zeros). The reference's ``fori_loop``s become Python
loops over the slots that can change: ``from_mask`` extends by the
selected items only, and ``downdate`` rotates the occupied slots past the
removed one (on empty slots the reference's rotation is the exact
identity). Counts and flags stay 0-d tensors on the factor's device.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

# ChainFactor fields the writers (`extend` / `downdate`) never rewrite:
# `n` is the ground-set size, fixed at init_factor time (the reference's
# FACTOR_REPLACE_EXCLUDED).
FACTOR_REPLACE_EXCLUDED = ("n",)

# Floor for squared pivots: a numerically singular extension gets a tiny
# positive pivot instead of NaN-poisoning the factor.
_PIVOT_FLOOR = 1e-30


@dataclasses.dataclass(frozen=True)
class ChainFactor:
    """Fixed-capacity Cholesky factor of ``L[idx, idx]``.

    ``idx``  (capacity,) int32 -- slot -> item; empty slots hold ``n``.
    ``chol`` (capacity, capacity) -- lower Cholesky of the selected
             principal submatrix in slot order; identity on empty slots.
    ``count`` () int32 -- number of occupied slots (always a prefix).
    ``ok``   () bool -- False once an ``extend`` overflowed capacity.
    ``n``    ground-set size (the sentinel index).
    """
    idx: Tensor
    chol: Tensor
    count: Tensor
    ok: Tensor
    n: int

    @property
    def capacity(self) -> int:
        return self.chol.shape[-1]


def tree_select(pred, a: ChainFactor, b: ChainFactor) -> ChainFactor:
    """Fieldwise ``where`` over two same-capacity factors."""
    pred = torch.as_tensor(pred, device=a.chol.device)
    return dataclasses.replace(
        a, idx=torch.where(pred, a.idx, b.idx),
        chol=torch.where(pred, a.chol, b.chol),
        count=torch.where(pred, a.count, b.count),
        ok=torch.where(pred, a.ok, b.ok))


def init_factor(n: int, capacity: int, dtype=torch.float32,
                device=None) -> ChainFactor:
    """Empty factor over a ground set of ``n`` items."""
    m = int(capacity)
    return ChainFactor(
        idx=torch.full((m,), n, dtype=torch.int32, device=device),
        chol=torch.eye(m, dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        ok=torch.ones((), dtype=torch.bool, device=device), n=int(n))


def _take(x: Tensor, idx: Tensor, n: int) -> Tensor:
    """``x[idx]`` along the first axis, zeros where ``idx`` is the
    sentinel ``n`` (``jnp.take(..., fill_value=0)``)."""
    hit = idx < n
    rows = x[torch.where(hit, idx, torch.zeros_like(idx)).long()]
    hit = hit.reshape(hit.shape + (1,) * (rows.ndim - 1))
    return torch.where(hit, rows, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


def _lower_solve(chol: Tensor, v: Tensor) -> Tensor:
    """``chol^{-1} v`` for v (m,) or (m, k)."""
    rhs = v[:, None] if v.ndim == 1 else v
    w = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return w[:, 0] if v.ndim == 1 else w


def extend(f: ChainFactor, col: Tensor, y) -> ChainFactor:
    """Add item ``y``: O(capacity^2), no re-factorization.

    ``col`` is the full (unmasked) column ``L[:, y]`` of the base
    matrix; only the entries at selected items and ``col[y]`` are read.
    Overflow (``count == capacity``) returns the factor unchanged with
    ``ok=False``."""
    dt = f.chol.dtype
    y = int(y)
    if int(f.count) >= f.capacity:
        return dataclasses.replace(f, ok=torch.zeros_like(f.ok))
    col = col.to(dt)
    w = _lower_solve(f.chol, _take(col, f.idx, f.n))     # L[sel, y]
    d2 = col[y] - torch.sum(w * w)
    piv = torch.sqrt(torch.clamp(d2, min=_PIVOT_FLOOR))
    c = int(f.count)
    row = w.clone()                # w is 0 on empty slots
    row[c] = piv
    idx = f.idx.clone()
    idx[c] = y
    chol = f.chol.clone()
    chol[c] = row
    return dataclasses.replace(f, idx=idx, chol=chol, count=f.count + 1)


def downdate(f: ChainFactor, y) -> ChainFactor:
    """Remove item ``y``: O(capacity^2). Removing an item that is not
    selected returns ``f`` itself (the reference's exact identity)."""
    count = int(f.count)
    hits = torch.nonzero(f.idx[:count] == int(y)).flatten().tolist()
    if not hits:
        return f
    j = hits[0]
    m = f.capacity
    # Deleting row/column j leaves the trailing block S = chol[j+1:, j+1:]
    # needing S'S'^T = S S^T + q q^T with q = chol[j+1:, j]: a rank-1
    # Cholesky update, column by column over the occupied slots (the
    # reference's rotation on an empty slot is the identity).
    chol = f.chol.clone()
    q = chol[:, j].clone()
    q[:j + 1] = 0.0
    for p in range(j + 1, count):
        lpp = chol[p, p]
        qp = q[p]
        r = torch.sqrt(lpp * lpp + qp * qp)
        c = r / lpp
        s = qp / lpp
        colp = (chol[p + 1:, p] + s * q[p + 1:]) / c
        q[p + 1:] = c * q[p + 1:] - s * colp
        chol[p + 1:, p] = colp
        chol[p, p] = r
    # Compaction: drop row/column j, shift the tail up/left, identity
    # rows/columns and the sentinel on the newly empty slot.
    keep = torch.cat([torch.arange(j, device=chol.device),
                      torch.arange(j + 1, m, device=chol.device)])
    out = torch.eye(m, dtype=chol.dtype, device=chol.device)
    out[:count - 1, :count - 1] = chol[keep[:count - 1]][:, keep[:count - 1]]
    idx = torch.full_like(f.idx, f.n)
    idx[:count - 1] = f.idx[keep[:count - 1]]
    return dataclasses.replace(f, idx=idx, chol=out, count=f.count - 1)


def solve_w(f: ChainFactor, u: Tensor) -> Tensor:
    """``chol^{-1} u_Y``: the half-solve whose squared norm is the BIF."""
    return _lower_solve(f.chol, _take(u.to(f.chol.dtype), f.idx, f.n))


def bif(f: ChainFactor, u: Tensor) -> Tensor:
    """Exact ``u^T L_Y^{-1} u`` for ``u`` supported on the selected set
    (only the entries of ``u`` at selected items are read)."""
    w = solve_w(f, u)
    return torch.sum(w * w)


def gains(f: ChainFactor, diag: Tensor, cols: Tensor) -> Tensor:
    """Exact marginal gains ``diag_i - L[Y,i]^T L_Y^{-1} L[Y,i]`` for
    every candidate i, from one (capacity, N) triangular solve. ``cols``
    is the (N, N) stack with row i = column i of the symmetric base."""
    dt = f.chol.dtype
    w = _lower_solve(f.chol, _take(cols.to(dt), f.idx, f.n))
    return diag.to(dt) - torch.sum(w * w, dim=0)


def from_mask(op, mask, capacity: int | None = None) -> ChainFactor:
    """The factor of an existing selection (chain warm start), built by
    extending with the selected items in index order. ``capacity``
    defaults to the ground-set size."""
    n = op.n
    d = op.diag()
    f = init_factor(n, n if capacity is None else int(capacity),
                    dtype=d.dtype, device=d.device)
    mask = torch.as_tensor(mask, device=d.device)
    for i in torch.nonzero(mask > 0.5).flatten().tolist():
        e = torch.zeros(n, dtype=d.dtype, device=d.device)
        e[i] = 1.0
        f = extend(f, op.matvec(e), i)
    return f
