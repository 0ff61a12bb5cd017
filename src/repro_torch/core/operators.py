"""Linear-operator abstraction used by the quadrature core (counterpart
of ``repro.core.operators``).

Every operator is a frozen dataclass of tensors exposing:

  * ``matvec(x)``   -- y = A @ x, batched over leading dims of ``x``;
  * ``diag()``      -- the diagonal (Jacobi preconditioning / Gershgorin);
  * ``n``           -- the dimension N.

Operators compose: ``Masked(Dense(A), m)`` is the fixed-shape stand-in
for the principal submatrix A_Y, and ``Jacobi(...)`` applies the
similarity transform of paper Sec. 5.4. An operator's tensors live on
one device; the solver computes there.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and
    missing (the port never lands on the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch path")
    return dev


def _broadcast_shape(a, b) -> tuple:
    """The broadcast of two shapes. (``torch.broadcast_shapes`` imports
    its symbolic-shape machinery at the first call of a process, which
    costs seconds; a matvec must not.)"""
    n = max(len(a), len(b))
    a = (1,) * (n - len(a)) + tuple(a)
    b = (1,) * (n - len(b)) + tuple(b)
    out = []
    for x, y in zip(a, b):
        if x != y and x != 1 and y != 1:
            raise ValueError(f"shapes {a} and {b} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _promoted(a: torch.Tensor, x: torch.Tensor) -> tuple:
    """``a`` and ``x`` in their common dtype. ``torch.einsum`` refuses
    mixed float types where the reference's ``jnp.einsum`` promotes them
    (an f32 matrix against f64 vectors computes in f64)."""
    dt = torch.promote_types(a.dtype, x.dtype)
    return a.to(dt), x.to(dt)


@dataclasses.dataclass(frozen=True)
class Dense:
    """Explicit dense symmetric matrix, shape (..., N, N)."""
    a: torch.Tensor

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        a, x = _promoted(self.a, x)
        return torch.einsum("...ij,...j->...i", a, x)

    def diag(self) -> torch.Tensor:
        return torch.diagonal(self.a, dim1=-2, dim2=-1)


def _coo_ell(rows, cols, n: int) -> torch.Tensor:
    """Row-sorted slot table of a padded-COO pattern: (..., n, W) indices
    into the nnz axis, one row of slots per matrix row in the entries'
    original order, padded with the sentinel index ``nnz``. Entries with
    a row or column outside [0, n) are dropped, as the reference's
    ``mode='drop'`` scatter and ``fill_value=0`` gather do."""
    batch = tuple(rows.shape[:-1])
    nnz = rows.shape[-1]
    lanes = int(np.prod(batch)) if batch else 1
    dev = rows.device
    r = rows.reshape(lanes, nnz).long()
    c = cols.reshape(-1, nnz).long().expand(lanes, nnz)
    valid = (r >= 0) & (r < n) & (c >= 0) & (c < n)
    key = torch.where(valid, r, torch.full_like(r, n))
    gkey = (torch.arange(lanes, device=dev)[:, None] * (n + 1)
            + key).reshape(-1)
    order = torch.sort(gkey, stable=True).indices
    skey = gkey[order]
    counts = torch.bincount(gkey, minlength=lanes * (n + 1))
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(gkey.numel(), device=dev) - starts[skey]
    live = (skey % (n + 1)) < n
    width = int(counts.reshape(lanes, n + 1)[:, :n].max()) \
        if n > 0 and nnz > 0 else 0
    ell = torch.full((lanes * (n + 1), max(width, 1)), nnz,
                     dtype=torch.long, device=dev)
    ell[skey[live], slot[live]] = order[live] % max(nnz, 1)
    return ell.reshape(lanes, n + 1, -1)[:, :n].reshape(
        batch + (n, ell.shape[-1]))


@dataclasses.dataclass(frozen=True)
class SparseCOO:
    """Symmetric sparse matrix in padded COO form, fixed nnz.

    ``rows``/``cols``/``vals`` have shape (..., nnz); padding entries carry
    ``rows == n`` and are dropped. With a shared pattern (1-D
    ``rows``/``cols``) any leading batch dims of ``x`` and/or ``vals``
    broadcast; a stacked operator (``stack_ops``) carries lane dims on the
    index arrays too, and ``x`` must match them.

    The reference scatters with ``.at[rows].add`` (operators.py:78, :89);
    on CUDA a scatter-add uses atomics and its sums change from run to
    run. So the pattern is sorted by row once, at construction, into a
    slot table, and the matvec is a gather and a plain sum over each
    row's slots: no atomics, the same bits every run.
    """
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n_static: int
    diag_vals: torch.Tensor  # (..., N) dense diagonal, kept explicitly
    ell: torch.Tensor = dataclasses.field(init=False, repr=False,
                                          compare=False)

    def __post_init__(self):
        object.__setattr__(self, "ell",
                           _coo_ell(self.rows, self.cols, self.n_static))

    @property
    def n(self) -> int:
        return self.n_static

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_static
        vals = F.pad(self.vals, (0, 1))             # sentinel slot: 0
        cols = F.pad(self.cols.long(), (0, 1))      # sentinel col: 0
        if self.rows.ndim == 1:
            w = self.ell.shape[-1]
            flat = self.ell.reshape(-1)
            vg = vals[..., flat].reshape(vals.shape[:-1] + (n, w))
            xg = x[..., cols[flat]].reshape(x.shape[:-1] + (n, w))
            return torch.sum(vg * xg, dim=-1).to(x.dtype)
        b = _broadcast_shape(self.rows.shape[:-1], x.shape[:-1])
        w = self.ell.shape[-1]
        ell = torch.broadcast_to(self.ell, b + (n, w)).reshape(-1, n * w)
        lanes = ell.shape[0]
        vals = torch.broadcast_to(vals, b + vals.shape[-1:]).reshape(
            lanes, -1)
        cols = torch.broadcast_to(cols, b + cols.shape[-1:]).reshape(
            lanes, -1)
        xf = torch.broadcast_to(x, b + x.shape[-1:]).reshape(lanes, -1)
        vg = torch.take_along_dim(vals, ell, dim=-1)
        xg = torch.take_along_dim(xf, torch.take_along_dim(cols, ell, -1),
                                  dim=-1)
        y = torch.sum((vg * xg).reshape(lanes, n, w), dim=-1)
        return y.reshape(b + (n,)).to(x.dtype)

    def diag(self) -> torch.Tensor:
        return self.diag_vals


def sparse_from_dense(a, nnz: int | None = None, *,
                      device="cuda") -> SparseCOO:
    """Build a padded-COO operator from a dense numpy matrix."""
    dev = resolve_device(device)
    a = np.asarray(a)
    n = a.shape[-1]
    r, c = np.nonzero(a)
    v = a[r, c]
    cap = int(nnz) if nnz is not None else len(r)
    if len(r) > cap:
        raise ValueError(f"nnz={len(r)} exceeds capacity {cap}")
    pad = cap - len(r)
    r = np.concatenate([r, np.full(pad, n, dtype=r.dtype)])
    c = np.concatenate([c, np.zeros(pad, dtype=c.dtype)])
    v = np.concatenate([v, np.zeros(pad, dtype=v.dtype)])

    def t(x):
        return torch.as_tensor(x, device=dev)

    return SparseCOO(t(r), t(c), t(v), n,
                     t(np.diagonal(a, axis1=-2, axis2=-1).copy()))


_BELL_MODES = ("reference", "pallas")


@dataclasses.dataclass(frozen=True)
class SparseBELL:
    """Symmetric sparse matrix in blocked-ELL form.

    ``data`` (..., R, K, bs, bs) holds up to K non-zero bs x bs blocks per
    block-row, ``cols`` (..., R, K) int32 their block-column indices
    (padding blocks point at column 0 with zero data). N may be smaller
    than R*bs; matvec zero-pads and slices at the boundary.

    ``mode`` picks the execution path: 'reference' is the plain einsum,
    'pallas' the K2 kernel (``kernels/spmv_bell.py``; its plain version on
    CPU tensors), which accumulates in f32: x is cast to f32 and the
    result back to x's dtype, as operators.py:177, :190 do. The solver
    rebinds ``mode`` from ``SolverConfig.backend`` via
    ``configure_backend``. ``interpret`` is kept for config parity; True
    with CUDA tensors raises (there is no interpret mode on the card).

    Leading lane dims on ``data``/``cols`` (a ``stack_ops`` stack) batch
    the system; ``x`` must then carry matching lane dims.
    """
    data: torch.Tensor
    cols: torch.Tensor
    diag_vals: torch.Tensor  # (..., N)
    n_static: int
    mode: str = "reference"
    interpret: bool | None = None

    def __post_init__(self):
        if self.mode not in _BELL_MODES:
            raise ValueError(f"mode must be one of {_BELL_MODES}, "
                             f"got {self.mode!r}")

    @property
    def n(self) -> int:
        return self.n_static

    def configured(self, backend: str, interpret: bool | None
                   ) -> "SparseBELL":
        mode = "pallas" if backend == "pallas" else "reference"
        if mode == self.mode and interpret == self.interpret:
            return self
        return dataclasses.replace(self, mode=mode, interpret=interpret)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        from ..kernels import spmv_bell as _sb
        r, _, bs, _ = self.data.shape[-4:]
        npad = r * bs
        pad = npad - x.shape[-1]
        xp = F.pad(x, (0, pad)) if pad else x
        if self.mode == "reference":
            y = _sb.bell_matvec_ref(self.data, self.cols, xp)
        else:
            from ..kernels import ops as _kops
            if self.interpret and self.data.device.type == "cuda":
                raise ValueError("interpret=True has no meaning for CUDA "
                                 "tensors: there is no interpret mode on "
                                 "the card")
            lanes = _broadcast_shape(self.data.shape[:-4],
                                           xp.shape[:-1])
            xb = torch.broadcast_to(xp, lanes + (npad,))
            if not lanes:
                y = _kops.bell_matvec(self.data, self.cols, xb)
            elif self.data.ndim == 4:
                y = _kops.bell_matvec(self.data, self.cols,
                                      xb.reshape(-1, npad).contiguous())
            else:
                db = torch.broadcast_to(self.data,
                                        lanes + self.data.shape[-4:])
                cb = torch.broadcast_to(self.cols,
                                        lanes + self.cols.shape[-2:])
                y = _kops.bell_matvec(
                    db.reshape((-1,) + db.shape[-4:]).contiguous(),
                    cb.reshape((-1,) + cb.shape[-2:]).contiguous(),
                    xb.reshape(-1, npad).contiguous())
            y = y.reshape(lanes + (npad,)).to(x.dtype)
        return y[..., :self.n_static] if pad else y

    def diag(self) -> torch.Tensor:
        return self.diag_vals


def bell_from_dense(a, bs: int = 128, k_max: int | None = None,
                    dtype=None, mode: str = "reference",
                    interpret: bool | None = None, *,
                    device="cuda") -> SparseBELL:
    """Build a blocked-ELL operator from a dense numpy matrix on
    ``device``. ``dtype=None`` keeps the input dtype (pass float32 data
    for the kernel path, as operators.py:206-207 asks)."""
    from ..kernels import spmv_bell as _sb
    dev = resolve_device(device)
    a = np.asarray(a)
    data, cols, n = _sb.dense_to_bell(
        a, bs=bs, k_max=k_max, dtype=a.dtype if dtype is None else dtype)
    data_t = torch.as_tensor(data, device=dev)
    return SparseBELL(data_t, torch.as_tensor(cols, device=dev),
                      torch.as_tensor(np.diagonal(a).copy(), device=dev
                                      ).to(data_t.dtype),
                      n, mode=mode, interpret=interpret)


@dataclasses.dataclass(frozen=True)
class Masked:
    """Fixed-shape principal-submatrix operator: with P = diag(mask),
    represents  P A P + (I - P). Lanczos on it from a u supported on the
    mask is exactly Lanczos on A_Y. ``mask`` (..., N) may be batched."""
    base: Any
    mask: torch.Tensor  # float {0.,1.} or bool

    @property
    def n(self) -> int:
        return self.base.n

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        m = self.mask.to(x.dtype)
        return m * self.base.matvec(m * x) + (1.0 - m) * x

    def diag(self) -> torch.Tensor:
        d = self.base.diag()
        m = self.mask.to(d.dtype)
        return m * d + (1.0 - m)


@dataclasses.dataclass(frozen=True)
class Shifted:
    """A + sigma * I. ``sigma`` is a scalar, or (...,) lane-batched (a
    ``stack_ops`` stack): batch dims pair with the batch dims of ``x``."""
    base: Any
    sigma: Any

    @property
    def n(self) -> int:
        return self.base.n

    def _sigma_col(self) -> torch.Tensor:
        s = torch.as_tensor(self.sigma)
        return s[..., None] if s.ndim else s

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.matvec(x) + self._sigma_col() * x

    def diag(self) -> torch.Tensor:
        return self.base.diag() + self._sigma_col()


@dataclasses.dataclass(frozen=True)
class Jacobi:
    """Jacobi-preconditioned similarity transform (paper Sec. 5.4): with
    C = diag(A)^(-1/2), u^T A^-1 u = (Cu)^T (C A C)^-1 (Cu). This operator
    *is* C A C; ``transform_vector`` gives Cu."""
    base: Any
    inv_sqrt_diag: torch.Tensor  # (..., N)

    @classmethod
    def create(cls, base) -> "Jacobi":
        d = base.diag()
        return cls(base, torch.rsqrt(torch.clamp(d, min=1e-30)))

    @property
    def n(self) -> int:
        return self.base.n

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.inv_sqrt_diag * self.base.matvec(self.inv_sqrt_diag * x)

    def diag(self) -> torch.Tensor:
        return self.inv_sqrt_diag ** 2 * self.base.diag()

    def transform_vector(self, u: torch.Tensor) -> torch.Tensor:
        return self.inv_sqrt_diag * u


@dataclasses.dataclass(frozen=True)
class MatvecFn:
    """Wrap a closure (..., N) -> (..., N) as an operator."""
    fn: Any
    n_static: int
    diag_vals: torch.Tensor

    @property
    def n(self) -> int:
        return self.n_static

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def diag(self) -> torch.Tensor:
        return self.diag_vals


_OPERATORS = (Dense, SparseCOO, SparseBELL, Masked, Shifted, Jacobi,
              MatvecFn)


def op_device(op) -> torch.device:
    """The device an operator's tensors live on."""
    if isinstance(op, Dense):
        return op.a.device
    if isinstance(op, SparseBELL):
        return op.data.device
    if isinstance(op, SparseCOO):
        return op.vals.device
    if isinstance(op, (Masked, Shifted, Jacobi)):
        return op_device(op.base)
    if isinstance(op, MatvecFn):
        return op.diag_vals.device
    raise TypeError(f"not an operator: {type(op).__name__}")


# ---------------------------------------------------------------------------
# Multi-vector right-hand sides (block-Krylov mode)


def matvec_mrhs(op, x: torch.Tensor) -> torch.Tensor:
    """y = A @ X for a row-stacked block X of shape (..., b, N). Row i of
    the output is ``op.matvec`` of row i of ``x``, shaped so Dense and
    BELL operators see ONE product over all b rows instead of b matvecs.
    Leading dims of ``x`` before the block axis are lanes and pair with
    lane-stacked operator fields as in ``matvec``; the block axis is
    local to each lane."""
    if isinstance(op, Dense):
        # lanes broadcast against op.a's batch dims; b rides the product
        a, x = _promoted(op.a, x)
        return torch.einsum("...ij,...bj->...bi", a, x)
    if isinstance(op, SparseCOO):
        if op.rows.ndim == 1:
            return op.matvec(x)  # a shared pattern broadcasts over (..., b)
        return _coo_block_axis(op).matvec(x)
    if isinstance(op, SparseBELL):
        return _bell_mrhs(op, x)
    if isinstance(op, Masked):
        m = op.mask.to(x.dtype)
        mb = m[..., None, :] if m.ndim > 1 else m
        return mb * matvec_mrhs(op.base, mb * x) + (1.0 - mb) * x
    if isinstance(op, Shifted):
        s = torch.as_tensor(op.sigma)
        sb = s[..., None, None] if s.ndim else s
        return matvec_mrhs(op.base, x) + sb * x
    if isinstance(op, Jacobi):
        c = op.inv_sqrt_diag
        cb = c[..., None, :] if c.ndim > 1 else c
        return cb * matvec_mrhs(op.base, cb * x)
    # MatvecFn: closures take (..., N) batches, the block axis is one more
    return op.matvec(x)


def _coo_block_axis(op: SparseCOO) -> SparseCOO:
    """A lane-stacked COO operator with a length-1 block axis on every
    per-lane field (the slot table included, so nothing is re-sorted),
    so its gather broadcasts over the (..., b, N) block rows."""
    out = copy.copy(op)
    for name in ("rows", "cols", "vals", "diag_vals"):
        object.__setattr__(out, name, getattr(op, name)[..., None, :])
    object.__setattr__(out, "ell", op.ell[..., None, :, :])
    return out


def _bell_mrhs(op: SparseBELL, x: torch.Tensor) -> torch.Tensor:
    """Blocked-ELL SpMM over (..., b, N) row stacks. 'reference' is the
    plain gather in x's dtype; 'pallas' runs kernel K5 (its plain version
    on CPU tensors) with f32 accumulation, and the result is cast back to
    x's dtype. x is zero-padded to R*bs and the result sliced back."""
    from ..kernels import spmv_bell as _sb
    r, _, bs, _ = op.data.shape[-4:]
    npad = r * bs
    pad = npad - x.shape[-1]
    xp = F.pad(x, (0, pad)) if pad else x
    if op.mode == "reference":
        if op.cols.ndim == 2:
            y = _sb.bell_matvec_ref(op.data, op.cols, xp)
        else:
            y = _sb.bell_matvec_ref(op.data[..., None, :, :, :, :],
                                    op.cols[..., None, :, :], xp)
    else:
        from ..kernels import ops as _kops
        if op.interpret and op.data.device.type == "cuda":
            raise ValueError("interpret=True has no meaning for CUDA "
                             "tensors: there is no interpret mode on the "
                             "card")
        b = xp.shape[-2]
        lanes = _broadcast_shape(op.data.shape[:-4], xp.shape[:-2])
        xb = torch.broadcast_to(xp, lanes + (b, npad)).reshape(-1, b, npad)
        if op.data.ndim == 4:
            y = _kops.bell_matvec_mrhs(op.data, op.cols, xb)
        else:
            db = torch.broadcast_to(op.data, lanes + op.data.shape[-4:])
            cb = torch.broadcast_to(op.cols, lanes + op.cols.shape[-2:])
            y = _kops.bell_matvec_mrhs(
                db.reshape((-1,) + db.shape[-4:]).contiguous(),
                cb.reshape((-1,) + cb.shape[-2:]).contiguous(), xb)
        y = y.reshape(lanes + (b, npad)).to(x.dtype)
    return y[..., :op.n_static] if pad else y


# ---------------------------------------------------------------------------
# Batched-system helpers


def _stack_leaf(name, leaves):
    first = leaves[0]
    if isinstance(first, _OPERATORS):
        return stack_ops(leaves)
    if isinstance(first, torch.Tensor) or name == "sigma":
        return torch.stack([torch.as_tensor(x) for x in leaves])
    for x in leaves[1:]:
        if x != first:
            raise ValueError(f"stack_ops needs equal static field {name!r}; "
                             f"got {first!r} vs {x!r}")
    return first


def stack_ops(ops):
    """Stack K same-structure operators into ONE lane-batched operator:
    every tensor field gains a leading lane axis (``Dense.a`` becomes
    (K, N, N), ``SparseBELL.data`` (K, R, Kb, bs, bs), ...); static fields
    (n, mode, ...) must agree. For K masks of one shared base prefer
    :func:`stack_masks`, which does not copy the base."""
    ops = list(ops)
    if not ops:
        raise ValueError("stack_ops needs at least one operator")
    cls = type(ops[0])
    for o in ops[1:]:
        if type(o) is not cls:
            raise ValueError(f"stack_ops needs same-structure operators; got "
                             f"{cls.__name__} vs {type(o).__name__}")
    fields = {f.name: _stack_leaf(f.name, [getattr(o, f.name) for o in ops])
              for f in dataclasses.fields(cls) if f.init}
    return cls(**fields)


def stack_masks(base, masks) -> Masked:
    """K candidate principal-submatrix masks of ONE base matrix as a
    single lane-batched ``Masked`` operator (the base is shared, only the
    (K, N) mask is per lane)."""
    if not isinstance(masks, torch.Tensor):
        masks = torch.stack([torch.as_tensor(m) for m in masks])
    if masks.ndim < 2:
        raise ValueError(f"stack_masks wants (K, N) masks, got shape "
                         f"{tuple(masks.shape)}")
    return Masked(base, masks)


# ---------------------------------------------------------------------------
# Lane sharding (DESIGN.md Sec. 7)

# Rank of each tensor field on an UNBATCHED operator. A leaf with one more
# dim carries a leading lane axis (a stack_ops / stack_masks stack) and is
# split over the lane mesh; a base-rank leaf is the shared problem data
# and every rank keeps it whole. Dispatched on the type, not on shapes,
# which would misfire when K == N (greedy MAP runs N lanes against an
# (N, N) base matrix).
_LANE_BASE_RANK = {
    Dense: {"a": 2},
    SparseCOO: {"rows": 1, "cols": 1, "vals": 1, "diag_vals": 1},
    SparseBELL: {"data": 4, "cols": 2, "diag_vals": 1},
    Masked: {"mask": 1},
    Shifted: {"sigma": 0},
    Jacobi: {"inv_sqrt_diag": 1},
    MatvecFn: {"diag_vals": 1},
}

_LANE_WRAPPERS = (Masked, Shifted, Jacobi)


def _lane_spec_for(leaf, base_rank: int) -> str:
    ndim = leaf.ndim if isinstance(leaf, torch.Tensor) else np.ndim(leaf)
    extra = ndim - base_rank
    if extra == 0:
        return "shared"
    if extra == 1:
        return "stacked"
    raise ValueError(
        f"operator leaf has {extra} leading lane dims (shape "
        f"{tuple(np.shape(leaf))}, base rank {base_rank}); the sharded "
        f"driver supports exactly one lane axis")


def lane_specs(op) -> dict:
    """Each tensor field of ``op`` as 'stacked' (one leading lane dim
    over the operator's unbatched rank: split over the lane mesh) or
    'shared' (kept whole on every rank), a wrapper's ``base`` as its own
    dict of the same kind."""
    cls = type(op)
    if cls not in _LANE_BASE_RANK:
        raise TypeError(f"lane_specs does not know operator type "
                        f"{cls.__name__}")
    specs = {name: _lane_spec_for(getattr(op, name), rank)
             for name, rank in _LANE_BASE_RANK[cls].items()}
    if cls in _LANE_WRAPPERS:
        specs["base"] = lane_specs(op.base)
    return specs


def map_stacked(op, fn, specs: dict | None = None):
    """``op`` with ``fn`` applied to every stacked leaf (shared leaves
    and static fields as they are)."""
    specs = lane_specs(op) if specs is None else specs
    fields = {name: fn(getattr(op, name))
              for name, spec in specs.items()
              if name != "base" and spec == "stacked"}
    if "base" in specs:
        fields["base"] = map_stacked(op.base, fn, specs["base"])
    return dataclasses.replace(op, **fields) if fields else op


def shard_ops(op, mesh, axis: str = "lanes"):
    """This rank's operator on a lane mesh: every stacked leaf cut to the
    rank's contiguous block of lanes, shared leaves whole. The lane count
    must divide by the ranks (the sharded driver pads it first)."""
    from ..launch.mesh import lane_rank

    ndev, rank = lane_rank(mesh, axis)

    def local(leaf):
        k = leaf.shape[0]
        if k % ndev:
            raise ValueError(f"{k} lanes do not split over {ndev} ranks; "
                             f"pad the lane axis to a multiple first")
        kd = k // ndev
        return leaf[rank * kd:(rank + 1) * kd]

    return map_stacked(op, local)


def configure_backend(op, backend: str, interpret: bool | None):
    """Rebind the execution mode of every ``SparseBELL`` inside ``op``
    (walking Masked/Shifted/Jacobi wrappers) to the solver's backend."""
    if isinstance(op, SparseBELL):
        return op.configured(backend, interpret)
    if isinstance(op, (Masked, Shifted, Jacobi)):
        new_base = configure_backend(op.base, backend, interpret)
        if new_base is op.base:
            return op
        return dataclasses.replace(op, base=new_base)
    return op


def fused_operands(op):
    """Flatten ``op`` into the diagonal-sandwich form of the fused step
    (``kernels/lanczos_step.py``):

        matvec(x) = s_out * base.matvec(s_in * x) + t * x

    with ``base`` a :class:`Dense` or :class:`SparseBELL`:

        Dense / BELL:  (base, 1, 1, 0)
        Shifted(F, s): t' = t + s
        Jacobi(F, c):  s_out' = c*s_out, s_in' = s_in*c, t' = c*t*c
        Masked(F, m):  s_out' = m*s_out, s_in' = s_in*m,
                       t' = m*t*m + (1 - m)

    Returns ``(base, s_out, s_in, t)``, or ``None`` when ``op`` bottoms
    out in an operator the fused step cannot stream (SparseCOO,
    MatvecFn): callers take the reference composition.
    """
    if isinstance(op, (Dense, SparseBELL)):
        dt, dev = _dtype_of(op), op_device(op)
        one = torch.ones((), dtype=dt, device=dev)
        return op, one, one, torch.zeros((), dtype=dt, device=dev)
    if isinstance(op, Shifted):
        inner = fused_operands(op.base)
        if inner is None:
            return None
        base, s_out, s_in, t = inner
        return base, s_out, s_in, t + op._sigma_col()
    if isinstance(op, Jacobi):
        inner = fused_operands(op.base)
        if inner is None:
            return None
        base, s_out, s_in, t = inner
        c = op.inv_sqrt_diag
        return base, c * s_out, s_in * c, c * t * c
    if isinstance(op, Masked):
        inner = fused_operands(op.base)
        if inner is None:
            return None
        base, s_out, s_in, t = inner
        m = op.mask.to(_dtype_of(base))
        return base, m * s_out, s_in * m, m * t * m + (1.0 - m)
    return None


def _dtype_of(op):
    if isinstance(op, Dense):
        return op.a.dtype
    if isinstance(op, SparseBELL):
        return op.data.dtype
    return op.diag().dtype
