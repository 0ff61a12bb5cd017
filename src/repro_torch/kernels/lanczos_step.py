"""K3/K4: one whole solver iteration per call, the fused Lanczos + GQL
step (counterpart of ``repro.kernels.lanczos_step``).

Wrapped operators reach the kernels through the diagonal-sandwich form
(``core.operators.fused_operands``):

    matvec(x) = s_out * (A @ (s_in * x)) + t * x

with A a :class:`Dense` (K3, ``csrc/dense_step.cu``) or a
:class:`SparseBELL` (K4, ``csrc/bell.cu``). A step emits *raw* outputs
(alpha, beta = ||r||, residual r, and the eight recurrence values);
breakdown detection, freezing and bracket collapse run outside, through
the same ``lanczos_assemble`` / ``gql_assemble`` as the reference path.

Beside each CUDA launcher sits its plain PyTorch version
(``fused_step_dense_plain``, ``fused_step_bell_plain``), the CPU path and
the kernels' oracle; ``kernels.ops`` picks by device.

K3 takes an optional device-side count of live basis rows (``rows``, an
int32 tensor on the card): the kernel's tail then reads basis rows
``[0, rows)`` only. The plain version always reads all M rows; the rows
past the count are zeros, so it is the oracle of the claim that skipping
them changes nothing.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .gql_update import recurrence_math
from .spmv_bell import bell_matvec_ref

SCALAR_ORDER = ("beta", "g", "c", "delta", "d_lr", "d_rr", "lam_min",
                "lam_max")


def _tail(acc, s_out, t, v, v_prev, basis, scalars):
    """Finish the sandwich, take the Lanczos update + optional reorth,
    and run the recurrence. Returns (alpha, beta_new, r, raw8)."""
    beta_p, g, c, delta, d_lr, d_rr, lam_min, lam_max = scalars
    w = s_out * acc + t * v
    alpha = torch.sum(v * w, dim=-1)
    r = w - alpha[..., None] * v - beta_p[..., None] * v_prev
    if basis is not None:
        # one classical Gram-Schmidt pass against the banked vectors
        coeff = torch.einsum("kmn,kn->km", basis, r)
        r = r - torch.einsum("km,kmn->kn", coeff, basis)
    beta_new = torch.sqrt(torch.sum(r * r, dim=-1))
    raw = recurrence_math(alpha, beta_new, beta_p, g, c, delta, d_lr, d_rr,
                          lam_min, lam_max)
    return alpha, beta_new, r, raw


def fused_step_dense_plain(a, s_out, s_in, t, v, v_prev, scalars,
                           basis=None, *, shared_a: bool, rows=None):
    """Plain PyTorch version of K3 over (K, N) lanes: ``a`` is (N, N)
    when ``shared_a`` else (K, N, N); ``scalars`` the 8 (K,) operands in
    ``SCALAR_ORDER``; ``basis`` optional (K, M, N). ``rows`` is accepted
    for the kernel's signature and not read: all M basis rows count."""
    x = s_in * v
    eq = "ij,kj->ki" if shared_a else "kij,kj->ki"
    acc = torch.einsum(eq, a, x)
    return _tail(acc, s_out, t, v, v_prev, basis, tuple(scalars))


def fused_step_bell_plain(data, cols, s_out, s_in, t, v, v_prev, scalars):
    """Plain PyTorch version of K4 over (L, R*bs) lanes: ``data``
    (R, K, bs, bs) shared or (L, R, K, bs, bs), cast to the vector dtype
    (as ``lanczos_step.py:221``); no reorth."""
    acc = bell_matvec_ref(data, cols, s_in * v)
    return _tail(acc, s_out, t, v, v_prev, None, tuple(scalars))


# ---------------------------------------------------------------------------
# CUDA launchers


def _strided(x, lanes: int, n: int, like: torch.Tensor):
    """``x`` broadcast to (lanes, n) without a copy, and its two element
    strides (a stride of 0 marks a shared axis)."""
    x = torch.broadcast_to(torch.as_tensor(x, dtype=like.dtype,
                                           device=like.device), (lanes, n))
    return x, x.stride(0), x.stride(1)


def _check_vec(name, x, like):
    if x.dtype != like.dtype or x.device != like.device \
            or x.shape != like.shape or not x.is_contiguous():
        raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} on {x.device}"
                         f" (contiguous={x.is_contiguous()}), want "
                         f"{like.dtype} {tuple(like.shape)} contiguous on "
                         f"{like.device}")


def _scalars(scalars, lanes, like):
    out = []
    for name, s in zip(SCALAR_ORDER, scalars):
        s = torch.broadcast_to(torch.as_tensor(
            s, dtype=like.dtype, device=like.device), (lanes,)).contiguous()
        out.append(s)
    return out


def _outputs(v, splits: int = 1):
    lanes = v.shape[0]
    alpha = torch.empty(lanes, dtype=v.dtype, device=v.device)
    beta = torch.empty_like(alpha)
    r = torch.empty_like(v)
    raw = [torch.empty_like(alpha) for _ in range(8)]
    acc = torch.empty((splits,) + tuple(v.shape), dtype=v.dtype,
                      device=v.device)
    return alpha, beta, r, raw, acc


# Launches of K3 by route (csrc/dense_step.cu): "dmma" the shared f64 A
# on the FP64 tensor cores, "fma_f32" the shared f32 A on the CUDA cores,
# "lane" a per-lane A; "live_rows" counts the launches whose tail read
# only the live basis rows (``rows`` given). K4's by route (csrc/bell.cu,
# ``bell_route``): "bell_dmma" a shared table with f64 vectors on the FP64
# tensor cores, "bell_fma_f32" a shared table with f32 vectors on the CUDA
# cores, "bell_lane" a per-lane table, "bell_rows" a shared table with f64
# vectors and a sparse fill, walked by its row list.
ROUTES = {"dmma": 0, "fma_f32": 0, "lane": 0, "live_rows": 0,
          "bell_dmma": 0, "bell_fma_f32": 0, "bell_lane": 0, "bell_rows": 0}

# The shared-A matvecs of K3 tile 64 lanes by 128 rows of A (f64, tensor
# cores; 1 CTA resident per SM) or by 32 rows (f32, CUDA cores; about 4
# resident), and walk the columns 32 at a time; the column range is split
# so that those CTAs fill every SM. The kernel takes any split count:
# these sizes only steer the choice.
_TILE_LANES, _TILE_COLS = 64, 32


def _dense_splits(lanes: int, n: int, device, tile_rows: int,
                  resident: int) -> int:
    tiles = -(-lanes // _TILE_LANES) * -(-n // tile_rows)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stages = -(-n // _TILE_COLS)
    return max(1, min(8, (resident * sms) // tiles, stages // 4))


# K4's f64 tile: 64 lanes x 128 rows of a block row per CTA (1 resident
# per SM), walking the table's depth in chunks of 32 columns.
_BELL_LANES, _BELL_ROWS, _BELL_DEPTH = 64, 128, 32


def bell_splits(lanes: int, nr: int, bs: int, kb: int, sms: int) -> int:
    """Slices of K4's chunk walk on the f64 tile, each written to its own
    scratch slice and added by the tail in a fixed order: enough for the
    tiles to fill ``sms`` SMs, with at least 4 chunks a slice, at most 8
    slices. The kernel takes any count; this only steers the choice."""
    tiles = -(-lanes // _BELL_LANES) * nr * -(-bs // _BELL_ROWS)
    chunks = kb * -(-bs // _BELL_DEPTH)
    return max(1, min(8, sms // tiles, chunks // 4))


def bell_route(data, cols, vec_dtype, smem_optin: int) -> tuple:
    """K4's route on the card and the row list it walks, if any:
    ``("bell_lane", None)`` for a table per lane, ``("bell_fma_f32",
    None)`` for a shared table with f32 vectors, ``("bell_rows", rows)``
    for a shared table with f64 vectors whose stored values per non-zero
    pass ``spmv_bell.ROWS_FILL`` and whose rows of two lanes fit in
    ``smem_optin``, the shared memory a CTA may opt into (the rows route
    stages a pair of lanes a CTA, ``csrc/bell.cu``), ``("bell_dmma",
    None)`` otherwise. The route is the key of ``ROUTES`` its launch
    counts under. Reads the table's fill from ``spmv_bell.table_rows``
    (built at a table's first call, then cached)."""
    from .spmv_bell import route, table_rows
    if route(data, cols) != "tiled":
        return "bell_lane", None
    if vec_dtype != torch.float64:
        return "bell_fma_f32", None
    n = data.shape[-4] * data.shape[-2]
    if 2 * n * 8 > smem_optin:
        return "bell_dmma", None
    rows = table_rows(data, cols).rows
    return ("bell_dmma", None) if rows is None else ("bell_rows", rows)


def _bind(fn):
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_step_dense_cuda(a, s_out, s_in, t, v, v_prev, scalars,
                          basis=None, *, shared_a: bool, rows=None):
    """Launch K3 (matvec launch + tail launch) on CUDA tensors. ``rows``
    (an int32 tensor of one element on v's device) bounds the tail's basis
    passes to rows ``[0, rows)``."""
    if v.device.type != "cuda":
        raise ValueError(f"fused_step_dense_cuda needs CUDA tensors, got "
                         f"{v.device}")
    if v.ndim != 2 or v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"v must be (K, N) float32/float64, got "
                        f"{v.dtype} {tuple(v.shape)}")
    lanes, n = v.shape
    if v.numel() == 0:
        raise ValueError(f"fused_step_dense_cuda launches on nonempty inputs "
                         f"only, got v {tuple(v.shape)}")
    _check_vec("v", v, v)
    _check_vec("v_prev", v_prev, v)
    want = (n, n) if shared_a else (lanes, n, n)
    if a.dtype != v.dtype or a.device != v.device \
            or tuple(a.shape) != want or not a.is_contiguous():
        raise ValueError(f"a: {a.dtype} {tuple(a.shape)} on {a.device}, "
                         f"want {v.dtype} {want} contiguous on {v.device}")
    m = 0
    if basis is not None:
        if basis.dtype != v.dtype or basis.device != v.device \
                or basis.ndim != 3 or basis.shape[0] != lanes \
                or basis.shape[2] != n or not basis.is_contiguous():
            raise ValueError(f"basis: {basis.dtype} {tuple(basis.shape)}, "
                             f"want contiguous ({lanes}, M, {n}) {v.dtype}")
        m = basis.shape[1]
    if rows is not None and (
            not isinstance(rows, torch.Tensor) or rows.dtype != torch.int32
            or rows.device != v.device or rows.numel() != 1):
        raise ValueError(f"rows must be an int32 tensor of one element on "
                         f"{v.device}, got {rows!r}")
    dmma = shared_a and v.dtype == torch.float64
    so, so_ls, so_es = _strided(s_out, lanes, n, v)
    si, si_ls, si_es = _strided(s_in, lanes, n, v)
    if dmma and (si_ls, si_es) != (0, 0):
        # the tensor-core tile stages s_in beside v: one (K, N) row a lane
        si = si.contiguous()
        si_ls, si_es = n, 1
    tt, t_ls, t_es = _strided(t, lanes, n, v)
    sc = _scalars(scalars, lanes, v)
    splits = _dense_splits(lanes, n, v.device, 128, 1) if dmma else \
        _dense_splits(lanes, n, v.device, 32, 4) if shared_a else 1
    alpha, beta, r, raw, acc = _outputs(v, splits)
    ins = [a, so, si, tt, v, v_prev, *sc]
    ptrs = _build.ptr_array(ins)
    ins_arr = (ctypes.c_void_p * 16)(
        *ptrs, basis.data_ptr() if basis is not None else None,
        rows.data_ptr() if rows is not None else None)
    dims = (ctypes.c_longlong * 11)(lanes, n, m, int(shared_a), so_ls,
                                    so_es, si_ls, si_es, t_ls, t_es, splits)
    lib = _build.load("dense_step")
    fn = _bind(lib.fused_step_dense_f64 if v.dtype == torch.float64
               else lib.fused_step_dense_f32)
    with torch.cuda.device(v.device):
        rc = fn(ins_arr, _build.ptr_array([alpha, beta, r, *raw, acc]),
                dims, _build.stream_of(v))
    _build.check(rc, "fused_step_dense")
    ROUTES["dmma" if dmma else "fma_f32" if shared_a else "lane"] += 1
    if rows is not None and basis is not None:
        ROUTES["live_rows"] += 1
    return alpha, beta, r, tuple(raw)


_BELL_TYPES = {(torch.float32, torch.float64): "f32_f64",
               (torch.float64, torch.float64): "f64_f64",
               (torch.float32, torch.float32): "f32_f32"}


def fused_step_bell_cuda(data, cols, s_out, s_in, t, v, v_prev, scalars):
    """Launch K4 (BELL matvec launch + tail launch) on CUDA tensors:
    v (L, R*bs), ``data`` (R, K, bs, bs) shared or (L, R, K, bs, bs)."""
    from .spmv_bell import _lane_stride, vec16
    if v.device.type != "cuda":
        raise ValueError(f"fused_step_bell_cuda needs CUDA tensors, got "
                         f"{v.device}")
    nr, kb, bs, _ = data.shape[-4:]
    if v.ndim != 2 or v.shape[1] != nr * bs:
        raise ValueError(f"v must be (L, {nr * bs}), got {tuple(v.shape)}")
    key = (data.dtype, v.dtype)
    if key not in _BELL_TYPES:
        raise TypeError(f"fused_step_bell_cuda takes (data, vector) dtypes "
                        f"{list(_BELL_TYPES)}, got {key}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    lanes, n = v.shape
    _check_vec("v", v, v)
    _check_vec("v_prev", v_prev, v)
    for name, x in (("data", data), ("cols", cols)):
        if x.device != v.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {v.device}")
    if v.numel() == 0 or data.numel() == 0:
        raise ValueError(f"fused_step_bell_cuda launches on nonempty inputs "
                         f"only, got v {tuple(v.shape)}, data "
                         f"{tuple(data.shape)}")
    props = torch.cuda.get_device_properties(v.device)
    which, rows = bell_route(data, cols, v.dtype,
                             props.shared_memory_per_block_optin)
    tiled = which != "bell_lane"
    so, so_ls, so_es = _strided(s_out, lanes, n, v)
    si, si_ls, si_es = _strided(s_in, lanes, n, v)
    scalar_in = (si_ls, si_es) == (0, 0)
    if tiled and not scalar_in and (si_es != 1 or si_ls not in (0, n)):
        # the tile stages s_in rows: one shared row or a row a lane
        si = si.contiguous()
        si_ls, si_es = n, 1
    tt, t_ls, t_es = _strided(t, lanes, n, v)
    sc = _scalars(scalars, lanes, v)
    splits = bell_splits(lanes, nr, bs, kb, props.multi_processor_count) \
        if which == "bell_dmma" else 1
    alpha, beta, r, raw, acc = _outputs(v, splits)
    staged = (data, v) if scalar_in else (data, v, si)
    dims = (ctypes.c_longlong * 17)(
        lanes, nr, kb, bs, _lane_stride(data, 4, lanes),
        _lane_stride(cols, 2, lanes), so_ls, so_es, si_ls, si_es, t_ls, t_es,
        int(tiled), splits, int(vec16(bs, *staged)),
        int(rows is not None), int(vec16(n, *staged[1:])))
    lib = _build.load("bell")
    fn = _bind(getattr(lib, "fused_step_bell_" + _BELL_TYPES[key]))
    with torch.cuda.device(v.device):
        rc = fn(_build.ptr_array([data, cols, so, si, tt, v, v_prev, *sc,
                                  *(rows or ())]),
                _build.ptr_array([alpha, beta, r, *raw, acc]), dims,
                _build.stream_of(v))
    _build.check(rc, "fused_step_bell")
    ROUTES[which] += 1
    return alpha, beta, r, tuple(raw)


# ---------------------------------------------------------------------------
# Dispatcher


def _flatten_lanes(x, batch, trailing):
    """Broadcast ``x`` against ``batch + trailing`` and flatten ``batch``."""
    x = torch.broadcast_to(x, batch + trailing)
    return x.reshape((-1,) + trailing)


def gql_step_fused(op, st, lam_min, lam_max, basis=None, rows=None):
    """Drop-in for ``core.gql.gql_step`` that runs the whole iteration as
    one fused step when ``op`` has the sandwich form. SparseCOO, MatvecFn
    and a SparseBELL with a banked basis take the reference composition:
    that routing by operator type is the reference's own semantics
    (``repro/kernels/lanczos_step.py:299-304``). ``rows``, the count of
    live basis rows as an int32 tensor, reaches K3 with the basis; every
    other route reads the whole basis."""
    from ..core import gql as _gql
    from ..core import lanczos as _lanczos
    from ..core import operators as _operators
    from . import ops

    form = _operators.fused_operands(op)
    if form is not None and isinstance(form[0], _operators.SparseBELL) \
            and basis is not None:
        form = None  # reorth is not fused on the BELL flavor
    if form is None:
        return _gql.gql_step(op, st, lam_min, lam_max, basis=basis)
    base, s_out, s_in, t = form

    v0 = st.lz.v
    dtype, dev = v0.dtype, v0.device
    batch = tuple(v0.shape[:-1])
    n = v0.shape[-1]

    def as_t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    lam_min, lam_max = as_t(lam_min), as_t(lam_max)
    # v and v_prev go to the kernels as contiguous (K, N) rows (torch
    # keeps its inputs' layout, so a query built from a transposed view
    # yields column-major vectors); s_out, s_in and t stay broadcast views
    vecs = tuple(_flatten_lanes(as_t(x), batch, (n,))
                 for x in (s_out, s_in, t))
    vecs += tuple(_flatten_lanes(x, batch, (n,)).contiguous()
                  for x in (st.lz.v, st.lz.v_prev))
    scalars = tuple(_flatten_lanes(as_t(x), batch, ())
                    for x in (st.lz.beta, st.g, st.c, st.delta,
                              st.delta_lr, st.delta_rr, lam_min, lam_max))

    if isinstance(base, _operators.Dense):
        shared_a = base.a.ndim == 2
        a = (base.a if shared_a else _flatten_lanes(base.a, batch, (n, n))
             ).contiguous()
        bas = (None if basis is None else _flatten_lanes(
            basis, batch, tuple(basis.shape[-2:])).contiguous())
        alpha, beta_new, r, raw = ops.fused_step_dense(
            a, *vecs, scalars, bas, shared_a=shared_a,
            rows=None if bas is None else rows)
    else:
        nr, _, bs, _ = base.data.shape[-4:]
        pad = nr * bs - n
        vecs_p = tuple(torch.nn.functional.pad(x, (0, pad)) if pad else x
                       for x in vecs)
        if base.data.ndim == 4:
            dat, col = base.data, base.cols
        else:
            dat = _flatten_lanes(base.data, batch,
                                 tuple(base.data.shape[-4:]))
            col = _flatten_lanes(base.cols, batch,
                                 tuple(base.cols.shape[-2:]))
        alpha, beta_new, r, raw = ops.fused_step_bell(dat, col, *vecs_p,
                                                      scalars)
        r = r[:, :n]

    def unflatten(x, trailing=()):
        return x.reshape(batch + trailing)

    lz = _lanczos.lanczos_assemble(
        st.lz, unflatten(alpha), unflatten(beta_new), unflatten(r, (n,)))
    raw = tuple(unflatten(x) for x in raw)
    return _gql.gql_assemble(st, lz, raw)
