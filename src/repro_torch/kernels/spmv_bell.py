"""K2: blocked-ELL sparse matvec (counterpart of
``repro.kernels.spmv_bell``).

Layout, as in the reference:

    data: (R, K, bs, bs)   R = N/bs block-rows, K = max blocks per row
    cols: (R, K) int32     block-column index of each stored block
                           (padding blocks point at column 0, zero data)

Leading lane dims on ``data``/``cols`` carry one table per lane.

``bell_matvec_ref`` is the reference backend's matvec (computes in x's
dtype); ``bell_matvec_plain`` is the plain PyTorch version of the K2
kernel, with the kernel's contract: f32 accumulation, f32 output
(``repro/kernels/spmv_bell.py:38-40, :66``). ``bell_matvec_cuda``
launches ``csrc/bell.cu``; ``kernels.ops.bell_matvec`` picks by device.
On the card the matvec of K2 and of K4 takes one of two routes, by the
table's shape (``route``): ``"tiled"`` for a table shared by the lanes (a
CTA per 64 lanes x 64 rows of a block row for f32 vectors, 128 rows for
f64, so each block is read once per 64 lanes), ``"lane"`` for a table per
lane (a CTA per block row and lane). ``ROUTES`` counts K2's launches by
route.

K5, the multi-right-hand-side SpMM of block-Krylov mode, has the same
contract over row-stacked blocks x (L, b, N): ``bell_matvec_mrhs_plain``
beside ``bell_matvec_mrhs_cuda`` (``csrc/bell_mrhs.cu``), picked by
``kernels.ops.bell_matvec_mrhs``. On the card K5 takes one of two routes
(``mrhs_route``): ``"wgmma"`` (3xTF32 on the tensor cores) for a shared
f32 table with ``bs`` a multiple of 128, ``"fma"`` otherwise;
``MRHS_ROUTES`` counts its launches by route.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build


def bell_matvec_ref(data: torch.Tensor, cols: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Blocked-ELL SpMV in plain PyTorch, batched over leading dims.

    ``data``/``cols`` may carry leading lane dims matching ``x``'s (a
    stacked operator), or none (one table shared by all lanes of ``x``).
    Computes in ``x.dtype``.
    """
    r, k, bs, _ = data.shape[-4:]
    xb = x.reshape(x.shape[:-1] + (r, bs))
    idx = cols.long()
    if cols.ndim == 2:
        gathered = xb[..., idx, :]                       # (..., R, K, bs)
        y = torch.einsum("rkij,...rkj->...ri", data.to(x.dtype), gathered)
    else:
        flat_idx = idx.reshape(idx.shape[:-2] + (r * k, 1))
        flat_idx = flat_idx.expand(xb.shape[:-2] + (r * k, 1))
        gathered = torch.take_along_dim(xb, flat_idx, dim=-2)
        gathered = gathered.reshape(gathered.shape[:-2] + (r, k, bs))
        y = torch.einsum("...rkij,...rkj->...ri", data.to(x.dtype),
                         gathered)
    return y.reshape(x.shape[:-1] + (r * bs,))


def bell_matvec_plain(data: torch.Tensor, cols: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: y = A @ x with f32 accumulation and
    an f32 result, x (..., R*bs)."""
    return bell_matvec_ref(data.to(torch.float32), cols,
                           x.to(torch.float32))


# Launches of K2 by route (csrc/bell.cu; K4's are in lanczos_step.ROUTES).
ROUTES = {"tiled": 0, "lane": 0}


def route(data: torch.Tensor, cols: torch.Tensor) -> str:
    """The route of a blocked-ELL matvec on the card (K2, and K4's matvec
    launch): ``"tiled"`` when every lane reads one table (``data``
    (R, K, bs, bs), ``cols`` (R, K)), so a CTA reuses each block across
    64 lanes; ``"lane"`` for a table per lane, which has nothing to reuse.
    Reads shapes only."""
    return "tiled" if data.ndim == 4 and cols.ndim == 2 else "lane"


def vec16(bs: int, *tensors) -> bool:
    """Whether the tiled route may stage with 16-byte copies: each tensor
    starts on a 16-byte boundary and a block row of ``bs`` of its elements
    is a whole number of 16 bytes (so every row and chunk start is)."""
    return all(t.data_ptr() % 16 == 0 and bs * t.element_size() % 16 == 0
               for t in tensors)


def _lane_stride(t: torch.Tensor, base_ndim: int, lanes: int) -> int:
    """Element stride between lanes of a table with optional leading lane
    dim (0 for a shared table)."""
    if t.ndim == base_ndim:
        return 0
    if t.ndim != base_ndim + 1 or t.shape[0] != lanes:
        raise ValueError(f"table of shape {tuple(t.shape)} does not match "
                         f"{lanes} lanes")
    return int(t[0].numel())


def bell_matvec_cuda(data: torch.Tensor, cols: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Launch K2 on CUDA tensors: x (N,) or (L, N) with N = R * bs;
    ``data`` (R, K, bs, bs) shared or (L, R, K, bs, bs) per lane; f32
    result of x's shape."""
    if x.device.type != "cuda":
        raise ValueError(f"bell_matvec_cuda needs CUDA tensors, got "
                         f"{x.device}")
    r, k, bs, _ = data.shape[-4:]
    if x.ndim > 2 or x.shape[-1] != r * bs:
        raise ValueError(f"bell_matvec_cuda wants x (N,) or (L, N) with "
                         f"N={r * bs}, got {tuple(x.shape)}")
    single = x.ndim == 1
    xf = x.to(torch.float32).reshape(-1, r * bs).contiguous()
    lanes = xf.shape[0]
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bell_matvec_cuda takes f32/f64 data, got "
                        f"{data.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    for name, t in (("data", data), ("cols", cols)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if xf.numel() == 0 or data.numel() == 0:
        raise ValueError(f"bell_matvec_cuda launches on nonempty inputs "
                         f"only, got x {tuple(x.shape)}, data "
                         f"{tuple(data.shape)}")
    which = route(data, cols)
    dims = (ctypes.c_longlong * 8)(
        lanes, r, k, bs, _lane_stride(data, 4, lanes),
        _lane_stride(cols, 2, lanes), int(which == "tiled"),
        int(vec16(bs, data, xf)))
    y = torch.empty_like(xf)
    lib = _build.load("bell")
    fn = lib.bell_matvec_f64 if data.dtype == torch.float64 \
        else lib.bell_matvec_f32
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr_array([data, cols, xf]), _build.ptr_array([y]),
                dims, _build.stream_of(x))
    _build.check(rc, "bell_matvec")
    ROUTES[which] += 1
    return y[0] if single else y


def bell_matvec_mrhs_plain(data: torch.Tensor, cols: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: Y = A @ X for row-stacked right-hand
    sides x (L, b, R*bs), with f32 accumulation and an f32 result.
    ``data``/``cols`` are one shared table, or one per lane (leading L)."""
    d32, x32 = data.to(torch.float32), x.to(torch.float32)
    if cols.ndim == 2:
        return bell_matvec_ref(d32, cols, x32)
    return bell_matvec_ref(d32[:, None], cols[:, None], x32)


# Launches of K5 by route (csrc/bell_mrhs.cu).
MRHS_ROUTES = {"wgmma": 0, "fma": 0}
MRHS_TILE = (128, 128)  # the wgmma route's CTA: output rows x right-hand sides


def mrhs_route(data: torch.Tensor, cols: torch.Tensor) -> str:
    """The route of K5 on the card: ``"wgmma"`` (3xTF32 on the tensor
    cores) for one f32 table shared by every right-hand side with ``bs`` a
    multiple of 128, the tile's output rows; ``"fma"`` (CUDA-core f32 FMA)
    for a table per lane, f64 data or another ``bs``. Reads shapes and
    types only."""
    bs = data.shape[-1]
    shared = data.ndim == 4 and cols.ndim == 2
    return ("wgmma" if shared and data.dtype == torch.float32
            and bs % MRHS_TILE[0] == 0 else "fma")


def mrhs_grid(route: str, groups: int, rows: int, nr: int, bs: int) -> tuple:
    """The launch grid of K5 (x, y, z) on each route: the wgmma route
    takes 128 output rows of a block row for 128 right-hand sides a CTA,
    right-hand-side tiles along x (the CTAs that share a block row's table
    run side by side); the fma route 128 output rows for 64, block rows
    along x, one grid slice per table."""
    out_tiles = nr * -(-bs // MRHS_TILE[0])
    if route == "wgmma":
        return (-(-rows // MRHS_TILE[1]), out_tiles, groups)
    return (out_tiles, -(-rows // 64), groups)


def bell_matvec_mrhs_cuda(data: torch.Tensor, cols: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Launch K5 on CUDA tensors: x (L, b, N) with N = R * bs, read in its
    own type if f32 or f64 (another float type is rounded to f32 first);
    ``data`` (R, K, bs, bs) shared by all L*b rows or (L, R, K, bs, bs) per
    lane; f32 result of x's shape. The route is ``mrhs_route``'s."""
    if x.device.type != "cuda":
        raise ValueError(f"bell_matvec_mrhs_cuda needs CUDA tensors, got "
                         f"{x.device}")
    r, k, bs, _ = data.shape[-4:]
    if x.ndim != 3 or x.shape[-1] != r * bs:
        raise ValueError(f"bell_matvec_mrhs_cuda wants x (L, b, N) with "
                         f"N={r * bs}, got {tuple(x.shape)}")
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bell_matvec_mrhs_cuda takes f32/f64 data, got "
                        f"{data.dtype}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    for name, t in (("data", data), ("cols", cols)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if x.numel() == 0:
        raise ValueError(f"bell_matvec_mrhs_cuda launches on nonempty "
                         f"inputs only, got x {tuple(x.shape)}")
    which = mrhs_route(data, cols)
    if which == "wgmma" and data.data_ptr() % 16:
        raise ValueError("bell_matvec_mrhs_cuda: the wgmma route reads the "
                         "table by TMA and needs it 16-byte aligned")
    lanes, b, n = x.shape
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    x = x.contiguous()
    if data.ndim == 4:      # one table: every row of every lane in one GEMM
        groups, rows = 1, lanes * b
    else:
        groups, rows = lanes, b
    dims = (ctypes.c_longlong * 7)(
        groups, rows, r, k, bs, _lane_stride(data, 4, groups),
        _lane_stride(cols, 2, groups))
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _build.load("bell_mrhs")
    dt = {torch.float32: "f32", torch.float64: "f64"}
    fn = getattr(lib, f"bell_matvec_mrhs_wgmma_{dt[x.dtype]}" if which ==
                 "wgmma" else
                 f"bell_matvec_mrhs_{dt[data.dtype]}_{dt[x.dtype]}")
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr_array([data, cols, x]), _build.ptr_array([y]),
                dims, _build.stream_of(x))
    _build.check(rc, "bell_matvec_mrhs")
    MRHS_ROUTES[which] += 1
    return y


def dense_to_bell(a, bs: int = 128, k_max: int | None = None,
                  dtype=np.float32):
    """Convert a dense (numpy) symmetric matrix to blocked-ELL numpy
    arrays: (data (R,K,bs,bs), cols (R,K) int32, n). Zero-pads N up to a
    multiple of ``bs``; rows with fewer than K non-zero blocks are padded
    with zero blocks pointing at column 0."""
    a = np.asarray(a, dtype)
    n = a.shape[0]
    npad = -n % bs
    if npad:
        a = np.pad(a, ((0, npad), (0, npad)))
    nn = a.shape[0]
    r = nn // bs
    blocks = a.reshape(r, bs, r, bs).transpose(0, 2, 1, 3)  # (R, R, bs, bs)
    nz = np.abs(blocks).max(axis=(2, 3)) > 0                # (R, R)
    per_row = nz.sum(axis=1)
    k = int(per_row.max()) if k_max is None else k_max
    k = max(k, 1)
    data = np.zeros((r, k, bs, bs), a.dtype)
    cols = np.zeros((r, k), np.int32)
    for i in range(r):
        js = np.nonzero(nz[i])[0][:k]
        data[i, :len(js)] = blocks[i, js]
        cols[i, :len(js)] = js
    return data, cols, n
