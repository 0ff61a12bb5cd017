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

K5, the multi-right-hand-side SpMM of block-Krylov mode, has the same
contract over row-stacked blocks x (L, b, N): ``bell_matvec_mrhs_plain``
beside ``bell_matvec_mrhs_cuda`` (``csrc/bell_mrhs.cu``), picked by
``kernels.ops.bell_matvec_mrhs``.
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
    dims = (ctypes.c_longlong * 6)(
        lanes, r, k, bs, _lane_stride(data, 4, lanes),
        _lane_stride(cols, 2, lanes))
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


def bell_matvec_mrhs_cuda(data: torch.Tensor, cols: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """Launch K5 on CUDA tensors: x (L, b, N) with N = R * bs, any float
    dtype (rounded to f32 once); ``data`` (R, K, bs, bs) shared by all
    L*b rows or (L, R, K, bs, bs) per lane; f32 result of x's shape."""
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
    lanes, b, n = x.shape
    xf = x.to(torch.float32).contiguous()
    if data.ndim == 4:      # one table: every row of every lane in one GEMM
        groups, rows = 1, lanes * b
    else:
        groups, rows = lanes, b
    dims = (ctypes.c_longlong * 7)(
        groups, rows, r, k, bs, _lane_stride(data, 4, groups),
        _lane_stride(cols, 2, groups))
    y = torch.empty_like(xf)
    lib = _build.load("bell_mrhs")
    fn = lib.bell_matvec_mrhs_f64 if data.dtype == torch.float64 \
        else lib.bell_matvec_mrhs_f32
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr_array([data, cols, xf]), _build.ptr_array([y]),
                dims, _build.stream_of(x))
    _build.check(rc, "bell_matvec_mrhs")
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
