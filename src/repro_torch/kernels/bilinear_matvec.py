"""K6: fused bilinear matvec (counterpart of
``repro.kernels.bilinear_matvec``).

One pass over A computes both

    y     = A @ x        (the next Krylov direction)
    alpha = x^T A x      (the Lanczos diagonal coefficient)

batched over independent quadrature systems: ``a (B, N, N)`` symmetric,
f32 or bf16, and ``x (B, N)``. Both results are f32 with f32
accumulation, as ``repro/kernels/ref.py:10-15`` defines them (x is
rounded to f32 first).

``fused_matvec_plain`` is that einsum pair, the CPU path and the oracle
of the CUDA kernel; ``fused_matvec_cuda`` launches
``csrc/bilinear_matvec.cu``; ``kernels.ops.fused_matvec`` picks between
the two by device.

Unlike the reference, both raise ``ValueError`` when ``x`` has another
number of systems than ``a``: the TPU kernel sizes its grid by
``a.shape[0]`` alone and, given ``a (1, N, N)`` and ``x (L, N)``,
returns one row (ROADMAP Queue 3).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def check_shapes(a: torch.Tensor, x: torch.Tensor) -> None:
    """Raise unless ``a`` is (B, N, N) and ``x`` is (B, N)."""
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"fused_matvec wants a (B, N, N), got "
                         f"{tuple(a.shape)}")
    if x.ndim != 2 or tuple(x.shape) != tuple(a.shape[:2]):
        raise ValueError(f"fused_matvec wants x (B, N) = "
                         f"{tuple(a.shape[:2])} for a {tuple(a.shape)}, got "
                         f"{tuple(x.shape)}")


def fused_matvec_plain(a: torch.Tensor, x: torch.Tensor):
    """Plain PyTorch version of K6: ``(A @ x, x^T A x)`` in f32."""
    check_shapes(a, x)
    x32 = x.to(torch.float32)
    y = torch.einsum("bij,bj->bi", a.to(torch.float32), x32)
    alpha = torch.einsum("bi,bi->b", x32, y)
    return y, alpha


_ENTRY = {(torch.float32, torch.float32): "fused_matvec_f32_f32",
          (torch.float32, torch.float64): "fused_matvec_f32_f64",
          (torch.bfloat16, torch.float32): "fused_matvec_bf16_f32",
          (torch.bfloat16, torch.float64): "fused_matvec_bf16_f64"}


def fused_matvec_cuda(a: torch.Tensor, x: torch.Tensor):
    """Launch K6 on CUDA tensors: ``a`` (B, N, N) contiguous f32 or bf16
    (read as it is, never padded or copied), ``x`` (B, N) f32 or f64
    (another float type is rounded to f32 first). Returns f32
    ``(y (B, N), alpha (B,))``."""
    check_shapes(a, x)
    if x.device.type != "cuda" or a.device != x.device:
        raise ValueError(f"fused_matvec_cuda needs a and x on one CUDA "
                         f"device, got {a.device} and {x.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_matvec_cuda takes f32/bf16 a, got "
                        f"{a.dtype}")
    if not a.is_contiguous():
        raise ValueError("fused_matvec_cuda needs a contiguous a (the "
                         "kernel reads it in place)")
    if x.numel() == 0:
        raise ValueError(f"fused_matvec_cuda launches on nonempty inputs "
                         f"only, got x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    x = x.contiguous()
    nb, n = x.shape
    y = torch.empty((nb, n), dtype=torch.float32, device=x.device)
    alpha = torch.empty((nb,), dtype=torch.float32, device=x.device)
    partial = torch.empty((nb, -(-n // 32)), dtype=torch.float32,
                          device=x.device)
    fn = getattr(_build.load("bilinear_matvec"), _ENTRY[(a.dtype, x.dtype)])
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        rc = fn(_build.ptr_array([a, x]),
                _build.ptr_array([y, alpha, partial]),
                (ctypes.c_longlong * 2)(nb, n), _build.stream_of(x))
    _build.check(rc, "fused_matvec")
    return y, alpha
