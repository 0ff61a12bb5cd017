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


def shares(rows: int, ctas: int) -> list:
    """The card's partition of the ``B * N`` rows of A among its CTAs: CTA
    ``c`` takes rows ``[c * rows // ctas, (c + 1) * rows // ctas)``, one
    contiguous run each, with ``ctas = min(SMs, rows)`` so that none is
    empty. A pure function of the shapes and the SM count, as the kernel
    computes it, so a call's sums have one order on one card."""
    ctas = min(ctas, rows)
    return [(c * rows // ctas, (c + 1) * rows // ctas) for c in range(ctas)]


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# Per (device, stream): K6's counters of finished CTAs per system. A launch
# leaves them zero, so they are zeroed once, here, and never again.
_COUNTERS: dict = {}


def _counters(nb: int, device) -> torch.Tensor:
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < nb:
        c = torch.zeros(max(nb, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def fused_matvec_cuda(a: torch.Tensor, x: torch.Tensor):
    """Launch K6 on CUDA tensors: ``a`` (B, N, N) contiguous f32 or bf16
    (read as it is, never padded or copied), ``x`` (B, N) f32 or f64 with
    any strides (another float type is rounded to f32 first). One kernel,
    one launch. Returns f32 ``(y (B, N), alpha (B,))``."""
    check_shapes(a, x)
    if x.device.type != "cuda" or a.device != x.device:
        raise ValueError(f"fused_matvec_cuda needs a and x on one CUDA "
                         f"device, got {a.device} and {x.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_matvec_cuda takes f32/bf16 a, got "
                        f"{a.dtype}")
    if not a.is_contiguous():
        raise ValueError("fused_matvec_cuda needs a contiguous a (the "
                         "kernel streams it as one run)")
    if x.numel() == 0:
        raise ValueError(f"fused_matvec_cuda launches on nonempty inputs "
                         f"only, got x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    nb, n = x.shape
    dev = x.device
    sms = _sms(dev)
    y = torch.empty((nb, n), dtype=torch.float32, device=dev)
    alpha = torch.empty((nb,), dtype=torch.float32, device=dev)
    partial = torch.empty((sms + nb,), dtype=torch.float32, device=dev)
    fn = getattr(_build.load("bilinear_matvec"), _ENTRY[(a.dtype, x.dtype)])
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(_build.ptr_array([a, x]),
                _build.ptr_array([y, alpha, partial, _counters(nb, dev)]),
                (ctypes.c_longlong * 5)(nb, n, x.stride(0), x.stride(1),
                                        sms),
                _build.stream_of(x))
    _build.check(rc, "fused_matvec")
    return y, alpha
