"""K1: the batched Alg. 5 recurrence update, one pass per iteration
(counterpart of ``repro.kernels.gql_update``).

``recurrence_math`` is the plain PyTorch version, written guard for guard
as ``repro/kernels/gql_update.py:22-62``; the CPU path and the oracle of
the CUDA kernel (``csrc/gql_update.cu``, arithmetic in
``csrc/recurrence.cuh``). ``gql_update_cuda`` launches the kernel;
``kernels.ops.gql_update`` picks between the two by device.

At the solver's lane counts (1 to a few thousand) a call costs more than
its 60 flops a lane, so the call is what is designed: ``lane_operands``
hands each operand to the kernel as it lies (a pointer and a lane
stride; 0 for a broadcast value), and the eight outputs are the rows of
one ``(8, B)`` buffer. The plain version reads the operands the same
way (``torch.as_strided``), so the CPU tests cover that handling.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_EPS = 1e-30
INPUT_NAMES = ("alpha_n", "beta_n", "beta_p", "g", "c", "delta", "d_lr",
               "d_rr", "lam_min", "lam_max")
OUTPUT_NAMES = ("g", "c", "delta", "d_lr", "d_rr", "g_rr", "g_lr", "g_lo")


def _max(x, eps):
    return torch.clamp(x, min=eps)


def _min(x, eps):
    return torch.clamp(x, max=eps)


def recurrence_math(alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr,
                    lam_min, lam_max):
    """One Alg. 5 recurrence update, elementwise over lanes. Returns
    ``(g, c, delta, d_lr, d_rr, g_rr, g_lr, g_lo)``."""
    b2p = beta_p * beta_p
    delta_s = _max(delta, _EPS)
    dlr_s = _max(d_lr, _EPS)
    drr_s = _min(d_rr, -_EPS)

    den_g = delta_s * (alpha_n * delta_s - b2p)
    g_new = g + b2p * (c * c) / _max(den_g, _EPS)
    c_new = c * beta_p / delta_s
    delta_new = alpha_n - b2p / delta_s
    dlr_new = alpha_n - lam_min - b2p / dlr_s
    drr_new = alpha_n - lam_max - b2p / drr_s

    # extensions with beta_{i+1}
    b2 = beta_n * beta_n
    dlr_c = _max(dlr_new, _EPS)
    drr_c = _min(drr_new, -_EPS)
    dn_c = _max(delta_new, _EPS)
    alpha_lr = lam_min + b2 / dlr_c
    alpha_rr = lam_max + b2 / drr_c
    den_lo = drr_c - dlr_c
    b2_lo = (lam_max - lam_min) * dlr_c * drr_c / den_lo
    alpha_lo = (lam_max * drr_c - lam_min * dlr_c) / den_lo

    c2 = c_new * c_new

    def sm(alpha_hat, b2_hat):
        den = dn_c * (alpha_hat * dn_c - b2_hat)
        safe = torch.where(den >= 0, _max(den, _EPS), _min(den, -_EPS))
        return g_new + b2_hat * c2 / safe

    return (g_new, c_new, delta_new, dlr_new, drr_new,
            sm(alpha_rr, b2), sm(alpha_lr, b2), sm(alpha_lo, b2_lo))


def lane_operands(args):
    """Check K1's ten operands and return ``(B, [(tensor, stride), ...])``:
    each operand as the kernel reads it, ``tensor[i * stride]`` for lane
    i. ``g`` sets the lanes: it is flat ``(B,)``. Every other operand is
    ``(B,)`` at any lane stride, or a broadcast value (0-d or ``(1,)``,
    stride 0), of ``g``'s dtype on ``g``'s device. A Python number is
    taken as a 0-d tensor of ``g``'s dtype. Nothing is copied."""
    g = args[3]
    if not isinstance(g, torch.Tensor) or g.ndim != 1:
        raise ValueError(f"gql_update wants flat (B,) lanes for g, got "
                         f"{getattr(g, 'shape', type(g))}")
    b = g.shape[0]
    out = []
    for name, x in zip(INPUT_NAMES, args):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, dtype=g.dtype, device=g.device)
        if x.dtype != g.dtype or x.device != g.device:
            raise ValueError(f"gql_update: {name} is {x.dtype} on "
                             f"{x.device}, want {g.dtype} on {g.device}")
        if x.ndim == 0 or x.shape == (1,):
            out.append((x, 0))
        elif x.shape == (b,):
            out.append((x, x.stride(0) if b > 1 else 0))
        else:
            raise ValueError(f"gql_update: {name} has shape "
                             f"{tuple(x.shape)}, want ({b},), (1,) or ()")
    return b, out


def gql_update_plain(alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr,
                     lam_min, lam_max):
    """Plain PyTorch version of K1 over flat (B,) lanes, reading each
    operand as the kernel does (``lane_operands``)."""
    b, ins = lane_operands((alpha_n, beta_n, beta_p, g, c, delta, d_lr,
                            d_rr, lam_min, lam_max))
    return recurrence_math(*(torch.as_strided(x, (b,), (s,))
                             for x, s in ins))


class _Args(ctypes.Structure):
    """``Args`` of csrc/gql_update.cu."""
    _fields_ = [("ins", ctypes.c_void_p * 10),
                ("strides", ctypes.c_longlong * 10),
                ("out", ctypes.c_void_p), ("n", ctypes.c_longlong)]


_ENTRY: dict = {}


def _entry(dtype):
    """The C entry point for ``dtype``, its ``argtypes`` bound once."""
    fn = _ENTRY.get(dtype)
    if fn is None:
        lib = _build.load("gql_update")
        for f in (lib.gql_update_f32, lib.gql_update_f64):
            f.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.empty_launch.argtypes = [ctypes.c_void_p]
        lib.empty_launch.restype = ctypes.c_int
        _ENTRY.update({torch.float32: lib.gql_update_f32,
                       torch.float64: lib.gql_update_f64,
                       "empty": lib.empty_launch})
        fn = _ENTRY[dtype]
    return fn


def gql_update_cuda(alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr,
                    lam_min, lam_max):
    """Launch K1 on the lanes' device (CUDA tensors); raises on anything
    it does not take. The eight outputs are the rows of one ``(8, B)``
    buffer. On the solver's path the lanes are on the current device,
    and the call enters no device context; lanes on another device are
    launched there, as K2-K7's wrappers do."""
    b, ins = lane_operands((alpha_n, beta_n, beta_p, g, c, delta, d_lr,
                            d_rr, lam_min, lam_max))
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"gql_update_cuda needs CUDA tensors, got {dev}")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return gql_update_cuda(alpha_n, beta_n, beta_p, g, c, delta,
                                   d_lr, d_rr, lam_min, lam_max)
    if g.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gql_update_cuda takes float32/float64, got "
                        f"{g.dtype}")
    if b == 0:
        raise ValueError("gql_update_cuda launches on nonempty inputs only, "
                         "got no lane")
    out = torch.empty((len(OUTPUT_NAMES), b), dtype=g.dtype, device=dev)
    args = _Args((ctypes.c_void_p * 10)(*[x.data_ptr() for x, _ in ins]),
                 (ctypes.c_longlong * 10)(*[s for _, s in ins]),
                 out.data_ptr(), b)
    rc = _entry(g.dtype)(ctypes.byref(args),
                         torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gql_update")
    return tuple(out.unbind(0))


def empty_launch() -> None:
    """Launch a kernel that does nothing on the current stream: the launch
    floor that K1's timings are read against (not a kernel of the
    path; no launch count)."""
    _build.check(_entry("empty")(torch.cuda.current_stream().cuda_stream),
                 "empty_kernel")
