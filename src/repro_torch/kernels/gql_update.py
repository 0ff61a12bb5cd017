"""K1: the batched Alg. 5 recurrence update, one pass per iteration
(counterpart of ``repro.kernels.gql_update``).

``recurrence_math`` is the plain PyTorch version, written guard for guard
as ``repro/kernels/gql_update.py:22-62``; the CPU path and the oracle of
the CUDA kernel (``csrc/gql_update.cu``, arithmetic in
``csrc/recurrence.cuh``). ``gql_update_cuda`` launches the kernel;
``kernels.ops.gql_update`` picks between the two by device.
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


def _flat_inputs(args):
    """The ten (B,) operands with ``lam_min``/``lam_max`` broadcast to
    the lane shape, as the reference wrapper does."""
    g = args[3]
    if g.ndim != 1:
        raise ValueError(f"gql_update wants flat (B,) lanes, got {g.shape}")
    return [torch.broadcast_to(torch.as_tensor(x, dtype=g.dtype,
                                               device=g.device), g.shape)
            for x in args]


def gql_update_plain(alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr,
                     lam_min, lam_max):
    """Plain PyTorch version of K1 over flat (B,) lanes."""
    return recurrence_math(*_flat_inputs(
        (alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr, lam_min,
         lam_max)))


def gql_update_cuda(alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr,
                    lam_min, lam_max):
    """Launch K1 on CUDA tensors; raises on anything it does not take."""
    ins = [x.contiguous() for x in _flat_inputs(
        (alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr, lam_min,
         lam_max))]
    ref = ins[3]
    if ref.device.type != "cuda":
        raise ValueError(f"gql_update_cuda needs CUDA tensors, got "
                         f"{ref.device}")
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gql_update_cuda takes float32/float64, got "
                        f"{ref.dtype}")
    for name, x in zip(INPUT_NAMES, ins):
        if x.dtype != ref.dtype or x.device != ref.device \
                or x.shape != ref.shape:
            raise ValueError(f"gql_update_cuda: {name} is {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}, want "
                             f"{ref.dtype} {tuple(ref.shape)} on "
                             f"{ref.device}")
    outs = [torch.empty_like(ref) for _ in OUTPUT_NAMES]
    lib = _build.load("gql_update")
    fn = lib.gql_update_f64 if ref.dtype == torch.float64 \
        else lib.gql_update_f32
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(ref.device):
        rc = fn(_build.ptr_array(ins), _build.ptr_array(outs),
                ref.numel(), _build.stream_of(ref))
    _build.check(rc, "gql_update")
    return tuple(outs)
