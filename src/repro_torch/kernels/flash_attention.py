"""K7: streaming (flash) attention forward (counterpart of
``repro.kernels.flash_attention``).

Online-softmax attention over ``q (BH, T, D)`` and ``k, v (BH, S, D)``
that never holds the (T, S) score matrix in device memory: f32
accumulation, output in q's dtype, ``scale = 1/sqrt(D)``, causal masking
on zero-aligned global indices (query i attends keys j <= i, also when
T != S), masked scores at ``-1e30`` and the row sum clamped at 1e-30, as
the reference kernel does.

``flash_attention_plain`` is ``repro/kernels/ref.py:37-49`` in PyTorch,
the CPU path and the oracle of the CUDA kernels; ``flash_attention_cuda``
launches ``csrc/flash_attention.cu``, one of three hand-written kernels
chosen by type and shape (``route``): bf16 at D = 64 or 128 with at least
one 64-row query tile takes ``wgmma`` with TMA loads (the prefill), other
bf16 calls (D = 32, and the decode call's single query row) take the
``mma.sync`` kernel, and f32 takes CUDA-core f32 FMA (never TF32).
``ROUTES`` counts each route's launches. ``mha_flash`` is the multi-head
wrapper, not a kernel: q ``(B, T, H, D)``, k/v ``(B, S, Hkv, D)`` with
grouped-query heads. On the CPU it repeats the kv heads and flattens
(B, H), as the reference does; on the card it hands the kernel the
strided views and the kv-head index ``h // (H / Hkv)`` instead, which
gives the same result without copying q, k or v. ``kernels.ops`` picks
by device and counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)  # the head widths the CUDA kernels are built for
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_MIN_ROWS = 64        # one query tile of a consumer warpgroup

ROUTES = {"wgmma": 0, "mma_sync": 0, "fma_f32": 0}


def route(dtype: torch.dtype, d: int, t_len: int) -> str:
    """The kernel that takes a call of head width ``d`` over ``t_len``
    query rows: routing by shape between hand-written kernels."""
    if dtype == torch.float32:
        return "fma_f32"
    if d in WGMMA_HEAD_DIMS and t_len >= WGMMA_MIN_ROWS:
        return "wgmma"
    return "mma_sync"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K7: softmax attention with the whole
    (BH, T, S) f32 score matrix, in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("btd,bsd->bts", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    if causal:
        t_len, s_len = s.shape[-2], s.shape[-1]
        rows = torch.arange(t_len, device=q.device)[:, None]
        cols = torch.arange(s_len, device=q.device)[None, :]
        s = torch.where(cols <= rows, s,
                        torch.full((), _NEG_INF, dtype=s.dtype,
                                   device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p,
                        v.to(torch.float32)).to(q.dtype)


def _check_heads(q, k, v, layout: str) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{layout}: got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not share "
                         f"{k.shape[2]} kv heads evenly")


def _rows_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its rows along D are contiguous and start on
    16-byte boundaries (the bf16 kernels load them 16 bytes at a time, and
    a TMA tensor map takes only such strides, none of them 0), else a
    fresh contiguous copy."""
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            st > 0 and st * x.element_size() % 16 == 0
            for st in x.stride()[:-1]):
        return x
    return torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)


def _launch(q, k, v, o, causal: bool) -> torch.Tensor:
    """One K7 launch over (B, T, H, D) q and o and (B, S, Hkv, D) k/v
    views with unit stride along D; fills and returns ``o``."""
    if any(x.device.type != "cuda" or x.device != q.device
           for x in (q, k, v)):
        raise ValueError(f"flash attention needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash attention kernel takes f32 or bf16 q, "
                        f"k, v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel is built for head "
                         f"widths {HEAD_DIMS}, got D={d}")
    if o.numel() == 0 or k.shape[1] == 0:
        raise ValueError(f"flash attention launches on nonempty inputs "
                         f"only, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    q, k, v = (_rows_aligned(x) for x in (q, k, v))
    b, t_len, h, _ = q.shape
    dims = (ctypes.c_longlong * 7)(b, h, k.shape[2], t_len, k.shape[1], d,
                                   int(causal))
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, o) for i in (0, 1, 2)))
    lib = _build.load("flash_attention")
    which = route(q.dtype, d, t_len)
    fn = {"fma_f32": lib.flash_attention_f32,
          "mma_sync": lib.flash_attention_bf16,
          "wgmma": lib.flash_attention_bf16_wgmma}[which]
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(_build.ptr_array([q, k, v]), _build.ptr_array([o]), dims,
                strides, 1.0 / d ** 0.5, _build.stream_of(q))
    _build.check(rc, f"flash_attention ({which})")
    ROUTES[which] += 1
    return o


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch K7 on CUDA tensors q (BH, T, D), k/v (BH, S, D): the BH
    rows are the kernel's heads (one batch, a kv head per head)."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash_attention wants q (BH, T, D), k/v (BH, S, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(*(x.transpose(0, 1)[None] for x in (q, k, v, o)), causal)
    return o


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, bt: int = 128,
              bs: int = 128) -> torch.Tensor:
    """Multi-head attention: q (B, T, H, D), k/v (B, S, Hkv, D), H a
    multiple of Hkv (grouped-query heads); returns (B, T, H, D) in q's
    dtype. ``bt``/``bs`` are the reference's tile sizes, kept for its
    signature; neither path uses them (see ``kernels.ops``)."""
    _check_heads(q, k, v, "mha_flash wants q (B, T, H, D), k/v (B, S, "
                          "Hkv, D)")
    if q.device.type == "cuda":
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return _launch(q, k, v, o, causal)
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        k = torch.repeat_interleave(k, h // hkv, dim=2)
        v = torch.repeat_interleave(v, h // hkv, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, t, d)
    kf = k.transpose(1, 2).reshape(b * h, s, d)
    vf = v.transpose(1, 2).reshape(b * h, s, d)
    of = flash_attention_plain(qf, kf, vf, causal=causal)
    return of.reshape(b, h, t, d).transpose(1, 2)
