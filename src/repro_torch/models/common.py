"""Layer library in plain PyTorch (counterpart of ``repro.models.common``).

Every ``*_init`` returns ``(params, axes)``: two nested dicts of the same
structure, the second holding each dimension's logical axis name (or
None), as in the reference. Params are plain tensors and the apply
functions are pure. An init takes ``make(shape, fan_in, scale, dtype)``
(``scale`` a float, or 'ones' / 'zeros' / 'log_arange' for constant
leaves; the last is mamba1's ``log(1..n)`` along the last axis), which
returns a drawn tensor (``init_model``) or an empty one on the meta
device (the module skeleton), so the structure is written once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding.api import einsum, is_dtensor

Tensor = torch.Tensor


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# f32 entries drawn at a time (256 MB): a larger leaf is drawn slice by
# slice into its destination (llama4's stacked experts hold 5.4e9 entries
# a leaf, 21.5 GB in f32)
DRAW_CHUNK = 1 << 26


def trunc_normal(generator: torch.Generator, shape, scale: float,
                 dtype, fan_in: int | None = None) -> Tensor:
    """Normal truncated to [-2, 2] times ``scale / sqrt(fan_in)``, drawn in
    f32 on ``generator``'s device, then cast. ``fan_in`` defaults to
    ``shape[0]``; a stacked draw passes the per-layer fan-in. A leaf of
    more than ``DRAW_CHUNK`` entries is drawn in f32 slices of its flat
    storage, each scaled in place and cast into the destination: the same
    distribution, with one slice of f32 temporaries."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) else 1
    std = scale / max(fan_in, 1) ** 0.5
    dev = generator.device
    n = math.prod(shape)
    if n <= DRAW_CHUNK:
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (x * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1)
    for i in range(0, n, DRAW_CHUNK):
        x = torch.empty(min(DRAW_CHUNK, n - i), dtype=torch.float32,
                        device=dev)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        flat[i:i + x.numel()].copy_(x.mul_(std))
    return out


def ones(make, shape, dtype):
    return make(shape, None, "ones", dtype)


def zeros(make, shape, dtype):
    return make(shape, None, "zeros", dtype)


# ---------------------------------------------------------------------------
# Dense projections


def dense_init(make, in_dim: int, out_dim: int, in_ax, out_ax, *,
               bias: bool, dtype, scale: float = 1.0):
    p = {"w": make((in_dim, out_dim), in_dim, scale, dtype)}
    a = {"w": (in_ax, out_ax)}
    if bias:
        p["b"] = zeros(make, (out_dim,), dtype)
        a["b"] = (out_ax,)
    return p, a


def dense_apply(p, x: Tensor) -> Tensor:
    """``x @ w (+ b)``. Mixed dtypes promote as jnp promotes them (an f32
    activation against bf16 weights computes in f32): ``torch.matmul``
    would raise."""
    w = p["w"]
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if "b" in p:
        if is_dtensor(y):
            y = settle_partial(y)
        y = y + p["b"]
    return y


def settle_partial(x):
    """A DTensor's partial sums reduced (``Replicate`` where it was
    ``Partial``): a row-parallel product before its bias, which a partial
    tensor cannot take on every torch version."""
    from torch.distributed.tensor import Replicate

    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


# ---------------------------------------------------------------------------
# Norms (olmo uses a NON-PARAMETRIC LayerNorm)


def norm_init(make, kind: str, dim: int, dtype):
    if kind == "rmsnorm":
        return {"scale": ones(make, (dim,), dtype)}, {"scale": ("embed",)}
    if kind == "layernorm":
        return ({"scale": ones(make, (dim,), dtype),
                 "bias": zeros(make, (dim,), dtype)},
                {"scale": ("embed",), "bias": ("embed",)})
    if kind == "layernorm_np":
        return {}, {}
    raise ValueError(kind)


def norm_apply(kind: str, p, x: Tensor) -> Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                             + 1e-6)
        return (y * p["scale"].to(torch.float32)).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-6)
    if kind == "layernorm":
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + multimodal M-RoPE)


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                       # (D/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: Tensor, positions3: Tensor, theta: float) -> Tensor:
    """Qwen2-VL M-RoPE: positions3 (..., 3, T) = (temporal, h, w) ids; the
    head dim splits into three bands, each rotated by ``apply_rope`` (its
    frequencies from its own width) with its own id stream; a band
    narrower than 2 passes as it is. The bands are 1/2, 1/4, 1/4 of the
    head, even widths, as the reference splits them."""
    d = x.shape[-1]
    b1 = d // 2 // 2 * 2          # temporal band (half the dim, even)
    b2 = (d - b1) // 2 // 2 * 2   # height band
    b3 = d - b1 - b2              # width band
    parts = torch.split(x, [b1, b2, b3], dim=-1)
    out = [apply_rope(band, pos, theta) if band.shape[-1] >= 2 else band
           for band, pos in zip(parts, positions3.movedim(-2, 0))]
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# MLPs


def mlp_init(make, cfg, d_ff: int, dtype, ff_ax: str = "mlp"):
    bias = cfg.use_bias
    p_in, a_in = dense_init(make, cfg.d_model, d_ff, "embed", ff_ax,
                            bias=bias, dtype=dtype)
    if cfg.act == "swiglu":
        p_gate, a_gate = dense_init(make, cfg.d_model, d_ff, "embed", ff_ax,
                                    bias=bias, dtype=dtype)
    p_out, a_out = dense_init(make, d_ff, cfg.d_model, ff_ax, "embed",
                              bias=bias, dtype=dtype)
    if cfg.act == "swiglu":
        return ({"wi": p_in, "wg": p_gate, "wo": p_out},
                {"wi": a_in, "wg": a_gate, "wo": a_out})
    return {"wi": p_in, "wo": p_out}, {"wi": a_in, "wo": a_out}


def mlp_apply(cfg, p, x: Tensor) -> Tensor:
    if "wg" in p:
        h = F.silu(dense_apply(p["wi"], x)) * dense_apply(p["wg"], x)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense_apply(p["wi"], x), approximate="tanh")
    return dense_apply(p["wo"], h)


# ---------------------------------------------------------------------------
# Embedding / unembedding


def embed_init(make, vocab: int, dim: int, dtype):
    return ({"table": make((vocab, dim), vocab, 1.0, dtype)},
            {"table": ("vocab", "embed")})


def embed_apply(p, tokens: Tensor) -> Tensor:
    table = p["table"]
    if is_dtensor(table):
        from ..sharding.api import sharded_embedding

        return sharded_embedding(table, tokens)
    return F.embedding(tokens.long(), table)



def unembed_logits(p_embed, x: Tensor) -> Tensor:
    """Tied unembedding (x @ table^T) in f32 for a stable CE."""
    return einsum("...d,vd->...v", x.to(torch.float32),
                        p_embed["table"].to(torch.float32))
