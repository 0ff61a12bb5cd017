"""Mixture-of-Experts layer in plain PyTorch (counterpart of
``repro.models.moe``): GShard-style top-k routing with a capacity
factor, one-hot dispatch and combine, and the expert contraction as three
batched products over the stacked ``(E, d, ff)`` / ``(E, ff, d)`` weights.

The reference's behaviours are kept as they are:

- tokens are flattened over (batch, time), left-pads included, into
  groups of ``group_size``, halved until the group divides the token
  count; the capacity ``max(1, int(g * k * cf / E))`` shrinks with the
  group, and one request's drops depend on the other requests of its
  batch;
- ``k`` rounds of argmax over the remaining probabilities, the per-expert
  fill carried across rounds, so second choices queue behind every first
  choice;
- ``dropless=True`` (decode) sets the capacity to the group;
- the router is f32 whatever the model's dtype; ``dispatch`` is in the
  input's dtype, ``combine`` in f32 cast to the experts' output dtype;
- the experts are drawn with ``trunc_normal``'s default fan-in, the
  leading axis, which is the expert count (std ``1/sqrt(E)``).

The shared expert (llama4) and the dense residual MLP (arctic) live in the
block (``model.dense_block_apply``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import common as cm

Tensor = torch.Tensor


class Routes(NamedTuple):
    """One call's routing: ``probs`` (n, g, E) f32, ``dispatch`` (n, g, E,
    cap) 0/1 in the input's dtype, ``combine`` (n, g, E, cap) f32 (each
    kept slot's gate), the group size and the capacity."""
    probs: Tensor
    dispatch: Tensor
    combine: Tensor
    group: int
    cap: int


def moe_init(make, cfg, dtype):
    e, d, ff = cfg.moe_experts, cfg.d_model, cfg.d_ff
    router, a_router = cm.dense_init(make, d, e, "embed", "expert",
                                     bias=False, dtype=torch.float32)
    p = {"router": router, "wi": make((e, d, ff), e, 1.0, dtype),
         "wo": make((e, ff, d), e, 1.0, dtype)}
    a = {"router": a_router, "wi": ("expert", "embed", "mlp"),
         "wo": ("expert", "mlp", "embed")}
    if cfg.act == "swiglu":
        p["wg"] = make((e, d, ff), e, 1.0, dtype)
        a["wg"] = ("expert", "embed", "mlp")
    return p, a


def group_and_capacity(cfg, n_tok: int, group_size: int = 4096,
                       dropless: bool = False) -> tuple:
    """``(g, cap)``: the group, halved until it divides ``n_tok``, and the
    slots an expert takes in a group."""
    g = max(1, min(group_size, n_tok))
    while n_tok % g:
        g //= 2
    if dropless:
        return g, g
    return g, max(1, int(g * cfg.moe_top_k * cfg.moe_capacity_factor
                         / cfg.moe_experts))


def _route(cfg, p, x: Tensor, *, group_size: int = 4096,
           dropless: bool = False) -> Routes:
    b, t, d = x.shape
    e = cfg.moe_experts
    g, cap = group_and_capacity(cfg, b * t, group_size, dropless)
    xt = x.reshape(-1, g, d)
    logits = torch.einsum("nsd,de->nse", xt.to(torch.float32),
                          p["router"]["w"])
    probs = torch.softmax(logits, dim=-1)
    slots = torch.arange(cap, device=x.device)
    dispatch = torch.zeros(xt.shape[:2] + (e, cap), dtype=x.dtype,
                           device=x.device)
    combine = torch.zeros(xt.shape[:2] + (e, cap), dtype=torch.float32,
                          device=x.device)
    remaining = probs
    # the per-expert fill accumulates across the k rounds
    fill = torch.zeros((xt.shape[0], e), dtype=torch.long, device=x.device)
    for _ in range(cfg.moe_top_k):
        idx = torch.argmax(remaining, dim=-1)                    # (n, g)
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, e)                               # (n, g, e)
        pos = torch.cumsum(onehot, dim=1) - 1 + fill[:, None, :]
        fill = fill + onehot.sum(dim=1)
        sel = (onehot > 0) & (pos < cap)
        contrib = (sel[..., None] & (pos.clamp(0, cap - 1)[..., None]
                                     == slots)).to(torch.float32)
        dispatch = dispatch + contrib.to(x.dtype)
        combine = combine + contrib * gate[..., None, None]
        remaining = remaining * (1.0 - onehot.to(remaining.dtype))
    return Routes(probs, dispatch, combine, g, cap)


def moe_apply(cfg, p, x: Tensor, *, group_size: int = 4096,
              dropless: bool = False):
    """x: (B, T, d) -> ``(y (B, T, d), aux)``, aux the Switch
    load-balancing loss ``E * sum(mean(probs) * mean(onehot(argmax)))``.
    Gradients reach the router through the gates and the mean
    probabilities, not through the argmax."""
    b, t, d = x.shape
    e = cfg.moe_experts
    r = _route(cfg, p, x, group_size=group_size, dropless=dropless)
    xt = x.reshape(-1, r.group, d)
    # tokens -> (E, n, cap, d), the experts, and back
    xe = torch.einsum("ngd,ngec->encd", xt, r.dispatch)
    h = torch.einsum("encd,edf->encf", xe, p["wi"])
    if "wg" in p:
        h = F.silu(h) * torch.einsum("encd,edf->encf", xe, p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("encf,efd->encd", h, p["wo"])
    y = torch.einsum("encd,ngec->ngd", ye, r.combine.to(ye.dtype))
    me = r.probs.mean(dim=(0, 1))
    ce = F.one_hot(torch.argmax(r.probs, dim=-1), e).to(
        torch.float32).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return y.reshape(b, t, d), aux
