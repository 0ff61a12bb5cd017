"""AdamW with decoupled weight decay and global-norm clipping (counterpart
of ``repro.optim.adamw``).

The moments and the clipped gradients are f32 whatever the parameters'
dtype (bf16 parameters, f32 optimizer state). Where the reference returns
new trees, ``update`` writes the parameters (in their own dtype) and the
moments in place and returns them: the caller's tensors are the state.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import tree


class AdamWState(NamedTuple):
    count: torch.Tensor      # () int32, on the host
    m: Any
    v: Any


def _f32(x) -> float:
    """A value rounded to f32, as a Python float (exact in f32 math)."""
    return float(torch.as_tensor(x, dtype=torch.float32))


class AdamW(NamedTuple):
    lr: Any                      # callable step -> lr, or float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(count=torch.zeros((), dtype=torch.int32),
                          m=tree.map(zeros, params),
                          v=tree.map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step: ``(params, state, {"grad_norm", "lr"})``, the first two
        the same tensors as given, updated in place."""
        g32 = [g.to(torch.float32) for g in tree.leaves(grads)]
        if self.clip_norm:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in g32))
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        else:
            gnorm, scale = torch.zeros(()), None
        count = state.count + 1
        c = count.to(torch.float32)
        lr = _f32(self.lr(count) if callable(self.lr) else self.lr)
        b1c = _f32(1.0 - torch.tensor(self.b1, dtype=torch.float32) ** c)
        b2c = _f32(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** c)
        ps, ms, vs = tree.leaves(params), tree.leaves(state.m), \
            tree.leaves(state.v)
        for p, m, v, g in zip(ps, ms, vs, g32):
            if scale is not None:
                g = g * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p32 = p.to(torch.float32)
            step = (m / b1c) / (torch.sqrt(v / b2c) + self.eps) \
                + self.weight_decay * p32
            p.copy_(p32 - lr * step)
        return params, AdamWState(count=count, m=state.m, v=state.v), \
            {"grad_norm": gnorm, "lr": torch.tensor(lr, dtype=torch.float32)}


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """Linear warmup then cosine decay to floor * peak, in f32."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr \
            * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr
