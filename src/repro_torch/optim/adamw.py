"""AdamW with decoupled weight decay and global-norm clipping (counterpart
of ``repro.optim.adamw``).

The moments and the clipped gradients are f32 whatever the parameters'
dtype (bf16 parameters, f32 optimizer state). Where the reference returns
new trees, ``update`` writes the parameters (in their own dtype) and the
moments in place and returns them: the caller's tensors are the state.

Over a mesh the parameters, gradients and moments are DTensors placed
alike (``launch.steps``); the moments are placed like their parameters
(ZeRO: a parameter's FSDP shard carries its moments' shard). The clip
norm then sums every leaf's squares over the whole mesh, each replica
counted once, and reduces over each mesh dimension in turn, so every rank
gets the same bits; ``count`` stays a plain host tensor, the same on
every rank. Plain leaves keep the one-device arithmetic, bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import tree
from ..sharding.api import is_dtensor


# entries of a leaf's local tensor updated at a time: the update's f32
# temporaries are a piece's, not a whole leaf's (llama3-405b's stacked MLP
# leaves hold 8.7e8 entries a rank at 4 layers on data = 2 x model = 2)
UPDATE_CHUNK = 1 << 26


def _local(x) -> torch.Tensor:
    return x.to_local() if is_dtensor(x) else x


def _pieces(*xs) -> list:
    """Matching flat pieces of at most ``UPDATE_CHUNK`` entries of the
    local tensors of ``xs`` (views: a write lands in the tensor), or the
    whole local tensors where one is not contiguous. The update is
    elementwise, so a piece gets the bits the whole leaf would."""
    locs = [_local(x) for x in xs]
    n = locs[0].numel()
    if n <= UPDATE_CHUNK or not all(t.is_contiguous() for t in locs):
        return [locs]
    flat = [t.view(-1) for t in locs]
    return [[f[i:i + UPDATE_CHUNK] for f in flat]
            for i in range(0, n, UPDATE_CHUNK)]


def _mesh_norm(gs: list) -> torch.Tensor:
    """sqrt of the sum of squares of DTensor leaves (in f32) over their
    whole mesh, a plain tensor with the same bits on every rank: each rank
    adds its local squares, a leaf replicated over mesh dims divided by
    their size (exact for powers of two), then one all-reduce a mesh
    dimension."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    mesh = gs[0].device_mesh
    total = torch.zeros((), dtype=torch.float32, device=gs[0].device)
    for g in gs:
        rep = 1
        for size, pl in zip(mesh.shape, g.placements):
            if isinstance(pl, Replicate):
                rep *= size
        loc = g.to_local().to(torch.float32)
        total = total + torch.sum(loc * loc) / rep
    for d in range(mesh.ndim):
        if mesh.shape[d] > 1:
            dist.all_reduce(total, group=mesh.get_group(d))
    return torch.sqrt(total)


class AdamWState(NamedTuple):
    count: torch.Tensor      # () int32, on the host
    m: Any
    v: Any


def _f32(x) -> torch.Tensor:
    """A value rounded to f32, as a 0-d f32 tensor on the host. It meets
    the leaves as a Python float would (rounded to f32, the same bits),
    without reading a value back: a step traced on fake tensors
    (``launch.dryrun``) has no value to read."""
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


class AdamW(NamedTuple):
    lr: Any                      # callable step -> lr, or float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        def zeros(p):
            if is_dtensor(p):   # placed like the parameter
                return torch.zeros_like(p, dtype=torch.float32)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(count=torch.zeros((), dtype=torch.int32),
                          m=tree.map(zeros, params),
                          v=tree.map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step: ``(params, state, {"grad_norm", "lr"})``, the first two
        the same tensors as given, updated in place. Each leaf's gradient
        is taken to f32 where it is used, and a DTensor leaf is updated
        through its local tensor, ``UPDATE_CHUNK`` entries at a time: the
        arithmetic of the whole tree in f32, with one piece's
        temporaries."""
        gs = tree.leaves(grads)
        return self._update(gs, state, params, _mesh_norm if gs and
                            is_dtensor(gs[0]) else None)

    def _update(self, gs, state, params, mesh_norm):
        if self.clip_norm:
            gnorm = mesh_norm(gs) if mesh_norm else torch.sqrt(sum(
                torch.sum(g * g) for g in (x.to(torch.float32)
                                           for x in gs)))
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        else:
            gnorm, scale = torch.zeros(()), None
        # a count restored onto a mesh is a replicated DTensor
        count = (state.count.to_local() if is_dtensor(state.count)
                 else state.count) + 1
        c = count.to(torch.float32)
        lr = _f32(self.lr(count) if callable(self.lr) else self.lr)
        b1c = _f32(1.0 - torch.tensor(self.b1, dtype=torch.float32) ** c)
        b2c = _f32(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** c)
        ps, ms, vs = tree.leaves(params), tree.leaves(state.m), \
            tree.leaves(state.v)
        for leaf in zip(ps, ms, vs, gs):
            for p, m, v, g in _pieces(*leaf):
                g = g.to(torch.float32)
                if scale is not None:
                    g = g * scale
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g * g)
                p32 = p.to(torch.float32)
                step = (m / b1c) / (torch.sqrt(v / b2c) + self.eps) \
                    + self.weight_decay * p32
                p.copy_(p32 - lr * step)
        return params, AdamWState(count=count, m=state.m, v=state.v), \
            {"grad_norm": gnorm, "lr": lr}


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
