"""Error-feedback int8 gradient compression for the data-parallel reduce
(counterpart of ``repro.optim.compression``).

Each rank quantizes its gradient plus its carried residual to int8 with
one f32 scale, the ranks sum the int8 payloads as int32 and the scales,
and every rank rebuilds the mean with the mean scale. What the
quantization lost stays in the rank's residual and is added back at the
next step (error feedback; Karimireddy et al. 2019). The payload is 1
byte an element and one f32 scale, against 4 for f32.

As in the reference, the train step does not use it (``launch.steps``
reduces f32 gradients); a data-parallel loop that reduces its local
gradients itself calls ``compress_tree_psum`` in place of the f32
all-reduce. ``group`` is a process group, or ``(mesh, axis name)`` for
the group of one mesh dimension.
"""
from __future__ import annotations

from typing import Any

import torch

from .. import tree


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: ``(q, scale)`` with scale = max|x| / 127
    + 1e-12 and q = round(x / scale) (ties to even) clipped to +-127."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _group(group):
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.get_group(mesh.mesh_dim_names.index(axis))
    return group


def compressed_psum(x: torch.Tensor, group, residual: torch.Tensor):
    """int8-quantized mean over ``group`` with error feedback.

    ``x``, ``residual``: this rank's f32 tensors. Returns ``(x_hat,
    new_residual)``: x_hat = (sum of the int8 payloads as int32) times the
    mean scale over n, the same on every rank; new_residual = (x +
    residual) - its dequantized payload."""
    import torch.distributed as dist

    g = _group(group)
    x_fb = x + residual
    q, scale = quantize_int8(x_fb)
    new_residual = x_fb - dequantize(q, scale)
    # the int32 widening happens before the reduce: the sum of n payloads
    # of +-127 does not fit int8
    total = q.to(torch.int32)
    dist.all_reduce(total, group=g)
    scale_sum = scale.reshape(1).clone()
    dist.all_reduce(scale_sum, group=g)
    n = float(dist.get_world_size(g))
    # scales differ per rank; the mean scale's bias is absorbed by the
    # error feedback
    out = total.to(torch.float32) * (scale_sum[0] / n) / n
    return out, new_residual


def compress_tree_psum(grads: Any, group, residuals: Any):
    """``compressed_psum`` over every leaf: ``(means, new_residuals)``,
    trees like ``grads``."""
    outs, ress = [], []
    flat_g, spec = tree.flatten(grads)
    for g, r in zip(flat_g, tree.leaves(residuals)):
        o, nr = compressed_psum(g.to(torch.float32), group, r)
        outs.append(o)
        ress.append(nr)
    return tree.unflatten(spec, outs), tree.unflatten(spec, ress)


def init_residuals(params: Any) -> Any:
    """Zero f32 residuals shaped like ``params``."""
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
