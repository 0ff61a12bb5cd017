"""The assigned input-shape table and per-(arch, shape) input specs
(counterpart of ``repro.launch.shapes``).

``input_specs`` gives tensors on the meta device (shape and dtype, no
storage) for every model input of a cell, where the reference gives
``jax.ShapeDtypeStruct``s. ``make_inputs`` materialises small real
inputs from a numpy generator, drawn in the reference's order, so the
same seed gives the same arrays in both packages.

Modality frontends are stubs, as in the reference: whisper gets
precomputed frame embeddings (B, S, d); qwen2-vl gets patch embeddings
(B, Tv, d) and M-RoPE position ids (B, 3, T).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..core.operators import resolve_device
from ..models import common as cm
from ..models import model as M


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg, shape_name: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (DESIGN.md Sec. 5)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch " \
            "(quadratic); run only for SSM/hybrid per assignment"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_shapes(cfg, kind: str, seq: int, batch: int) -> Dict[str, Any]:
    """``{name: (shape, dtype)}`` of one cell's batch, in the order the
    reference builds (and ``make_inputs`` draws) them."""
    b, t = batch, seq
    dt = cm._dtype(cfg.dtype)
    i32 = torch.int32
    fam = cfg.family
    if kind in ("train", "prefill"):
        if fam == "vlm":
            tv = min(cfg.vision_tokens, t // 2)
            out = {"tokens": ((b, t - tv), i32),
                   "vision_embeds": ((b, tv, cfg.d_model), dt),
                   "positions": ((b, 3, t), i32)}
            if kind == "train":
                out["labels"] = ((b, t - tv), i32)
            return out
        out = {"frames": ((b, t, cfg.d_model), dt)} if fam == "encdec" \
            else {}
        out["tokens"] = ((b, t), i32)
        if kind == "train":
            out["labels"] = ((b, t), i32)
        return out
    out = {"tokens": ((b, 1), i32),
           "position": ((b, 3, 1) if fam == "vlm" else (1,), i32)}
    if fam == "encdec":
        out["enc_memory"] = ((b, t, cfg.d_model), dt)
    return out


def batch_specs(cfg, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Meta tensors for the data batch of one cell."""
    return {k: _spec(shape, dt) for k, (shape, dt) in
            _batch_shapes(cfg, cell.kind, cell.seq, cell.batch).items()}


def cache_specs(cfg, cell: ShapeCell, quantized_kv: bool = False):
    """Meta tensors for the decode / prefill caches (``make_caches`` on the
    meta device)."""
    return M.make_caches(cfg, cell.batch, cell.seq, cm._dtype(cfg.dtype),
                         quantized_kv=quantized_kv, device="meta")


def input_specs(cfg, shape_name: str, quantized_kv: bool = False):
    """All inputs of one (arch, shape) cell: ``(step_kind, specs)``, specs
    holding 'batch' and (for the serving kinds) 'caches'."""
    cell = SHAPES[shape_name]
    specs = {"batch": batch_specs(cfg, cell)}
    if cell.kind in ("prefill", "decode"):
        specs["caches"] = cache_specs(cfg, cell, quantized_kv)
    return cell.kind, specs


# ---------------------------------------------------------------------------
# Real (small) inputs for smoke tests


def make_inputs(cfg, kind: str, seq: int, batch: int, seed: int = 0, *,
                device="cuda"):
    """Small real inputs of one kind on ``device``: tokens drawn in
    [0, vocab) and frame / vision embeddings from a standard normal, all
    from ``np.random.default_rng(seed)`` in the reference's order; M-RoPE
    positions ``arange`` on all three streams, a decode position
    ``seq - 1``."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    out = {}
    for name, (shape, dt) in _batch_shapes(cfg, kind, seq, batch).items():
        if name in ("tokens", "labels"):
            arr = rng.integers(0, cfg.vocab, shape)
        elif name in ("frames", "vision_embeds", "enc_memory"):
            arr = rng.standard_normal(shape)
        elif name == "positions":
            arr = np.broadcast_to(np.arange(seq), shape).copy()
        else:   # a decode step's position
            arr = np.full(shape, seq - 1)
        out[name] = torch.as_tensor(arr).to(device=dev, dtype=dt)
    return out
