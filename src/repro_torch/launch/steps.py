"""The train and serve steps, on one device or over a mesh (counterpart of
``repro.launch.steps``).

``build_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``, which updates the parameters and the optimizer
state in place. With ``microbatches > 1`` the batch is split along its
first axis and the f32 gradients are averaged over the pieces.
``build_prefill_step`` / ``build_decode_step`` return ``model.prefill`` /
``model.decode_step`` bound to a config; both write the caches in place
and pass the batch through as it is: a VLM's ``vision_embeds`` and
``positions``, an enc-dec model's ``frames`` (prefill) or ``enc_memory``
(decode).

Over a mesh (``mesh=``, a ``DeviceMesh`` named like the plan's axes, and
``plan=``, ``sharding.tp_plan``) the parameters and the optimizer
moments are DTensors placed as ``train_shardings`` says
(``sharding.distribute``). The step places a plain batch on the data
axes (each rank keeps its rows of the global batch it was given) and
runs the forward and backward under ``sharding.activation_context``.
Under FSDP the model gathers the sharded parameters where it uses them
(``sharding.api.fsdp_gather``): one unit of the layer stack at a time,
inside the recomputed block, so the recompute gathers it again; the
top-level leaves at their use. Each unit's gradient is reduce-scattered
as its backward ends, and the step brings any gradient still placed
otherwise to its parameter's placements before AdamW. Microbatches split
each rank's local rows. The metrics come back as plain tensors, the
same bits on every rank.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .. import tree
from ..models import model as M
from ..optim.adamw import AdamW, AdamWState, warmup_cosine
from ..sharding import api as shapi


def default_optimizer(total_steps: int = 10000) -> AdamW:
    return AdamW(lr=warmup_cosine(3e-4, 200, total_steps))


# ---------------------------------------------------------------------------
# Placement helpers


def _replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in shapi.mesh_sizes(mesh))


def _size(mesh, axes) -> int:
    return shapi._axis_size(mesh, axes)


def batch_sharding(mesh, plan: shapi.Plan, batch_specs: Any):
    """The placements of every batch leaf: its leading (batch) dim over
    the plan's data axes where it divides, else replicated."""
    data_axes = plan.rules["batch"]

    def one(x):
        spec = [None] * len(x.shape)
        if len(x.shape) >= 1 and x.shape[0] % _size(mesh, data_axes) == 0:
            spec[0] = data_axes
        return shapi.placements(tuple(spec), mesh)

    return tree.map(one, batch_specs)


_CACHE_RANK = {"k": 4, "v": 4, "k_scale": 4, "v_scale": 4, "conv": 3,
               "length": 0}


def _cache_spec(cfg, mesh, plan, name: str, shape) -> tuple:
    """The reference's spec of one cache leaf (its leading stack dims
    replicated): k / v / scales (B, S, Hkv, D) batch on data, seq on
    model; SSM conv (B, K, di) di on model; SSM state mamba1 (B, di, n)
    di on model, mamba2 (B, H, dh, n) H on model."""
    data_axes = plan.rules.get("cache_batch") or plan.rules["batch"]
    model_axis = plan.rules["heads"]
    rank = dict(_CACHE_RANK,
                state=3 if cfg.ssm_variant == "mamba1" else 4).get(name)
    if rank is None or name == "length" or len(shape) <= 1:
        return (None,) * len(shape)
    lead = len(shape) - rank
    tail = shape[lead:]
    sp = [None] * rank
    if tail[0] % _size(mesh, data_axes) == 0:
        sp[0] = data_axes
    other = 2 if name == "conv" else 1
    if tail[other] % _size(mesh, model_axis) == 0:
        sp[other] = model_axis
    return (None,) * lead + tuple(sp)


def cache_sharding(cfg, mesh, plan: shapi.Plan, cache_specs: Any):
    """The placements of every leaf of a cache tree, by the name of its
    nearest ``KVCache`` / ``SSMCache`` field (``_cache_spec``); ``length``
    and anything unnamed are replicated."""
    def walk(node, name):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, k if k in _CACHE_RANK or k == "state"
                            else name) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, f) for f, v in
                                zip(node._fields, node)))
        return shapi.placements(
            _cache_spec(cfg, mesh, plan, name, tuple(node.shape)), mesh)

    return walk(cache_specs, None)


def train_shardings(cfg, mesh, plan: shapi.Plan, params_axes,
                    params_specs, opt_state_specs, batch_specs):
    """``((params, opt_state, batch), (params, opt_state, metrics))``
    placement trees of the train step."""
    p_sh = shapi.param_shardings(plan, mesh, params_specs, params_axes)
    o_sh = _opt_shardings(mesh, plan, params_axes, opt_state_specs, p_sh)
    b_sh = batch_sharding(mesh, plan, batch_specs)
    return (p_sh, o_sh, b_sh), (p_sh, o_sh, _replicated(mesh))


def _opt_shardings(mesh, plan, params_axes, opt_state_specs, p_sh):
    """AdamW state: count replicated; m / v placed like their
    parameters."""
    return AdamWState(count=_replicated(mesh), m=p_sh, v=p_sh)


# ---------------------------------------------------------------------------
# Train step


def _mesh_args(mesh, plan) -> bool:
    if (mesh is None) != (plan is None):
        raise ValueError("give mesh= and plan= together (or neither)")
    return mesh is not None


def _place_batch(mesh, plan, batch):
    """Plain batch leaves (the global batch, the same on every rank) as
    DTensors on the data axes: each rank keeps its own rows, nothing moves.
    DTensor leaves pass as they are."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    return shapi.placed_map(
        lambda x, pl: x if isinstance(x, DTensor) else distribute_tensor(
            x, mesh, list(pl), src_data_rank=None), batch,
        batch_sharding(mesh, plan, batch))


def _local_pieces(mesh, batch, n: int) -> list:
    """``n`` microbatches, each holding 1/n of every rank's local rows."""
    from torch.distributed.tensor import DTensor

    def split(x):
        loc = x.to_local()
        if loc.shape[0] % n:
            raise ValueError(f"{loc.shape[0]} local rows do not split into "
                             f"{n} microbatches")
        return [DTensor.from_local(piece, mesh, x.placements,
                                   run_check=False)
                for piece in loc.chunk(n, dim=0)]

    leaves, spec = tree.flatten(batch)
    per = [split(x) for x in leaves]
    return [tree.unflatten(spec, [p[k] for p in per]) for k in range(n)]


def _dist_value_and_grad(cfg, mesh, plan, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn`` over the mesh: the
    metrics plain (reduced) tensors, each gradient a DTensor placed as its
    parameter. The model gathers FSDP's shards itself, a unit at a time
    (``sharding.api.fsdp_gather``), so every FSDP gradient comes back
    reduce-scattered to its parameter's placements; the redistribute
    below is the backstop for any other."""
    from torch.distributed.tensor import DTensor

    # the backward too meets the plain tensors the forward made, and the
    # recomputed blocks gather under the same context
    with shapi.activation_context(mesh, plan):
        (value, metrics), grads = M.value_and_grad(cfg, params, batch)
    grads = tree.map(lambda g, p: g if tuple(g.placements) == tuple(
        p.placements) else g.redistribute(mesh, p.placements), grads,
        params)

    def plain(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    return (plain(value), {k: plain(v) for k, v in metrics.items()}), grads


def build_train_step(cfg, mesh=None, plan=None,
                     optimizer: Optional[AdamW] = None,
                     microbatches: int = 1):
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``:
    on one device without ``mesh`` / ``plan``; over the mesh with them
    (the module docstring)."""
    sharded = _mesh_args(mesh, plan)
    optimizer = optimizer or default_optimizer()

    def vg(params, batch):
        if sharded:
            return _dist_value_and_grad(cfg, mesh, plan, params, batch)
        return M.value_and_grad(cfg, params, batch)

    def train_step(params, opt_state, batch):
        if sharded:
            batch = _place_batch(mesh, plan, batch)
        if microbatches > 1:
            if sharded:
                mbs = _local_pieces(mesh, batch, microbatches)
            else:
                mbs = tree.map(lambda x: x.reshape(
                    (microbatches, x.shape[0] // microbatches)
                    + x.shape[1:]), batch)
                mbs = [tree.map(lambda x: x[k], mbs)
                       for k in range(microbatches)]
            gacc = tree.map(lambda p: torch.zeros_like(
                p, dtype=torch.float32) if sharded else torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lacc = 0.0
            for mb in mbs:
                (loss, _), grads = vg(params, mb)
                gacc = tree.map(
                    lambda a, g: a + g.to(torch.float32) / microbatches,
                    gacc, grads)
                lacc = lacc + loss / microbatches
            grads, metrics = gacc, {"loss": lacc}
        else:
            (loss, metrics), grads = vg(params, batch)
            metrics = dict(metrics, loss=loss)
        params, opt_state, opt_metrics = optimizer.update(grads, opt_state,
                                                          params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serve steps


def build_prefill_step(cfg, mesh=None, plan=None):
    """``fn(params, batch, caches) -> (caches, logits)``; ``batch`` holds
    the family's prefill inputs (``model.prefill``). Over a mesh the
    forward runs under ``activation_context``."""
    sharded = _mesh_args(mesh, plan)

    def prefill_step(params, batch, caches):
        if sharded:
            with shapi.activation_context(mesh, plan):
                return M.prefill(cfg, params, batch, caches)
        return M.prefill(cfg, params, batch, caches)

    return prefill_step


def build_decode_step(cfg, mesh=None, plan=None):
    """``fn(params, caches, batch) -> (caches, logits)``; ``batch`` holds
    the family's decode inputs (``model.decode_step``). Over a mesh the
    step runs under ``activation_context``."""
    sharded = _mesh_args(mesh, plan)

    def decode_step(params, caches, batch):
        if sharded:
            with shapi.activation_context(mesh, plan):
                return M.decode_step(cfg, params, caches, batch)
        return M.decode_step(cfg, params, caches, batch)

    return decode_step
