"""Model assembly for the dense decoder-only LM (counterpart of the train
path of ``repro.models.model``).

    params, axes = init_model(seed, cfg)                   # or a Generator
    loss, metrics = loss_fn(cfg, params, batch)            # train
    (loss, metrics), grads = value_and_grad(cfg, params, batch)

``params`` is the reference's nested dict: every block parameter stacked
along a leading (n_layers, ...) axis under ``blocks``, leaves in the
reference's order (``repro_torch.tree``). ``LM`` is the same parameters
as an ``nn.Module``; ``loss_fn`` runs that module through
``torch.func.functional_call``, so any tree of tensors in this layout
(drawn here, converted from the reference, restored from a checkpoint)
goes through one forward. The blocks run one after another, indexing the
stacked leaves by layer; ``cfg.remat == "block"`` recomputes each block in
the backward pass (``torch.utils.checkpoint``), which changes no bit.

The MoE, SSM, hybrid, enc-dec and VLM families wait for ROADMAP Queue 1;
their ``init_model`` / ``loss_fn`` raise.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..core.operators import resolve_device
from . import attention as attn
from . import common as cm
from . import losses

Tensor = torch.Tensor


def _require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family waits for ROADMAP "
            f"Queue 1 (the port builds the dense family so far)")


# ---------------------------------------------------------------------------
# Init


def _prefix_axes(axes):
    if isinstance(axes, dict):
        return {k: _prefix_axes(v) for k, v in axes.items()}
    return ("layers",) + tuple(axes)


def stack_init(make, n: int, init_fn):
    """``init_fn(make)`` with every leaf stacked along a leading (n,) axis
    (drawn in one go; the fan-in stays the per-layer one) and every axes
    tuple prefixed with 'layers'."""
    def stacked(shape, fan_in, scale, dtype):
        return make((n,) + tuple(shape), fan_in, scale, dtype)

    p, a = init_fn(stacked)
    return p, _prefix_axes(a)


def dense_block_init(make, cfg, dtype):
    """A decoder block (the cross-attention and MoE blocks wait for their
    families)."""
    p, a = {}, {}
    p["ln1"], a["ln1"] = cm.norm_init(make, cfg.norm, cfg.d_model, dtype)
    p["attn"], a["attn"] = attn.attn_init(make, cfg, dtype)
    p["ln2"], a["ln2"] = cm.norm_init(make, cfg.norm, cfg.d_model, dtype)
    p["mlp"], a["mlp"] = cm.mlp_init(make, cfg, cfg.d_ff, dtype)
    return p, a


def dense_block_apply(cfg, p, x: Tensor, *, positions: Tensor):
    h = cm.norm_apply(cfg.norm, p["ln1"], x)
    x = x + attn.attn_apply(cfg, p["attn"], h, positions=positions)
    h = cm.norm_apply(cfg.norm, p["ln2"], x)
    return x + cm.mlp_apply(cfg, p["mlp"], h)


def _build(cfg, make):
    _require_dense(cfg)
    dtype = cm._dtype(cfg.dtype)
    p: dict = {}
    a: dict = {}
    p["embed"], a["embed"] = cm.embed_init(make, cfg.vocab, cfg.d_model,
                                           dtype)
    p["final_norm"], a["final_norm"] = cm.norm_init(make, cfg.norm,
                                                    cfg.d_model, dtype)
    p["blocks"], a["blocks"] = stack_init(
        make, cfg.n_layers, lambda mk: dense_block_init(mk, cfg, dtype))
    if not cfg.tie_embeddings:
        p["unembed"], a["unembed"] = cm.embed_init(make, cfg.vocab,
                                                   cfg.d_model, dtype)
    return p, a


def _drawer(generator: torch.Generator):
    dev = generator.device

    def make(shape, fan_in, scale, dtype):
        if scale == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        if scale == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        return cm.trunc_normal(generator, shape, scale, dtype, fan_in)

    return make


def _meta(shape, fan_in, scale, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def init_model(key, cfg, *, device="cuda"):
    """``(params, axes)`` for ``cfg``. ``key`` is an int seed (a generator
    on ``device`` seeded with it) or a ``torch.Generator``, whose device
    then holds the parameters. The draws follow the reference's
    distributions, not its bits: parity starts from the reference's
    parameters through ``convert.params_from_numpy``."""
    _require_dense(cfg)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(key))
    return _build(cfg, _drawer(gen))


def param_skeleton(cfg):
    """The parameter tree of ``cfg`` as empty tensors on the meta device
    (shapes and dtypes; nothing allocated)."""
    return _build(cfg, _meta)[0]


# ---------------------------------------------------------------------------
# The blocks, layer by layer


def _maybe_remat(cfg, fn):
    if cfg.remat == "block":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    return fn


def _scan_stack(cfg, stack_params, x: Tensor, apply_one) -> Tensor:
    """Apply ``apply_one(p_i, x) -> x`` for each layer i of the stacked
    tree, in order. The leaves are unbound once, so the backward pass
    stacks each leaf's layer gradients in one go."""
    leaves, spec = tree.flatten(stack_params)
    layers = [leaf.unbind(0) for leaf in leaves]
    body = _maybe_remat(cfg, apply_one)
    for i in range(leaves[0].shape[0]):
        x = body(tree.unflatten(spec, [lyr[i] for lyr in layers]), x)
    return x


def _embed_inputs(cfg, params, batch):
    """Token embedding; returns (x, positions, label_mask)."""
    tokens = batch["tokens"]
    x = cm.embed_apply(params["embed"], tokens)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions, mask


def _apply_stacks(cfg, params, x: Tensor, *, positions: Tensor) -> Tensor:
    """Run the block stack of a training step."""
    _require_dense(cfg)

    def one(p_i, x):
        return dense_block_apply(cfg, p_i, x, positions=positions)

    return _scan_stack(cfg, params["blocks"], x, one)


def units_tree(params):
    return {"ssm_stack": params["units"]}


def _loss(cfg, params, batch):
    x, positions, mask = _embed_inputs(cfg, params, batch)
    x = _apply_stacks(cfg, params, x, positions=positions)
    x = cm.norm_apply(cfg.norm, params["final_norm"], x)
    table = params["embed"]["table"] if cfg.tie_embeddings else \
        params["unembed"]["table"]
    loss, metrics = losses.chunked_cross_entropy(
        x, table, batch["labels"], chunk=cfg.logits_chunk, mask=mask)
    # a dense stack has no auxiliary loss (the reference adds its 0 too)
    metrics["aux"] = torch.zeros((), dtype=torch.float32, device=x.device)
    return loss, metrics


# ---------------------------------------------------------------------------
# The module and the functional entry points


def _module_of(node) -> nn.Module:
    m = nn.Module()
    for k, v in node.items():
        if isinstance(v, dict):
            m.add_module(k, _module_of(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _tree_of(m: nn.Module):
    out = {name: _tree_of(child) for name, child in m.named_children()}
    out.update(m.named_parameters(recurse=False))
    return out


def _dotted(node, prefix: str) -> dict:
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}.{k}"))
        else:
            out[f"{prefix}.{k}"] = v
    return out


class LM(nn.Module):
    """The dense LM as a module: ``LM(cfg, params)(batch) -> (loss,
    metrics)``, its parameters the tensors of ``params`` (shared, not
    copied) under the reference's nested names."""

    def __init__(self, cfg, params):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.params = _module_of(params)

    def tree(self):
        """The parameters as the reference's nested dict."""
        return _tree_of(self.params)

    def forward(self, batch):
        return _loss(self.cfg, self.tree(), batch)


@functools.lru_cache(maxsize=16)
def _skeleton(cfg) -> LM:
    return LM(cfg, param_skeleton(cfg))


def loss_fn(cfg, params, batch):
    """Training forward and chunked CE: ``(loss, metrics)``. ``batch``
    holds ``tokens`` and ``labels`` (B, T)."""
    _require_dense(cfg)
    return torch.func.functional_call(_skeleton(cfg),
                                      _dotted(params, "params"), (batch,))


def value_and_grad(cfg, params, batch, loss=loss_fn):
    """``((loss, metrics), grads)`` of ``loss(cfg, params, batch)``, the
    gradients a tree like ``params`` in the parameters' dtypes. The
    parameters are read through detached views: nothing is copied, and
    ``params`` itself stays outside the graph."""
    leaves, spec = tree.flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    value, metrics = loss(cfg, tree.unflatten(spec, xs), batch)
    grads = torch.autograd.grad(value, xs)
    return ((value.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree.unflatten(spec, list(grads)))
