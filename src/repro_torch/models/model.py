"""Model assembly for the dense decoder-only LM (counterpart of
``repro.models.model`` for ``family == "dense"``).

    params, axes = init_model(seed, cfg)                   # or a Generator
    loss, metrics = loss_fn(cfg, params, batch)            # train
    (loss, metrics), grads = value_and_grad(cfg, params, batch)
    caches = make_caches(cfg, batch, s_max)                # serve
    caches, logits = prefill(cfg, params, batch, caches)
    caches, logits = decode_step(cfg, params, caches, batch)

``params`` is the reference's nested dict: every block parameter stacked
along a leading (n_layers, ...) axis under ``blocks``, leaves in the
reference's order (``repro_torch.tree``). ``LM`` is the same parameters
as an ``nn.Module``; ``loss_fn`` runs that module through
``torch.func.functional_call``, so any tree of tensors in this layout
(drawn here, converted from the reference, restored from a checkpoint)
goes through one forward. The blocks run one after another, indexing the
stacked leaves by layer; ``cfg.remat == "block"`` recomputes each block in
the backward pass (``torch.utils.checkpoint``), which changes no bit.
The serving entry points run under ``torch.no_grad()`` without it, and
write the caches in place (``attention.cache_update``): the caches they
return share the storage of the caches they were given.

The MoE, SSM, hybrid, enc-dec and VLM families wait for ROADMAP Queue 1;
their ``init_model`` / ``loss_fn`` / ``make_caches`` raise.
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


def dense_block_apply(cfg, p, x: Tensor, *, positions: Tensor,
                      mode: str = "train", cache=None, window=None):
    """``(x, cache)`` after one decoder block, in the weights' dtype
    whatever the cache's (``attention.attn_apply``)."""
    h = cm.norm_apply(cfg.norm, p["ln1"], x)
    o, cache = attn.attn_apply(cfg, p["attn"], h, positions=positions,
                               mode=mode, cache=cache, window=window)
    x = x + o
    h = cm.norm_apply(cfg.norm, p["ln2"], x)
    return x + cm.mlp_apply(cfg, p["mlp"], h), cache


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


def _layer_caches(caches, n: int) -> list:
    """Per-layer views of stacked caches (every field's leading axis)."""
    fields = [None if f is None else f.unbind(0) for f in caches]
    return [type(caches)(*(None if f is None else f[i] for f in fields))
            for i in range(n)]


def _scan_stack(cfg, stack_params, x: Tensor, apply_one, caches=None):
    """Apply ``apply_one(p_i, x, c_i) -> (x, c_i)`` for each layer i of the
    stacked tree, in order; ``c_i`` is layer i's view of the stacked
    ``caches`` (None in training), which the layer writes in place.
    Returns ``(x, caches)``. The leaves are unbound once, so the backward
    pass stacks each leaf's layer gradients in one go; only training
    recomputes blocks (``cfg.remat``)."""
    leaves, spec = tree.flatten(stack_params)
    layers = [leaf.unbind(0) for leaf in leaves]
    n = leaves[0].shape[0]
    if caches is None:
        body = _maybe_remat(cfg, lambda p_i, x: apply_one(p_i, x, None)[0])
        for i in range(n):
            x = body(tree.unflatten(spec, [lyr[i] for lyr in layers]), x)
        return x, None
    for i, c_i in enumerate(_layer_caches(caches, n)):
        x, _ = apply_one(tree.unflatten(spec, [lyr[i] for lyr in layers]),
                         x, c_i)
    return x, caches


def _embed_inputs(cfg, params, batch):
    """Token embedding; returns (x, positions, label_mask)."""
    tokens = batch["tokens"]
    x = cm.embed_apply(params["embed"], tokens)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions, mask


def _apply_stacks(cfg, params, x: Tensor, *, mode: str, positions: Tensor,
                  caches=None):
    """Run the block stack. Returns ``(x, caches)``."""
    _require_dense(cfg)
    window = cfg.attn_window if mode != "train" else None

    def one(p_i, x, c_i):
        return dense_block_apply(cfg, p_i, x, positions=positions,
                                 mode=mode, cache=c_i, window=window)

    return _scan_stack(cfg, params["blocks"], x, one, caches)


def units_tree(params):
    return {"ssm_stack": params["units"]}


def _loss(cfg, params, batch):
    x, positions, mask = _embed_inputs(cfg, params, batch)
    x, _ = _apply_stacks(cfg, params, x, mode="train", positions=positions)
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


# ---------------------------------------------------------------------------
# Serving


def make_caches(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
                quantized_kv: bool = False, *, device="cuda"):
    """Empty decode caches for the dense stack: one ``KVCache`` whose
    fields carry a leading (n_layers,) axis (``length`` is (n_layers,))."""
    _require_dense(cfg)
    dev = resolve_device(device)
    one = attn.make_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim_,
                          dtype, quantized=quantized_kv, device=dev)
    return type(one)(*(None if f is None else
                       f.unsqueeze(0).repeat((cfg.n_layers,) + (1,) * f.ndim)
                       for f in one))


def _logits(cfg, params, x: Tensor) -> Tensor:
    x = cm.norm_apply(cfg.norm, params["final_norm"], x)
    table = params["embed"]["table"] if cfg.tie_embeddings else \
        params["unembed"]["table"]
    return cm.unembed_logits({"table": table}, x)


@torch.no_grad()
def prefill(cfg, params, batch, caches):
    """Consume the prompt ``batch['tokens']`` (B, T), fill ``caches`` (in
    place: the returned caches share their storage) and return
    ``(caches, logits)``, the f32 logits of the last token (B, 1, V)."""
    x, positions, _ = _embed_inputs(cfg, params, batch)
    x, caches = _apply_stacks(cfg, params, x, mode="prefill",
                              positions=positions, caches=caches)
    return caches, _logits(cfg, params, x[:, -1:, :])


@torch.no_grad()
def decode_step(cfg, params, caches, batch):
    """One token: ``batch['tokens']`` (B, 1) at ``batch['position']``
    (1,), one position shared by the batch. Writes ``caches`` in place and
    returns ``(caches, logits)`` (B, 1, V) f32."""
    x = cm.embed_apply(params["embed"], batch["tokens"])
    x, caches = _apply_stacks(cfg, params, x, mode="decode",
                              positions=batch["position"], caches=caches)
    return caches, _logits(cfg, params, x)
