"""Model assembly for the dense, MoE and SSM decoder-only LMs
(counterpart of ``repro.models.model`` for ``family`` in dense, moe,
ssm).

    params, axes = init_model(seed, cfg)                   # or a Generator
    loss, metrics = loss_fn(cfg, params, batch)            # train
    (loss, metrics), grads = value_and_grad(cfg, params, batch)
    caches = make_caches(cfg, batch, s_max)                # serve
    caches, logits = prefill(cfg, params, batch, caches)
    caches, logits = decode_step(cfg, params, caches, batch)

``params`` is the reference's nested dict: every block parameter stacked
along a leading (n_layers, ...) axis under ``blocks`` (dense, ssm), or
along (n_units, ...) under ``units`` as ``sub0 .. sub{moe_every-1}``
(moe: ``moe_every - 1`` decoder blocks, then a MoE block), leaves in the
reference's order (``repro_torch.tree``). ``LM`` is the same parameters
as an ``nn.Module``; ``loss_fn`` runs that module through
``torch.func.functional_call``, so any tree of tensors in this layout
(drawn here, converted from the reference, restored from a checkpoint)
goes through one forward. The blocks (or units) run one after another,
indexing the stacked leaves; ``cfg.remat == "block"`` recomputes each in
the backward pass (``torch.utils.checkpoint``), which changes no bit. The
MoE blocks' load-balancing losses sum over the stack, and the loss adds
``1e-2`` of the sum. The serving entry points run under
``torch.no_grad()`` without remat, and write the caches in place
(``attention.cache_update``, ``ssm.ssm_apply``): the caches they return
share the storage of the caches they were given. A model whose ``rope``
is ``"none"`` (falcon-mamba) gets the reference's sinusoidal absolute
positions added to its embeddings, as the reference does.

The hybrid, enc-dec and VLM families wait for ROADMAP Queue 1 (items 4
and 5); their ``init_model`` / ``loss_fn`` / ``make_caches`` raise.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..core.operators import resolve_device
from . import attention as attn
from . import common as cm
from . import losses
from . import moe as moe_mod
from . import ssm as ssm_mod

Tensor = torch.Tensor

# the families still to port, by their ROADMAP Queue 1 item
_WAITING = {"hybrid": 4, "encdec": 5, "vlm": 5}


def _require_ported(cfg) -> None:
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family waits for ROADMAP "
            f"Queue 1 item {_WAITING[cfg.family]} (the port builds the "
            f"dense, moe and ssm families)")
    if cfg.family not in ("dense", "moe", "ssm"):
        raise ValueError(cfg.family)


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


def dense_block_init(make, cfg, dtype, kind: str = "decoder"):
    """kind: decoder | moe (the encoder and cross-decoder blocks wait for
    the enc-dec family). A MoE block keeps a ``d_ff`` MLP beside its
    experts when the config has a shared expert or a dense residual."""
    if kind not in ("decoder", "moe"):
        raise NotImplementedError(
            f"block kind {kind!r} waits for the enc-dec family (ROADMAP "
            f"Queue 1 item 5)")
    p, a = {}, {}
    p["ln1"], a["ln1"] = cm.norm_init(make, cfg.norm, cfg.d_model, dtype)
    p["attn"], a["attn"] = attn.attn_init(make, cfg, dtype)
    p["ln2"], a["ln2"] = cm.norm_init(make, cfg.norm, cfg.d_model, dtype)
    if kind == "moe":
        p["moe"], a["moe"] = moe_mod.moe_init(make, cfg, dtype)
        if cfg.moe_shared_expert or cfg.moe_dense_residual:
            p["mlp"], a["mlp"] = cm.mlp_init(make, cfg, cfg.d_ff, dtype)
    else:
        p["mlp"], a["mlp"] = cm.mlp_init(make, cfg, cfg.d_ff, dtype)
    return p, a


def dense_block_apply(cfg, p, x: Tensor, *, positions: Tensor,
                      mode: str = "train", cache=None, window=None):
    """``(x, cache, aux)`` after one decoder or MoE block, in the weights'
    dtype whatever the cache's (``attention.attn_apply``). ``aux`` is the
    MoE block's load-balancing loss, 0.0 for a decoder block; the experts
    run dropless in decode."""
    aux = 0.0
    h = cm.norm_apply(cfg.norm, p["ln1"], x)
    o, cache = attn.attn_apply(cfg, p["attn"], h, positions=positions,
                               mode=mode, cache=cache, window=window)
    x = x + o
    h = cm.norm_apply(cfg.norm, p["ln2"], x)
    if "moe" in p:
        o, aux = moe_mod.moe_apply(cfg, p["moe"], h,
                                   dropless=(mode == "decode"))
        if "mlp" in p:   # the shared expert / the dense residual
            o = o + cm.mlp_apply(cfg, p["mlp"], h)
    else:
        o = cm.mlp_apply(cfg, p["mlp"], h)
    return x + o, cache, aux


def ssm_block_init(make, cfg, dtype):
    p, a = {}, {}
    p["ln"], a["ln"] = cm.norm_init(make, cfg.norm, cfg.d_model, dtype)
    p["ssm"], a["ssm"] = ssm_mod.ssm_init(make, cfg, dtype)
    return p, a


def ssm_block_apply(cfg, p, x: Tensor, *, mode: str, cache=None):
    """``(x, cache)`` after one Mamba block (the cache written in
    place)."""
    h = cm.norm_apply(cfg.norm, p["ln"], x)
    o, cache = ssm_mod.ssm_apply(cfg, p["ssm"], h, mode=mode, cache=cache)
    return x + o, cache


def _moe_kinds(cfg) -> list:
    return ["decoder"] * (cfg.moe_every - 1) + ["moe"]


def _build(cfg, make):
    _require_ported(cfg)
    dtype = cm._dtype(cfg.dtype)
    p: dict = {}
    a: dict = {}
    p["embed"], a["embed"] = cm.embed_init(make, cfg.vocab, cfg.d_model,
                                           dtype)
    p["final_norm"], a["final_norm"] = cm.norm_init(make, cfg.norm,
                                                    cfg.d_model, dtype)
    if cfg.family == "dense":
        p["blocks"], a["blocks"] = stack_init(
            make, cfg.n_layers, lambda mk: dense_block_init(mk, cfg, dtype))
    elif cfg.family == "moe":
        kinds = _moe_kinds(cfg)
        assert cfg.n_layers % len(kinds) == 0, (cfg.n_layers, len(kinds))

        def unit_init(mk):
            ps, as_ = {}, {}
            for i, kind in enumerate(kinds):
                ps[f"sub{i}"], as_[f"sub{i}"] = dense_block_init(
                    mk, cfg, dtype, kind=kind)
            return ps, as_

        p["units"], a["units"] = stack_init(
            make, cfg.n_layers // len(kinds), unit_init)
    else:
        p["blocks"], a["blocks"] = stack_init(
            make, cfg.n_layers, lambda mk: ssm_block_init(mk, cfg, dtype))
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
        if scale == "log_arange":
            n = shape[-1]
            return torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                          device=dev)).expand(shape).to(
                dtype).clone()
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
    _require_ported(cfg)
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
    """Per-layer views of stacked caches (a cache tuple or a dict of them;
    every leaf's leading axis)."""
    leaves, spec = tree.flatten(caches)
    per = [leaf.unbind(0) for leaf in leaves]
    return [tree.unflatten(spec, [f[i] for f in per]) for i in range(n)]


def _scan_stack(cfg, stack_params, x: Tensor, apply_one, caches=None):
    """Apply ``apply_one(p_i, x, c_i) -> (x, c_i, aux)`` for each layer (or
    unit) i of the stacked tree, in order; ``c_i`` is its view of the
    stacked ``caches`` (None in training), which it writes in place.
    Returns ``(x, caches, aux)``, aux summed over the stack (0.0 where no
    layer has one). The leaves are unbound once, so the backward pass
    stacks each leaf's layer gradients in one go; only training
    recomputes blocks (``cfg.remat``)."""
    leaves, spec = tree.flatten(stack_params)
    layers = [leaf.unbind(0) for leaf in leaves]
    n = leaves[0].shape[0]
    aux = 0.0
    if caches is None:
        # (x, aux) of a layer: its cache is None
        body = _maybe_remat(cfg, lambda p_i, x: apply_one(p_i, x, None)[::2])
        for i in range(n):
            x, a_i = body(tree.unflatten(spec, [lyr[i] for lyr in layers]),
                          x)
            aux = aux + a_i
        return x, None, aux
    for i, c_i in enumerate(_layer_caches(caches, n)):
        x, _, a_i = apply_one(
            tree.unflatten(spec, [lyr[i] for lyr in layers]), x, c_i)
        aux = aux + a_i
    return x, caches, aux


def _sinusoid(t: int, d: int, offset=0, device=None) -> Tensor:
    """(t, d) f32 sinusoidal absolute positions from ``offset`` (an int or
    a device tensor: decode reads no position back to the host)."""
    pos = (torch.arange(t, device=device) + offset)[:, None].to(
        torch.float32)
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros((t, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: (d + 1) // 2])
    return pe


def _embed_inputs(cfg, params, batch):
    """Token embedding; returns (x, positions, label_mask)."""
    tokens = batch["tokens"]
    x = cm.embed_apply(params["embed"], tokens)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.rope == "none":   # sinusoidal absolute positions
        x = x + _sinusoid(x.shape[1], x.shape[2],
                          device=x.device).to(x.dtype)
    return x, positions, mask


def _apply_stacks(cfg, params, x: Tensor, *, mode: str, positions: Tensor,
                  caches=None):
    """Run the block stack. Returns ``(x, caches, aux)``."""
    _require_ported(cfg)
    window = cfg.attn_window if mode != "train" else None

    if cfg.family == "dense":
        def one(p_i, x, c_i):
            return dense_block_apply(cfg, p_i, x, positions=positions,
                                     mode=mode, cache=c_i, window=window)

        return _scan_stack(cfg, params["blocks"], x, one, caches)

    if cfg.family == "moe":
        n_sub = len(_moe_kinds(cfg))

        def one(p_u, x, c_u):
            aux = 0.0
            for i in range(n_sub):
                x, _, a_i = dense_block_apply(
                    cfg, p_u[f"sub{i}"], x, positions=positions, mode=mode,
                    cache=None if c_u is None else c_u[f"sub{i}"],
                    window=window)
                aux = aux + a_i
            return x, c_u, aux

        return _scan_stack(cfg, params["units"], x, one, caches)

    def one(p_i, x, c_i):
        return ssm_block_apply(cfg, p_i, x, mode=mode, cache=c_i) + (0.0,)

    return _scan_stack(cfg, params["blocks"], x, one, caches)


def units_tree(params):
    return {"ssm_stack": params["units"]}


def _loss(cfg, params, batch):
    x, positions, mask = _embed_inputs(cfg, params, batch)
    x, _, aux = _apply_stacks(cfg, params, x, mode="train",
                              positions=positions)
    x = cm.norm_apply(cfg.norm, params["final_norm"], x)
    table = params["embed"]["table"] if cfg.tie_embeddings else \
        params["unembed"]["table"]
    loss, metrics = losses.chunked_cross_entropy(
        x, table, batch["labels"], chunk=cfg.logits_chunk, mask=mask)
    if isinstance(aux, Tensor):
        loss = loss + 1e-2 * aux
    else:   # no MoE block (the reference adds its 0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    metrics["aux"] = aux
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
    """The LM as a module: ``LM(cfg, params)(batch) -> (loss,
    metrics)``, its parameters the tensors of ``params`` (shared, not
    copied) under the reference's nested names."""

    def __init__(self, cfg, params):
        super().__init__()
        _require_ported(cfg)
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
    _require_ported(cfg)
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


def _stacked(n: int, one):
    """``one`` (a cache tuple) with every leaf repeated along a new leading
    (n,) axis."""
    return tree.map(lambda f: f.unsqueeze(0).repeat((n,) + (1,) * f.ndim),
                    one)


def make_caches(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
                quantized_kv: bool = False, *, device="cuda"):
    """Empty decode caches matching the stack, every leaf with a leading
    layer (or unit) axis: dense, one ``KVCache`` (``length`` is
    (n_layers,)); moe, ``{"sub{i}": KVCache}`` over (n_units,); ssm, one
    ``SSMCache`` (the conv carry in ``dtype``, the state f32)."""
    _require_ported(cfg)
    dev = resolve_device(device)

    def kv():
        return attn.make_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim_,
                               dtype, quantized=quantized_kv, device=dev)

    if cfg.family == "dense":
        return _stacked(cfg.n_layers, kv())
    if cfg.family == "moe":
        n_sub = len(_moe_kinds(cfg))
        return {f"sub{i}": _stacked(cfg.n_layers // n_sub, kv())
                for i in range(n_sub)}
    return _stacked(cfg.n_layers, ssm_mod.make_ssm_cache(cfg, batch, dtype,
                                                         device=dev))


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
    x, caches, _ = _apply_stacks(cfg, params, x, mode="prefill",
                                 positions=positions, caches=caches)
    return caches, _logits(cfg, params, x[:, -1:, :])


@torch.no_grad()
def decode_step(cfg, params, caches, batch):
    """One token: ``batch['tokens']`` (B, 1) at ``batch['position']``
    (1,), one position shared by the batch. Writes ``caches`` in place and
    returns ``(caches, logits)`` (B, 1, V) f32."""
    x = cm.embed_apply(params["embed"], batch["tokens"])
    pos = batch["position"]
    if cfg.rope == "none":
        x = x + _sinusoid(1, x.shape[2], offset=pos.reshape(-1)[0],
                          device=x.device).to(x.dtype)
    x, caches, _ = _apply_stacks(cfg, params, x, mode="decode",
                                 positions=pos, caches=caches)
    return caches, _logits(cfg, params, x)
