"""Model assembly: decoder-only LM, MoE LM, SSM LM, hybrid, enc-dec, VLM
(counterpart of ``repro.models.model``).

    params, axes = init_model(seed, cfg)                   # or a Generator
    loss, metrics = loss_fn(cfg, params, batch)            # train
    (loss, metrics), grads = value_and_grad(cfg, params, batch)
    caches = make_caches(cfg, batch, s_max)                # serve
    caches, logits = prefill(cfg, params, batch, caches)
    caches, logits = decode_step(cfg, params, caches, batch)

``params`` is the reference's nested dict: every block parameter stacked
along a leading (n_layers, ...) axis under ``blocks`` (dense, ssm, vlm;
encdec's cross-attending decoder, beside ``enc_blocks`` and
``enc_norm``), or along (n_units, ...) under ``units``: moe, as
``sub0 .. sub{moe_every-1}`` (``moe_every - 1`` decoder blocks, then a
MoE block); hybrid, Mamba blocks stacked twice (n_units,
hybrid_attn_every, ...), with ``tail`` the Mamba blocks past the last
unit and ``shared_attn`` ONE decoder block that closes every unit with
the same parameters (zamba2). Leaves come in the reference's order
(``repro_torch.tree``). ``LM`` is the same parameters as an
``nn.Module``; ``loss_fn`` runs that module through
``torch.func.functional_call``, so any tree of tensors in this layout
(drawn here, converted from the reference, restored from a checkpoint)
goes through one forward. The blocks (or units) run one after another,
indexing the stacked leaves; ``cfg.remat == "block"`` recomputes each in
the backward pass (``torch.utils.checkpoint``), which changes no bit. The
MoE blocks' load-balancing losses sum over the stack, and the loss adds
``1e-2`` of the sum. The serving entry points run under
``torch.no_grad()`` without remat, and write the caches in place
(``attention.cache_update``, ``ssm.ssm_apply``): the caches they return
share the storage of the caches they were given. Each hybrid unit keeps
its own KV cache for the shared block. A model whose ``rope`` is
``"none"`` (whisper, and falcon-mamba too) gets the reference's
sinusoidal absolute positions added to its embeddings.

Enc-dec (whisper): ``_encode`` runs the encoder over the frame
embeddings ``batch["frames"]`` (B, S, d), non-causally. ``loss_fn`` and
``prefill`` encode the frames themselves; ``decode_step`` takes
``batch["enc_memory"]``, which the caller computes with ``_encode``, and
each decoder layer projects its cross k / v from it at every step, as
the reference does. VLM (qwen2-vl): ``batch["vision_embeds"]`` (B, Tv,
d) go before the token embeddings, ``batch["positions"]`` (B, 3, Tv + T)
are the M-RoPE streams (a decode step's ``position`` is (B, 3, 1)), and
the loss ignores the vision positions.
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

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"model builds {FAMILIES}")


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
    """kind: decoder | encoder | cross-decoder | moe. A cross-decoder block
    adds a norm and an attention over the encoder's memory (``lnx``,
    ``xattn``); a MoE block keeps a ``d_ff`` MLP beside its experts when
    the config has a shared expert or a dense residual."""
    if kind not in ("decoder", "encoder", "cross-decoder", "moe"):
        raise ValueError(f"block kind {kind!r}")
    p, a = {}, {}
    p["ln1"], a["ln1"] = cm.norm_init(make, cfg.norm, cfg.d_model, dtype)
    p["attn"], a["attn"] = attn.attn_init(make, cfg, dtype)
    p["ln2"], a["ln2"] = cm.norm_init(make, cfg.norm, cfg.d_model, dtype)
    if kind == "cross-decoder":
        p["lnx"], a["lnx"] = cm.norm_init(make, cfg.norm, cfg.d_model, dtype)
        p["xattn"], a["xattn"] = attn.attn_init(make, cfg, dtype)
    if kind == "moe":
        p["moe"], a["moe"] = moe_mod.moe_init(make, cfg, dtype)
        if cfg.moe_shared_expert or cfg.moe_dense_residual:
            p["mlp"], a["mlp"] = cm.mlp_init(make, cfg, cfg.d_ff, dtype)
    else:
        p["mlp"], a["mlp"] = cm.mlp_init(make, cfg, cfg.d_ff, dtype)
    return p, a


def dense_block_apply(cfg, p, x: Tensor, *, positions: Tensor,
                      mode: str = "train", cache=None, cross_kv=None,
                      window=None):
    """``(x, cache, aux)`` after one block, in the weights' dtype whatever
    the cache's (``attention.attn_apply``). A cross-decoder block then
    attends ``cross_kv`` (the encoder memory's k / v), unwindowed. ``aux``
    is the MoE block's load-balancing loss, 0.0 for the others; the
    experts run dropless in decode."""
    aux = 0.0
    h = cm.norm_apply(cfg.norm, p["ln1"], x)
    o, cache = attn.attn_apply(cfg, p["attn"], h, positions=positions,
                               mode=mode, cache=cache, window=window)
    x = x + o
    if "xattn" in p:
        h = cm.norm_apply(cfg.norm, p["lnx"], x)
        o, _ = attn.attn_apply(cfg, p["xattn"], h, positions=positions,
                               mode="cross", cross_kv=cross_kv)
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


def _hybrid_shape(cfg) -> tuple:
    """(n_units, k_unit, tail): units of ``hybrid_attn_every`` Mamba blocks
    and the shared block, then ``tail`` Mamba blocks."""
    k_unit = cfg.hybrid_attn_every
    n_units = cfg.n_layers // k_unit
    return n_units, k_unit, cfg.n_layers - n_units * k_unit


def _build(cfg, make):
    _check_family(cfg)
    dtype = cm._dtype(cfg.dtype)
    p: dict = {}
    a: dict = {}
    p["embed"], a["embed"] = cm.embed_init(make, cfg.vocab, cfg.d_model,
                                           dtype)
    p["final_norm"], a["final_norm"] = cm.norm_init(make, cfg.norm,
                                                    cfg.d_model, dtype)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        p["blocks"], a["blocks"] = stack_init(
            make, cfg.n_layers, lambda mk: dense_block_init(mk, cfg, dtype))
    elif fam == "moe":
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
    elif fam == "ssm":
        p["blocks"], a["blocks"] = stack_init(
            make, cfg.n_layers, lambda mk: ssm_block_init(mk, cfg, dtype))
    elif fam == "hybrid":
        n_units, k_unit, tail = _hybrid_shape(cfg)

        def mamba(mk):
            return ssm_block_init(mk, cfg, dtype)

        p["units"], a["units"] = stack_init(
            make, n_units, lambda mk: stack_init(mk, k_unit, mamba))
        if tail:
            p["tail"], a["tail"] = stack_init(make, tail, mamba)
        # ONE parameter-shared attention block (zamba2)
        p["shared_attn"], a["shared_attn"] = dense_block_init(make, cfg,
                                                              dtype)
    else:   # encdec
        p["enc_blocks"], a["enc_blocks"] = stack_init(
            make, cfg.enc_layers,
            lambda mk: dense_block_init(mk, cfg, dtype, kind="encoder"))
        p["blocks"], a["blocks"] = stack_init(
            make, cfg.n_layers,
            lambda mk: dense_block_init(mk, cfg, dtype,
                                        kind="cross-decoder"))
        p["enc_norm"], a["enc_norm"] = cm.norm_init(make, cfg.norm,
                                                    cfg.d_model, dtype)
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
    _check_family(cfg)
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
    if cfg.remat == "block" and torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    return fn


def _layer_caches(caches, n: int) -> list:
    """Per-layer views of stacked caches (a cache tuple or a dict of them;
    every leaf's leading axis)."""
    leaves, spec = tree.flatten(caches)
    per = [leaf.unbind(0) for leaf in leaves]
    return [tree.unflatten(spec, [f[i] for f in per]) for i in range(n)]


def _scan_stack(cfg, stack_params, x: Tensor, apply_one, caches=None, *,
                remat: bool = True):
    """Apply ``apply_one(p_i, x, c_i) -> (x, c_i, aux)`` for each layer (or
    unit) i of the stacked tree, in order; ``c_i`` is its view of the
    stacked ``caches`` (None in training), which it writes in place.
    Returns ``(x, caches, aux)``, aux summed over the stack (0.0 where no
    layer has one). The leaves are unbound once, so the backward pass
    stacks each leaf's layer gradients in one go; only training
    recomputes blocks (``cfg.remat``; ``remat=False`` for a stack inside
    a block that is recomputed already)."""
    leaves, spec = tree.flatten(stack_params)
    layers = [leaf.unbind(0) for leaf in leaves]
    n = leaves[0].shape[0]
    aux = 0.0
    if caches is None:
        # (x, aux) of a layer: its cache is None
        def body(p_i, x):
            return apply_one(p_i, x, None)[::2]

        if remat:
            body = _maybe_remat(cfg, body)
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


def _need(batch, key: str, cfg, what: str):
    if key not in batch:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs "
                         f"batch[{key!r}] ({what})")
    return batch[key]


def _embed_inputs(cfg, params, batch):
    """Token (and vision) embedding; returns (x, positions,
    label_mask)."""
    tokens = batch["tokens"]
    x = cm.embed_apply(params["embed"], tokens)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=x.device)
    if cfg.family == "vlm":
        vis = _need(batch, "vision_embeds", cfg, "(B, Tv, d) patch "
                    "embeddings").to(x.dtype)
        x = torch.cat([vis, x], dim=1)
        mask = torch.cat([torch.zeros(vis.shape[:2], dtype=torch.float32,
                                      device=x.device), mask], dim=1)
        positions = _need(batch, "positions", cfg,
                          "(B, 3, Tv + T) M-RoPE ids")
    else:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.rope == "none":   # sinusoidal absolute positions
        x = x + _sinusoid(x.shape[1], x.shape[2],
                          device=x.device).to(x.dtype)
    return x, positions, mask


def _cross_kv(cfg, p_i, enc_memory: Tensor) -> tuple:
    """A cross-decoder layer's k / v (B, S, Hkv, D): its ``xattn``
    projections (biases included) of the encoder memory."""
    return tuple(attn._split_heads(cm.dense_apply(p_i["xattn"][w],
                                                  enc_memory),
                                   cfg.n_kv_heads) for w in ("wk", "wv"))


def _apply_stacks(cfg, params, x: Tensor, *, mode: str, positions: Tensor,
                  caches=None, enc_memory=None):
    """Run the block stack. Returns ``(x, caches, aux)``."""
    _check_family(cfg)
    fam = cfg.family
    window = cfg.attn_window if mode != "train" else None

    if fam in ("dense", "vlm", "encdec"):
        if fam == "encdec" and enc_memory is None:
            raise ValueError(f"{cfg.name}: the decoder attends the "
                             f"encoder's memory; give enc_memory")

        def one(p_i, x, c_i):
            cross_kv = _cross_kv(cfg, p_i, enc_memory) \
                if fam == "encdec" else None
            return dense_block_apply(cfg, p_i, x, positions=positions,
                                     mode=mode, cache=c_i,
                                     cross_kv=cross_kv, window=window)

        return _scan_stack(cfg, params["blocks"], x, one, caches)

    if fam == "moe":
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

    def mamba(p_i, x, c_i):
        return ssm_block_apply(cfg, p_i, x, mode=mode, cache=c_i) + (0.0,)

    if fam == "ssm":
        return _scan_stack(cfg, params["blocks"], x, mamba, caches)

    # hybrid: each unit runs its k_unit Mamba blocks, then the ONE shared
    # attention block with the unit's own KV cache
    shared = params["shared_attn"]

    def unit_one(p_u, x, c_u):
        x, _, _ = _scan_stack(cfg, p_u["ssm_stack"], x, mamba,
                              None if c_u is None else c_u["ssm"],
                              remat=False)
        return dense_block_apply(cfg, shared, x, positions=positions,
                                 mode=mode,
                                 cache=None if c_u is None else c_u["attn"],
                                 window=window)

    x, _, aux = _scan_stack(cfg, units_tree(params), x, unit_one,
                            None if caches is None else caches["units"])
    if "tail" in params:
        x, _, a2 = _scan_stack(cfg, params["tail"], x, mamba,
                               None if caches is None else caches["tail"])
        aux = aux + a2
    return x, caches, aux


def units_tree(params):
    """The hybrid's units as the stacked tree the unit loop reads: the
    (n_units, k_unit, ...) Mamba blocks under ``ssm_stack``."""
    return {"ssm_stack": params["units"]}


def _encode(cfg, params, frames: Tensor) -> Tensor:
    """The whisper encoder over stub frame embeddings (B, S, d): the
    sinusoidal positions added, the encoder blocks run non-causally and
    unwindowed, then ``enc_norm``."""
    x = frames
    if cfg.rope == "none":
        x = x + _sinusoid(x.shape[1], x.shape[2],
                          device=x.device).to(x.dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]

    def one(p_i, x, c_i):
        return dense_block_apply(cfg, p_i, x, positions=pos, mode="encoder")

    x, _, _ = _scan_stack(cfg, params["enc_blocks"], x, one)
    return cm.norm_apply(cfg.norm, params["enc_norm"], x)


def _enc_memory(cfg, params, batch):
    """The encoder's memory of ``batch["frames"]`` (cast to the model's
    dtype) for an enc-dec model, else None."""
    if not cfg.is_encdec:
        return None
    frames = _need(batch, "frames", cfg, "(B, S, d) frame embeddings")
    return _encode(cfg, params, frames.to(cm._dtype(cfg.dtype)))


def _loss(cfg, params, batch):
    enc_memory = _enc_memory(cfg, params, batch)
    x, positions, mask = _embed_inputs(cfg, params, batch)
    x, _, aux = _apply_stacks(cfg, params, x, mode="train",
                              positions=positions, enc_memory=enc_memory)
    x = cm.norm_apply(cfg.norm, params["final_norm"], x)
    table = params["embed"]["table"] if cfg.tie_embeddings else \
        params["unembed"]["table"]
    labels = batch["labels"]
    if cfg.family == "vlm":
        # labels cover the text positions; the vision ones get label 0
        # (masked out)
        tv = x.shape[1] - labels.shape[1]
        labels = torch.cat([torch.zeros((labels.shape[0], tv),
                                        dtype=labels.dtype,
                                        device=labels.device), labels],
                           dim=1)
    loss, metrics = losses.chunked_cross_entropy(
        x, table, labels, chunk=cfg.logits_chunk, mask=mask)
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
        _check_family(cfg)
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
    holds, by family: dense / moe / ssm / hybrid ``tokens``, ``labels``
    (B, T); vlm also ``vision_embeds`` (B, Tv, d) and ``positions`` (B,
    3, Tv + T); encdec also ``frames`` (B, S, d)."""
    _check_family(cfg)
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
    layer (or unit) axis: dense, vlm and encdec (the decoder's
    self-attention), one ``KVCache`` (``length`` is (n_layers,)); moe,
    ``{"sub{i}": KVCache}`` over (n_units,); ssm, one ``SSMCache`` (the
    conv carry in ``dtype``, the state f32); hybrid, ``{"units": {"attn":
    KVCache (n_units, ...), "ssm": SSMCache (n_units, k_unit, ...)},
    "tail": SSMCache (tail, ...)}``, one KV cache a unit for the shared
    block (no ``tail`` when the units fill the stack)."""
    _check_family(cfg)
    dev = resolve_device(device)

    def kv():
        return attn.make_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim_,
                               dtype, quantized=quantized_kv, device=dev)

    fam = cfg.family
    if fam in ("dense", "vlm", "encdec"):
        return _stacked(cfg.n_layers, kv())
    if fam == "moe":
        n_sub = len(_moe_kinds(cfg))
        return {f"sub{i}": _stacked(cfg.n_layers // n_sub, kv())
                for i in range(n_sub)}
    mamba = ssm_mod.make_ssm_cache(cfg, batch, dtype, device=dev)
    if fam == "ssm":
        return _stacked(cfg.n_layers, mamba)
    n_units, k_unit, tail = _hybrid_shape(cfg)
    out = {"units": {"attn": _stacked(n_units, kv()),
                     "ssm": _stacked(n_units, _stacked(k_unit, mamba))}}
    if tail:
        out["tail"] = _stacked(tail, mamba)
    return out


def _logits(cfg, params, x: Tensor) -> Tensor:
    x = cm.norm_apply(cfg.norm, params["final_norm"], x)
    table = params["embed"]["table"] if cfg.tie_embeddings else \
        params["unembed"]["table"]
    return cm.unembed_logits({"table": table}, x)


@torch.no_grad()
def prefill(cfg, params, batch, caches):
    """Consume the prompt ``batch['tokens']`` (B, T) (a VLM's after its
    ``vision_embeds``; an enc-dec model encodes ``batch['frames']``
    first), fill ``caches`` (in place: the returned caches share their
    storage) and return ``(caches, logits)``, the f32 logits of the last
    token (B, 1, V). The encoder's memory is not returned: a decode step
    takes it from the caller, as the reference's does."""
    enc_memory = _enc_memory(cfg, params, batch)
    x, positions, _ = _embed_inputs(cfg, params, batch)
    x, caches, _ = _apply_stacks(cfg, params, x, mode="prefill",
                                 positions=positions, caches=caches,
                                 enc_memory=enc_memory)
    return caches, _logits(cfg, params, x[:, -1:, :])


@torch.no_grad()
def decode_step(cfg, params, caches, batch):
    """One token: ``batch['tokens']`` (B, 1) at ``batch['position']``,
    (1,) shared by the batch, or (B, 3, 1) M-RoPE ids for a VLM; an
    enc-dec model also takes ``batch['enc_memory']`` (B, S, d). Writes
    ``caches`` in place and returns ``(caches, logits)`` (B, 1, V) f32."""
    enc_memory = _need(batch, "enc_memory", cfg, "the encoder's memory, "
                       "from _encode") if cfg.is_encdec else None
    x = cm.embed_apply(params["embed"], batch["tokens"])
    pos = batch["position"]
    if cfg.rope == "none":
        x = x + _sinusoid(1, x.shape[2], offset=pos.reshape(-1)[0],
                          device=x.device).to(x.dtype)
    x, caches, _ = _apply_stacks(cfg, params, x, mode="decode",
                                 positions=pos, caches=caches,
                                 enc_memory=enc_memory)
    return caches, _logits(cfg, params, x)
