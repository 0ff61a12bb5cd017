"""GQA attention in plain PyTorch (counterpart of
``repro.models.attention``): the training, prefill, decode, encoder and
cross-attention modes.

``full``     materialises (T, S) scores in f32;
``chunked``  loops over query tiles, O(bq * S) live scores a tile;
``decode``   one query against a (possibly int8) KV cache.

All contract grouped queries against un-replicated KV, as the reference
does; none goes through a fused attention call, because the reference
computes none. Sliding-window masking applies in all three.

The reference's ``cache_update`` is functional. Here the cache buffers
are written in place (``index_copy_``, or the one-hot select copied
back), and ``length`` grows in place: a functional copy of the whole
cache a step would cost more than the rest of a decode step's bytes.
The ``'encoder'`` and ``'cross'`` modes (whisper) attend without a causal
mask, as the reference's do; ``'cross'`` takes its k / v as given and
rotates nothing. ``rope`` is ``"rope"``, ``"mrope"`` (Qwen2-VL's three
position streams) or ``"none"`` (no rotation).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..sharding.api import constrain, einsum, index_write, is_dtensor, \
    masked_fill, whole_heads, whole_heads_grad, whole_local
from . import common as cm

Tensor = torch.Tensor
NEG_INF = -1e30


def attn_init(make, cfg, dtype):
    hd = cfg.head_dim_
    bias = cfg.use_bias
    pq, aq = cm.dense_init(make, cfg.d_model, cfg.n_heads * hd, "embed",
                           "heads", bias=bias, dtype=dtype)
    pk, ak = cm.dense_init(make, cfg.d_model, cfg.n_kv_heads * hd, "embed",
                           "kv_heads", bias=bias, dtype=dtype)
    pv, av = cm.dense_init(make, cfg.d_model, cfg.n_kv_heads * hd, "embed",
                           "kv_heads", bias=bias, dtype=dtype)
    po, ao = cm.dense_init(make, cfg.n_heads * hd, cfg.d_model, "heads",
                           "embed", bias=bias, dtype=dtype)
    return ({"wq": pq, "wk": pk, "wv": pv, "wo": po},
            {"wq": aq, "wk": ak, "wv": av, "wo": ao})


def _split_heads(x: Tensor, n: int, split_batch: bool = False) -> Tensor:
    b, t, _ = x.shape
    return whole_heads(x, n, split_batch).reshape(b, t, n, -1)


def _repeat_kv(k: Tensor, n_heads: int) -> Tensor:
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hkv, dim=2)


def _mask(rows: Tensor, cols: Tensor, *, causal: bool,
          window: Optional[int], s_valid=None) -> Tensor:
    m = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                   dtype=torch.bool, device=rows.device)
    if causal:
        m = m & (cols <= rows)
    if window is not None:
        m = m & (cols > rows - window)
    if s_valid is not None:
        m = m & (cols < s_valid)
    return m


def _group_q(q: Tensor, hkv: int) -> Tensor:
    """(B, T, H, D) -> (B, T, Hkv, G, D): grouped queries that contract
    against un-replicated KV."""
    b, t, h, d = q.shape
    return q.reshape(b, t, hkv, h // hkv, d)


def _attend(qg: Tensor, k: Tensor, v: Tensor, m: Tensor, *,
            kv_seq: bool = False) -> Tensor:
    """softmax(qg k^T / sqrt(d), masked) v for grouped queries
    (B, T, Hkv, G, D) -> (B, T, Hkv, G, D). ``kv_seq`` pins the scores and
    the probabilities to the sequence-sharded KV layout (``constrain``)."""
    d = qg.shape[-1]
    scores = einsum("btkgd,bskd->bkgts", qg.to(torch.float32),
                          k.to(torch.float32)) / (d ** 0.5)
    if kv_seq:
        scores = constrain(scores, ("batch", None, None, None, "kv_seq"))
    scores = masked_fill(scores, ~m, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if kv_seq:
        p = constrain(p, ("batch", None, None, None, "kv_seq"))
    return einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)


def _sdpa_full(q, k, v, *, causal, window):
    """q: (B, T, H, D), k/v: (B, S, Hkv, D) -> (B, T, H, D)."""
    b, t, h, d = q.shape
    s = k.shape[1]
    rows = torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    m = _mask(rows, cols, causal=causal, window=window)
    return _attend(_group_q(q, k.shape[2]), k, v, m).reshape(b, t, h, d)


def _sdpa_chunked(q, k, v, *, causal, window, chunk: int):
    """Query tiles of ``chunk`` rows, one after another."""
    b, t, h, d = q.shape
    s = k.shape[1]
    assert t % chunk == 0, (t, chunk)
    qg = _group_q(q, k.shape[2])
    cols = torch.arange(s, device=q.device)[None, :]
    outs = []
    for i in range(t // chunk):
        rows = i * chunk + torch.arange(chunk, device=q.device)[:, None]
        m = _mask(rows, cols, causal=causal, window=window)
        qi = qg[:, i * chunk:(i + 1) * chunk]
        outs.append(_attend(qi, k, v, m).reshape(b, chunk, h, d))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# KV caches


class KVCache(NamedTuple):
    k: Tensor        # (B, S_max, Hkv, D) in the cache dtype
    v: Tensor
    length: Tensor   # () int32: tokens stored so far
    k_scale: Optional[Tensor] = None   # int8 scales, f32 (B, S_max, Hkv, 1)
    v_scale: Optional[Tensor] = None


def make_cache(batch: int, s_max: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, quantized: bool = False, *,
               device="cuda") -> KVCache:
    """An empty cache; ``quantized`` stores int8 with f32 scales (and
    ignores ``dtype``)."""
    shape = (batch, s_max, n_kv, head_dim)
    length = torch.zeros((), dtype=torch.int32, device=device)
    if quantized:
        def zeros(shp, dt):
            return torch.zeros(shp, dtype=dt, device=device)
        return KVCache(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                       length=length,
                       k_scale=zeros(shape[:-1] + (1,), torch.float32),
                       v_scale=zeros(shape[:-1] + (1,), torch.float32))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=length)


def _quantize(x: Tensor):
    """int8 codes and f32 scales: scale = max|x| / 127 + 1e-8 over the
    head width, codes round(x / scale) (ties to even) clipped to +-127."""
    scale = x.abs().amax(dim=-1, keepdim=True).to(torch.float32) / 127.0 \
        + 1e-8
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def cache_update(cache: KVCache, k_new: Tensor, v_new: Tensor,
                 onehot: bool = False) -> KVCache:
    """Append k/v (B, T_new, Hkv, D) at position ``length``, IN PLACE: the
    buffers and ``length`` of ``cache`` are written, and the cache is
    returned. The write starts at ``min(length, S_max - T_new)``, as the
    reference's ``dynamic_update_slice`` clamps it; ``length`` stays on
    the device (no host read).

    ``onehot=True`` (single-token decode only) writes through a one-hot
    select over the sequence axis, kept in the cache's sequence-sharded
    layout (``constrain``), as the reference does; on one device it gives
    the same values. A cache of DTensors (split over a mesh) is written
    rank by rank (``sharding.api.index_write``), each rank its rows."""
    t_new = k_new.shape[1]
    s_max = cache.k.shape[1]

    if is_dtensor(cache.k):
        # a cache split over the mesh: each rank writes its rows
        start = torch.clamp(whole_local(cache.length),
                            max=s_max - t_new).long()
        idx = start + torch.arange(t_new, device=start.device)

        def upd(buf, val):
            index_write(buf, 1, idx, val.to(buf.dtype))
    elif onehot and t_new == 1:
        pos = torch.arange(s_max, dtype=cache.length.dtype,
                           device=cache.k.device)
        oh = (pos == cache.length)[None, :, None, None]

        def upd(buf, val):
            buf.copy_(constrain(torch.where(oh, val.to(buf.dtype), buf),
                                ("batch", "kv_seq", None, None)))
    else:
        start = torch.clamp(cache.length, max=s_max - t_new).long()
        idx = start + torch.arange(t_new, device=cache.k.device)

        def upd(buf, val):
            buf.index_copy_(1, idx, val.to(buf.dtype))

    if cache.k_scale is not None:
        kq, ks = _quantize(k_new)
        vq, vs = _quantize(v_new)
        upd(cache.k, kq)
        upd(cache.v, vq)
        upd(cache.k_scale, ks)
        upd(cache.v_scale, vs)
    else:
        upd(cache.k, k_new)
        upd(cache.v, v_new)
    cache.length.add_(t_new)
    return cache


def _cache_kv(cache: KVCache):
    """The cache's k and v; int8 ones dequantised to bf16 (whatever the
    model's dtype), as the reference does."""
    if cache.k_scale is not None:
        k = cache.k.to(torch.float32) * cache.k_scale
        v = cache.v.to(torch.float32) * cache.v_scale
        return k.to(torch.bfloat16), v.to(torch.bfloat16)
    return cache.k, cache.v


def _sdpa_decode(q, cache: KVCache, *, window, constrain_kv=False):
    """q: (B, 1, H, D) against the whole cache, the unwritten tail masked.
    ``constrain_kv`` pins the reference's sequence-sharded KV layout
    through the scores and the probabilities, so that the softmax reduces
    over the sharded axis (a no-op without ``activation_context``)."""
    b, t, h, d = q.shape
    k, v = _cache_kv(cache)
    if constrain_kv:
        k = constrain(k, ("batch", "kv_seq", None, None))
        v = constrain(v, ("batch", "kv_seq", None, None))
    s = k.shape[1]
    rows = (cache.length - 1)[None, None]     # the query's position
    cols = torch.arange(s, device=q.device)[None, :]
    m = _mask(rows, cols, causal=True, window=window, s_valid=cache.length)
    return _attend(_group_q(q, k.shape[2]), k, v, m,
                   kv_seq=constrain_kv).reshape(b, t, h, d)


def attn_apply(cfg, p, x: Tensor, *, positions: Tensor, mode: str = "train",
               cache: Optional[KVCache] = None, cross_kv=None,
               window: Optional[int] = None):
    """mode: 'train' | 'prefill' | 'decode' | 'encoder' | 'cross'. Returns
    ``(out, cache)``; 'prefill' and 'decode' write ``cache`` in place
    (``cache_update``). Prefill attends the fresh k / v, not the cache.
    'cross' attends ``cross_kv = (k, v)`` (B, S, Hkv, D) as given; it and
    'encoder' are not causal. ``positions`` are (..., T) ids, or (B, 3, T)
    streams under M-RoPE."""
    hd = cfg.head_dim_
    b, t, _ = x.shape
    # training attends whole heads of a share of the batch where a mesh
    # dim cannot split the heads (sharding.api.whole_heads)
    sb = mode == "train"
    q = _split_heads(cm.dense_apply(p["wq"], x), cfg.n_heads, sb)
    if mode == "cross":
        k, v = cross_kv
    else:
        k = _split_heads(cm.dense_apply(p["wk"], x), cfg.n_kv_heads, sb)
        v = _split_heads(cm.dense_apply(p["wv"], x), cfg.n_kv_heads, sb)

    if cfg.rope == "rope" and mode != "cross":
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope" and mode != "cross":
        q = cm.apply_mrope(q, positions, cfg.rope_theta)
        k = cm.apply_mrope(k, positions, cfg.rope_theta)

    if mode == "decode":
        cache = cache_update(cache, k, v, onehot=cfg.decode_constrain_kv)
        out = _sdpa_decode(q, cache, window=window,
                           constrain_kv=cfg.decode_constrain_kv)
    else:
        if mode == "prefill":
            cache = cache_update(cache, k, v)
        # the reference: prefill is causal and always takes the chunked
        # route when asked to (its T a multiple of the chunk); train,
        # encoder and cross only where T divides
        causal = mode in ("train", "prefill")
        impl = _select_impl(cfg, t)
        if impl == "chunked" and (mode == "prefill" or t % cfg.attn_chunk
                                  == 0):
            out = _sdpa_chunked(q, k, v, causal=causal, window=window,
                                chunk=cfg.attn_chunk)
        else:
            out = _sdpa_full(q, k, v, causal=causal, window=window)
    # The output projection runs in the weights' dtype. Where the
    # reference runs, that is jnp's promotion (an int8 cache's bf16 output
    # against f32 weights widens to f32); an f32 cache under bf16 weights,
    # whose f32 output the reference's scan carry refuses (ROADMAP Queue
    # 3), joins the bf16 residual stream here.
    out = whole_heads_grad(out.reshape(b, t, cfg.n_heads * hd),
                           cfg.n_heads, sb).to(p["wo"]["w"].dtype)
    return cm.dense_apply(p["wo"], out), cache


def _select_impl(cfg, t: int) -> str:
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    return "chunked" if t >= 8192 else "full"
