"""GQA attention for training, in plain PyTorch (counterpart of the train
mode of ``repro.models.attention``).

``full``     materialises (T, S) scores in f32;
``chunked``  loops over query tiles, O(bq * S) live scores a tile.

Both contract grouped queries against un-replicated KV, as the reference
does; neither goes through a fused attention call, because the reference
computes neither. The KV cache, int8 caches and the decode path wait for
the Engine (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

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


def _split_heads(x: Tensor, n: int) -> Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n, -1)


def _repeat_kv(k: Tensor, n_heads: int) -> Tensor:
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hkv, dim=2)


def _mask(rows: Tensor, cols: Tensor, *, causal: bool,
          window: Optional[int]) -> Tensor:
    m = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                   dtype=torch.bool, device=rows.device)
    if causal:
        m = m & (cols <= rows)
    if window is not None:
        m = m & (cols > rows - window)
    return m


def _group_q(q: Tensor, hkv: int) -> Tensor:
    """(B, T, H, D) -> (B, T, Hkv, G, D): grouped queries that contract
    against un-replicated KV."""
    b, t, h, d = q.shape
    return q.reshape(b, t, hkv, h // hkv, d)


def _attend(qg: Tensor, k: Tensor, v: Tensor, m: Tensor) -> Tensor:
    """softmax(qg k^T / sqrt(d), masked) v for grouped queries
    (B, T, Hkv, G, D) -> (B, T, Hkv, G, D)."""
    d = qg.shape[-1]
    scores = torch.einsum("btkgd,bskd->bkgts", qg.to(torch.float32),
                          k.to(torch.float32)) / (d ** 0.5)
    scores = scores.masked_fill(~m, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)


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


def attn_apply(cfg, p, x: Tensor, *, positions: Tensor,
               mode: str = "train") -> Tensor:
    """Causal self-attention of a training step. The other modes (the
    cache-filling prefill and decode, the encoder's and cross-attention)
    wait for the Engine and their families."""
    if mode != "train":
        raise NotImplementedError(
            f"attention mode {mode!r} waits for the LLM Engine and its "
            f"families (ROADMAP Queue 1); the port runs 'train'")
    if cfg.rope != "rope":
        raise NotImplementedError(
            f"rope={cfg.rope!r} waits for its family (ROADMAP Queue 1)")
    hd = cfg.head_dim_
    b, t, _ = x.shape
    q = _split_heads(cm.dense_apply(p["wq"], x), cfg.n_heads)
    k = _split_heads(cm.dense_apply(p["wk"], x), cfg.n_kv_heads)
    v = _split_heads(cm.dense_apply(p["wv"], x), cfg.n_kv_heads)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    if _select_impl(cfg, t) == "chunked" and t % cfg.attn_chunk == 0:
        out = _sdpa_chunked(q, k, v, causal=True, window=None,
                            chunk=cfg.attn_chunk)
    else:
        out = _sdpa_full(q, k, v, causal=True, window=None)
    return cm.dense_apply(p["wo"], out.reshape(b, t, cfg.n_heads * hd))


def _select_impl(cfg, t: int) -> str:
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    return "chunked" if t >= 8192 else "full"
