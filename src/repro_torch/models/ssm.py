"""Mamba-1 / Mamba-2 state-space blocks in plain PyTorch (counterpart of
``repro.models.ssm``).

Mamba-1 (falcon-mamba): a per-channel diagonal A (d_inner, n_state) and
input-dependent B, C, dt (the selective scan). Mamba-2 (zamba2): a scalar
decay per head and a rank-1 state update shared across the head width,
with the chunked SSD form beside the scan (``ssm_impl``).

The scan. The reference runs ``jax.lax.associative_scan`` over the whole
(B, T, d_inner, n) sequence of states. PyTorch has no such call, and at
falcon-mamba's width one such f32 tensor is 4.3 GB for 8 x 1024 tokens.
So ``_scan_linear`` is a sequential scan, one ``addcmul`` a step over the
(B, ...) state, and the cores call it on time chunks of ``SCAN_CHUNK``
steps carrying the state between chunks, which bounds the temporaries to
one chunk's. A log-depth doubling scan would take log2(T) passes over the
whole chunk for every level, several times the bytes of the one pass this
one makes; the sequential scan's cost is one launch a step. The result
differs from the reference's in f32 rounding alone.

Mixed dtypes. With bf16 weights and an f32 cache (the Engine's default),
the reference's convolution concatenates the f32 carry with the bf16
input, and everything up to ``y.astype(xz.dtype)`` runs in f32 by jnp's
promotion; ``common.dense_apply`` applies the same promotion, which
``torch.matmul`` would refuse.

``ssm_apply`` writes a given ``SSMCache``'s fields in place (``copy_``,
in the cache's dtype) and returns that cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import common as cm

Tensor = torch.Tensor

# time steps a chunk of the prefill's scan: at falcon-mamba's width one
# chunk of (8, 128, 8192, 16) f32 states is 537 MB
SCAN_CHUNK = 128


class SSMCache(NamedTuple):
    conv: Tensor    # (B, K-1, d_inner) the last conv inputs
    state: Tensor   # mamba1: (B, d_inner, n) | mamba2: (B, H, dh, n), f32


def ssm_init(make, cfg, dtype):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    f32 = torch.float32
    p_in, a_in = cm.dense_init(make, d, 2 * di, "embed", "ssm_inner",
                               bias=False, dtype=dtype)
    p_out, a_out = cm.dense_init(make, di, d, "ssm_inner", "embed",
                                 bias=False, dtype=dtype)
    p = {"in_proj": p_in, "out_proj": p_out,
         "conv_w": make((cfg.ssm_conv, di), cfg.ssm_conv, 1.0, dtype),
         "conv_b": cm.zeros(make, (di,), dtype)}
    a = {"in_proj": a_in, "out_proj": a_out,
         "conv_w": (None, "ssm_inner"), "conv_b": ("ssm_inner",)}
    if cfg.ssm_variant == "mamba1":
        p["a_log"] = make((di, n), None, "log_arange", f32)
        a["a_log"] = ("ssm_inner", None)
        p["bcdt_proj"], a["bcdt_proj"] = cm.dense_init(
            make, di, 2 * n + 1, "ssm_inner", None, bias=False, dtype=dtype)
        p["dt_proj"], a["dt_proj"] = cm.dense_init(
            make, 1, di, None, "ssm_inner", bias=True, dtype=dtype)
        p["d_skip"] = cm.ones(make, (di,), f32)
        a["d_skip"] = ("ssm_inner",)
    else:
        h = cfg.ssm_heads
        p["a_log"] = cm.zeros(make, (h,), f32)
        a["a_log"] = (None,)
        p["bcdt_proj"], a["bcdt_proj"] = cm.dense_init(
            make, di, 2 * n + h, "ssm_inner", None, bias=False, dtype=dtype)
        p["d_skip"] = cm.ones(make, (h,), f32)
        a["d_skip"] = (None,)
        p["norm_scale"] = cm.ones(make, (di,), dtype)
        a["norm_scale"] = ("ssm_inner",)
    return p, a


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 carry: Optional[Tensor] = None):
    """x: (B, T, di); w: (K, di), a depthwise causal convolution.
    Returns ``(y, new_carry)``, the carry the last K-1 inputs, in the
    promoted dtype of the carry and ``x``."""
    k = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    dt = torch.promote_types(carry.dtype, x.dtype)
    xp = torch.cat([carry.to(dt), x.to(dt)], dim=1)
    t = x.shape[1]
    y = sum(xp[:, j:j + t, :] * w[j] for j in range(k))
    new_carry = xp[:, -(k - 1):, :] if k > 1 else carry
    return y + b, new_carry


def _scan_linear(a: Tensor, b: Tensor, h0: Optional[Tensor] = None):
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1 (time), one step after
    another, from ``h_{-1} = h0`` (zero when None; folded into the first
    step as the reference folds it). ``a`` broadcasts against ``b`` (B, T,
    ...). Returns h (B, T, ...)."""
    hs = []
    h = h0
    for t in range(b.shape[1]):
        h = b[:, t] if h is None else torch.addcmul(b[:, t], a[:, t], h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _chunked_scan(make_ab, cmat: Tensor, h0: Optional[Tensor], t: int,
                  contract: str):
    """The prefill's scan in time chunks of ``SCAN_CHUNK``: ``make_ab(sl)``
    gives the chunk's (abar, bx), the chunk's states contract with its
    ``cmat`` rows by ``contract``, and the last state carries over.
    Returns ``(y, h_last)``."""
    ys, h = [], h0
    for s in range(0, t, SCAN_CHUNK):
        sl = slice(s, min(s + SCAN_CHUNK, t))
        abar, bx = make_ab(sl)
        hs = _scan_linear(abar, bx, h)
        ys.append(torch.einsum(contract, hs, cmat[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba1_core(cfg, p, xz: Tensor, cache: Optional[SSMCache], mode: str):
    n = cfg.ssm_state
    x, z = torch.chunk(xz, 2, dim=-1)
    conv_carry = cache.conv if cache is not None else None
    xc, new_conv = _causal_conv(x, p["conv_w"], p["conv_b"], conv_carry)
    xc = F.silu(xc)

    bcdt = cm.dense_apply(p["bcdt_proj"], xc)           # (B, T, 2n+1)
    bmat = bcdt[..., :n].to(torch.float32)              # (B, T, n)
    cmat = bcdt[..., n:2 * n].to(torch.float32)
    dt_in = bcdt[..., 2 * n:]                           # (B, T, 1)
    dt = F.softplus(cm.dense_apply(p["dt_proj"], dt_in)
                    .to(torch.float32))                 # (B, T, di)
    a = -torch.exp(p["a_log"])                          # (di, n)
    xf = xc.to(torch.float32)

    # discretization: abar = exp(dt A), bbar x = dt * B * x
    def make_ab(sl):
        d_ = dt[:, sl, :, None]
        return (torch.exp(d_ * a),
                d_ * bmat[:, sl, None, :] * xf[:, sl, :, None])

    if mode == "decode":
        abar, bx = make_ab(slice(0, 1))
        h = abar[:, 0] * cache.state + bx[:, 0]          # (B, di, n)
        y = torch.einsum("bdn,bn->bd", h, cmat[:, 0])[:, None]
        new_state = h
    else:
        h0 = cache.state if cache is not None else None
        y, new_state = _chunked_scan(make_ab, cmat, h0, xz.shape[1],
                                     "btdn,btn->btd")

    y = y + p["d_skip"] * xf
    y = y.to(xz.dtype) * F.silu(z)
    return y, SSMCache(conv=new_conv, state=new_state)


def _ssd_chunked(abar, dtx, bmat, cmat, h0, chunk: int):
    """Mamba-2 SSD in matmul form, chunk by chunk: per chunk of Q steps

        y_t = decay(t) * C_t . H_in                (inter-chunk, carried)
            + sum_{s<=t} M_ts (B_s . C_t) dtx_s    (intra-chunk, matmul)

    with M_ts the causal decay mask. abar: (B, T, H); dtx: (B, T, H, dh);
    bmat / cmat: (B, T, n). Returns ``(y (B, T, H, dh), h_final (B, H, dh,
    n))``."""
    b, t, h = abar.shape
    dh = dtx.shape[-1]
    n = bmat.shape[-1]
    q = min(chunk, t)
    while t % q:
        q //= 2
    nc = t // q

    la = torch.log(torch.clamp(abar, min=1e-30)).reshape(b, nc, q, h)
    dtxc = dtx.reshape(b, nc, q, h, dh)
    bc = bmat.reshape(b, nc, q, n)
    cc = cmat.reshape(b, nc, q, n)
    cum = torch.cumsum(la, dim=2)                       # (B, nc, Q, H)
    ar = torch.arange(q, device=abar.device)
    causal = (ar[:, None] >= ar[None, :])[None, :, :, None]

    ys, hin = [], h0
    for i in range(nc):
        cum_c, dtx_c, b_c, c_c = cum[:, i], dtxc[:, i], bc[:, i], cc[:, i]
        decay_in = torch.exp(cum_c)                     # (B, Q, H)
        y_inter = torch.einsum("bqn,bhdn->bqhd", c_c, hin) \
            * decay_in[..., None]
        scores = torch.einsum("bqn,bsn->bqs", c_c, b_c)
        m = cum_c[:, :, None, :] - cum_c[:, None, :, :]  # (B, Q, S, H)
        mask = torch.where(causal, torch.exp(m), 0.0)
        y_intra = torch.einsum("bqs,bqsh,bshd->bqhd", scores, mask, dtx_c)
        decay_out = torch.exp(cum_c[:, -1:, :] - cum_c)  # (B, Q, H)
        hout = hin * torch.exp(cum_c[:, -1])[:, :, None, None]
        hin = hout + torch.einsum("bsh,bshd,bsn->bhdn", decay_out, dtx_c,
                                  b_c)
        ys.append(y_inter + y_intra)
    return torch.stack(ys, dim=1).reshape(b, t, h, dh), hin


def mamba2_core(cfg, p, xz: Tensor, cache: Optional[SSMCache], mode: str):
    di = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    nh = cfg.ssm_heads
    dh = di // nh
    x, z = torch.chunk(xz, 2, dim=-1)
    conv_carry = cache.conv if cache is not None else None
    xc, new_conv = _causal_conv(x, p["conv_w"], p["conv_b"], conv_carry)
    xc = F.silu(xc)
    bt = xc.shape[:2]

    bcdt = cm.dense_apply(p["bcdt_proj"], xc)
    bmat = bcdt[..., :n].to(torch.float32)              # (B, T, n)
    cmat = bcdt[..., n:2 * n].to(torch.float32)
    dt = F.softplus(bcdt[..., 2 * n:].to(torch.float32))  # (B, T, H)
    a = -torch.exp(p["a_log"])                          # (H,)
    xh = xc.to(torch.float32).reshape(*bt, nh, dh)      # (B, T, H, dh)
    abar = torch.exp(dt * a)                            # (B, T, H)

    if mode == "decode":
        bx = dt[:, 0, :, None, None] * xh[:, 0, :, :, None] \
            * bmat[:, 0, None, None, :]                 # (B, H, dh, n)
        h = abar[:, 0, :, None, None] * cache.state + bx
        y = torch.einsum("bhdn,bn->bhd", h, cmat[:, 0])[:, None]
        y = y.reshape(y.shape[0], 1, di)
        new_state = h
    elif cfg.ssm_impl == "chunked":
        h0 = cache.state if cache is not None else \
            torch.zeros((xz.shape[0], nh, dh, n), dtype=torch.float32,
                        device=xz.device)
        dtx = dt[..., None] * xh                        # (B, T, H, dh)
        y, new_state = _ssd_chunked(abar, dtx, bmat, cmat, h0,
                                    chunk=cfg.ssm_chunk)
        y = y.reshape(*y.shape[:2], di)
    else:
        def make_ab(sl):
            return (abar[:, sl, :, None, None],
                    dt[:, sl, :, None, None] * xh[:, sl, ..., None]
                    * bmat[:, sl, None, None, :])       # (B, t, H, dh, n)

        h0 = cache.state if cache is not None else None
        y, new_state = _chunked_scan(make_ab, cmat, h0, xz.shape[1],
                                     "bthdn,btn->bthd")
        y = y.reshape(*y.shape[:2], di)

    y = y + (p["d_skip"][:, None] * xh).reshape(*bt, di)
    y = cm.norm_apply("rmsnorm", {"scale": p["norm_scale"]}, y.to(xz.dtype))
    y = y * F.silu(z)
    return y, SSMCache(conv=new_conv, state=new_state)


def ssm_apply(cfg, p, x: Tensor, *, mode: str,
              cache: Optional[SSMCache] = None):
    """x: (B, T, d) -> (B, T, d). Returns ``(y, cache)``; a given cache is
    written in place and returned, otherwise the new one."""
    xz = cm.dense_apply(p["in_proj"], x)
    core = mamba1_core if cfg.ssm_variant == "mamba1" else mamba2_core
    y, new = core(cfg, p, xz, cache, mode)
    if cache is not None:
        cache.conv.copy_(new.conv)
        cache.state.copy_(new.state)
        new = cache
    return cm.dense_apply(p["out_proj"], y), new


def make_ssm_cache(cfg, batch: int, dtype=torch.bfloat16, *,
                   device="cuda") -> SSMCache:
    """An empty cache: the conv carry in ``dtype``, the state in f32."""
    di = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    conv = torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                       device=device)
    if cfg.ssm_variant == "mamba1":
        shape = (batch, di, n)
    else:
        nh = cfg.ssm_heads
        shape = (batch, nh, di // nh, n)
    return SSMCache(conv=conv, state=torch.zeros(shape, dtype=torch.float32,
                                                 device=device))
