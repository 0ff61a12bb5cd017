"""The dispatch layer over the seven hand-written kernels.

Each entry point takes tensors on one device:

  * on the CPU it runs the kernel's plain PyTorch version;
  * on a CUDA device it launches the kernel (building it at first use),
    and raises if the kernel cannot build or launch. There is no fallback
    from a CUDA tensor to the plain version.

``LAUNCHES`` counts kernel launches, one per call that launched its
kernel (a fused step counts once, though it is a matvec launch and a
tail launch), so a run can show that it went through the kernels. A
call on the card launches or raises, empty inputs included, so each
count it adds is a launch.
"""
from __future__ import annotations

import torch

from . import bilinear_matvec as _bmv
from . import flash_attention as _fa
from . import gql_update as _gu
from . import lanczos_step as _ls
from . import spmv_bell as _sb

LAUNCHES = {"gql_update": 0, "bell_matvec": 0, "fused_step_dense": 0,
            "fused_step_bell": 0, "bell_matvec_mrhs": 0, "fused_matvec": 0,
            "flash_attention": 0}


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and the per-route counts of K2, K3/K4, K5 and
    K7."""
    for counts in (LAUNCHES, _sb.ROUTES, _sb.MRHS_ROUTES, _ls.ROUTES,
                   _fa.ROUTES):
        for k in counts:
            counts[k] = 0


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{what}: no kernel for device {x.device}")


def gql_update(alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr,
               lam_min, lam_max):
    """K1: batched Alg. 5 recurrence update over flat (B,) lanes."""
    args = (alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr, lam_min,
            lam_max)
    if not _on_cuda(g, "gql_update"):
        return _gu.gql_update_plain(*args)
    out = _gu.gql_update_cuda(*args)
    LAUNCHES["gql_update"] += 1
    return out


def bell_matvec(data, cols, x):
    """K2: blocked-ELL SpMV with f32 accumulation and output; x (N,) or
    (L, N) with N = R * bs."""
    if not _on_cuda(x, "bell_matvec"):
        return _sb.bell_matvec_plain(data, cols, x)
    out = _sb.bell_matvec_cuda(data, cols, x)
    LAUNCHES["bell_matvec"] += 1
    return out


def bell_matvec_mrhs(data, cols, x):
    """K5: blocked-ELL SpMM with f32 accumulation and output over
    row-stacked right-hand sides x (L, b, N), N = R * bs; the table is
    shared (R, K, bs, bs) or per lane (L, R, K, bs, bs)."""
    if not _on_cuda(x, "bell_matvec_mrhs"):
        return _sb.bell_matvec_mrhs_plain(data, cols, x)
    out = _sb.bell_matvec_mrhs_cuda(data, cols, x)
    LAUNCHES["bell_matvec_mrhs"] += 1
    return out


def fused_step_dense(a, s_out, s_in, t, v, v_prev, scalars, basis=None, *,
                     shared_a: bool, rows=None):
    """K3: one fused step over (K, N) lanes with a dense A. ``rows`` (an
    int32 tensor of one element, read on the card) bounds the kernel's
    reorth passes to basis rows ``[0, rows)``; the plain version reads all
    M rows."""
    if not _on_cuda(v, "fused_step_dense"):
        return _ls.fused_step_dense_plain(a, s_out, s_in, t, v, v_prev,
                                          scalars, basis, shared_a=shared_a,
                                          rows=rows)
    out = _ls.fused_step_dense_cuda(a, s_out, s_in, t, v, v_prev, scalars,
                                    basis, shared_a=shared_a, rows=rows)
    LAUNCHES["fused_step_dense"] += 1
    return out


def fused_step_bell(data, cols, s_out, s_in, t, v, v_prev, scalars):
    """K4: one fused step over (L, R*bs) lanes with a blocked-ELL A."""
    if not _on_cuda(v, "fused_step_bell"):
        return _ls.fused_step_bell_plain(data, cols, s_out, s_in, t, v,
                                         v_prev, scalars)
    out = _ls.fused_step_bell_cuda(data, cols, s_out, s_in, t, v, v_prev,
                                   scalars)
    LAUNCHES["fused_step_bell"] += 1
    return out


def fused_matvec(a, x, *, bm: int = 128, bn: int = 128):
    """K6: ``(y, alpha) = (A @ x, x^T A x)`` over independent systems,
    a (B, N, N) f32 or bf16 and x (B, N); f32 results with f32
    accumulation. Raises ``ValueError`` unless x has a's B.

    ``bm``/``bn`` are the reference's tile sizes, kept for its
    signature. Neither path uses them: the plain version is one einsum,
    and the card's kernel streams A by its own layout (one CTA per SM,
    each an equal run of rows; a warp per row), so they change nothing in
    the result.
    """
    if not _on_cuda(x, "fused_matvec"):
        return _bmv.fused_matvec_plain(a, x)
    out = _bmv.fused_matvec_cuda(a, x)
    LAUNCHES["fused_matvec"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, bt: int = 128,
                    bs: int = 128):
    """K7: streaming attention forward over q (BH, T, D), k/v (BH, S, D)
    in f32 or bf16; the result is in q's dtype, accumulated in f32.

    ``bt``/``bs`` are the reference's tile sizes, kept for its
    signature. Neither path uses them: the plain version holds the whole
    score matrix, and the card's kernels tile by their own layout (128
    query rows per CTA on the ``wgmma`` route, 64 on the others; 64-key
    tiles for bf16, 32-key tiles for f32), so they change nothing in the
    result.
    """
    if not _on_cuda(q, "flash_attention"):
        return _fa.flash_attention_plain(q, k, v, causal=causal)
    out = _fa.flash_attention_cuda(q, k, v, causal=causal)
    LAUNCHES["flash_attention"] += 1
    return out


def mha_flash(q, k, v, *, causal: bool = True, bt: int = 128,
              bs: int = 128):
    """Multi-head K7: q (B, T, H, D), k/v (B, S, Hkv, D) with H a
    multiple of Hkv; one launch on the card (counted under
    ``"flash_attention"``), the reference's repeat-and-flatten on the
    CPU. ``bt``/``bs`` as in :func:`flash_attention`."""
    on_cuda = _on_cuda(q, "mha_flash")
    out = _fa.mha_flash(q, k, v, causal=causal, bt=bt, bs=bs)
    if on_cuda:
        LAUNCHES["flash_attention"] += 1
    return out


# The reference's two other public names: the fused step as a drop-in for
# ``core.gql.gql_step`` (K3 or K4 where the operator has the sandwich form;
# ``rows`` bounds K3's reorth passes to the live basis rows) and the dense
# to blocked-ELL converter.
gql_step_fused = _ls.gql_step_fused
dense_to_bell = _sb.dense_to_bell
