"""K7 ``flash_attention``: its plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and its ``ref`` oracle, on the
same seeded numpy inputs (causal with T == S, and with T != S, where the
mask is zero-aligned), and the multi-head GQA wrapper ``mha_flash``
against the JAX package's ``ops.mha_flash`` and the model's
``attention._sdpa_full``.

Tolerances: the JAX kernel test's (tests/test_kernels.py:100-106), 2e-4
for f32 and 3e-2 for bf16 inputs, relative, with an absolute floor of 20
times that. The CUDA kernel has no CPU mode: tests/test_torch_cuda.py
and chip_smoke.py hold it to this plain version on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(shapes, seed, dtype):
    """Seeded f32 arrays, rounded to ``dtype`` by each package alike."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(x, jdt) for x in xs],
            [torch.as_tensor(x).to(tdt) for x in xs])


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol * 20)


CASES = [(bh, t, s, d, causal)
         for bh, t, s, d in [(2, 64, 64, 32), (1, 128, 128, 64),
                             (3, 1, 200, 64), (2, 96, 96, 128)]
         for causal in ([True, False] if t == s else [False])]


@pytest.mark.parametrize("bh,t,s,d,causal", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k7_plain_matches_pallas_and_ref(bh, t, s, d, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(bh, t, d), (bh, s, d), (bh, s, d)], bh * t, dtype)
    o = tops.flash_attention(tq, tk, tv, causal=causal, bt=32, bs=32)
    assert o.dtype == tq.dtype and tuple(o.shape) == (bh, t, d)
    _close(o, jkops.flash_attention(jq, jk, jv, causal=causal, bt=32, bs=32,
                                    interpret=True), dtype)
    _close(o, jref.flash_attention(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k7_causal_mask_is_zero_aligned_when_t_differs_from_s(dtype):
    """T = 48 queries over S = 96 keys: query i sees keys j <= i (not the
    last 48 keys), in the Pallas kernel, its oracle and the port."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, 48, 32), (2, 96, 32), (2, 96, 32)], 48, dtype)
    o = tops.flash_attention(tq, tk, tv, causal=True)
    _close(o, jkops.flash_attention(jq, jk, jv, causal=True, bt=16, bs=32,
                                    interpret=True), dtype)
    _close(o, jref.flash_attention(jq, jk, jv, causal=True), dtype)
    # the later keys change nothing: the first 48 keys give the same rows
    np.testing.assert_allclose(
        o.to(torch.float32).numpy(),
        tops.flash_attention(tq, tk[:, :48], tv[:, :48], causal=True)
        .to(torch.float32).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mha_flash_gqa_matches_reference_and_model_attention(causal, dtype):
    """8 query heads over 2 kv heads, (B, T, H, D) layout."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, 64, 8, 32), (2, 64, 2, 32), (2, 64, 2, 32)], 5, dtype)
    o = tops.mha_flash(tq, tk, tv, causal=causal, bt=32, bs=32)
    assert o.dtype == tq.dtype and tuple(o.shape) == (2, 64, 8, 32)
    _close(o, jkops.mha_flash(jq, jk, jv, causal=causal, bt=32, bs=32,
                              interpret=True), dtype)
    if dtype == "f32":  # the model computes P V in v's dtype
        _close(o, jattn._sdpa_full(jq, jk, jv, causal=causal, window=None),
               dtype)


def test_mha_flash_rejects_uneven_heads():
    _, (tq, tk, tv) = _inputs(
        [(1, 8, 6, 32), (1, 8, 4, 32), (1, 8, 4, 32)], 0, "f32")
    with pytest.raises(ValueError, match="kv heads evenly"):
        tops.mha_flash(tq, tk, tv)


def test_k7_cuda_launcher_refuses_cpu_tensors():
    _, (tq, tk, tv) = _inputs([(2, 8, 32), (2, 8, 32), (2, 8, 32)], 1,
                              "f32")
    before = tops.LAUNCHES["flash_attention"]
    tops.flash_attention(tq, tk, tv)
    tops.mha_flash(tq[None], tk[None], tv[None])
    assert tops.LAUNCHES["flash_attention"] == before  # none on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(tq, tk, tv)
