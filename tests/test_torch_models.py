"""The port's dense LM (models/, configs/) against the JAX package on the
reduced configs (f32), from the reference's ``init_model(key(0))``
parameters carried over by ``convert.params_from_numpy``.

Tolerances: the loss within 2e-5 relative, every gradient leaf within
1e-4 of its largest entry (f32, a different summation order). Full and
chunked attention, full and chunked CE agree to 1e-6; remat changes no
bit (CPU)."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import losses as rlosses  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import losses as tlosses  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

DENSE = ("olmo-1b", "llama3-405b", "stablelm-1.6b", "command-r-plus-104b")
OTHERS = ("zamba2-1.2b", "whisper-medium", "qwen2-vl-2b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU
    (about 10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(vocab, b=2, t=32, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (b, t + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])})


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    name = request.param
    rc, cfg = ref_arch(name).reduced(), get_arch(name).reduced()
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    return name, rc, cfg, rp, tp


def test_loss_and_grads_match_reference(pair):
    name, rc, cfg, rp, tp = pair
    rb, tb = _batch(cfg.vocab)
    (rl, rm), rg = jax.value_and_grad(lambda p: RM.loss_fn(rc, p, rb),
                                      has_aux=True)(rp)
    (tl, tm), tg = M.value_and_grad(cfg, tp, tb)
    assert abs(float(tl) - float(rl)) <= 2e-5 * abs(float(rl)), name
    assert abs(float(tm["ce"]) - float(rm["ce"])) <= 2e-5 * float(rm["ce"])
    want = [np.asarray(x) for x in jax.tree.leaves(rg)]
    got = convert.params_to_numpy(tg)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, i, err)


def test_module_is_loss_fn(pair):
    _, _, cfg, _, tp = pair
    _, tb = _batch(cfg.vocab, seed=1)
    mod = M.LM(cfg, tp)
    a, _ = mod(tb)
    b, _ = M.loss_fn(cfg, tp, tb)
    assert torch.equal(a, b)
    assert sum(p.numel() for p in mod.parameters()) == \
        sum(x.numel() for x in tree.leaves(tp))


def _paths(node, prefix=""):
    if isinstance(node, dict):
        out = []
        for k in sorted(node):
            out += _paths(node[k], f"{prefix}/{k}")
        return out
    return [prefix]


@pytest.mark.parametrize("name", DENSE)
def test_init_layout_matches_reference(name):
    """Leaf order, key paths, shapes and dtypes of ``init_model`` equal
    the reference's, on the reduced config and (on the meta device, no
    allocation) at full width."""
    rc, cfg = ref_arch(name).reduced(), get_arch(name).reduced()
    rp, raxes = RM.init_model(jax.random.key(0), rc)
    tp, taxes = M.init_model(0, cfg, device="cpu")
    rpaths = ["".join(f"/{k.key}" for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(rp)[0]]
    assert _paths(tp) == rpaths
    got = [(tuple(x.shape), str(x.dtype).split(".")[-1])
           for x in tree.leaves(tp)]
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(rp)]
    assert got == want
    assert taxes == raxes
    full = M.param_skeleton(get_arch(name))
    want_full = jax.eval_shape(lambda: RM.init_model(jax.random.key(0),
                                                     ref_arch(name))[0])
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in tree.leaves(full)] == \
        [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(want_full)]


def test_init_draws_follow_the_reference_distribution():
    """Truncated normals at [-2, 2] standard deviations of
    scale / sqrt(fan_in), ones and zeros where the reference has them."""
    cfg = get_arch("stablelm-1.6b").reduced()
    tp, _ = M.init_model(3, cfg, device="cpu")
    wi = tp["blocks"]["mlp"]["wi"]["w"]          # (L, d_model, d_ff)
    std = 1.0 / cfg.d_model ** 0.5
    assert wi.abs().max() <= 2 * std * (1 + 1e-6)
    assert abs(wi.std().item() / std - 0.88) < 0.05   # truncated at 2 sd
    table = tp["embed"]["table"]
    assert table.abs().max() <= 2 / cfg.vocab ** 0.5 * (1 + 1e-6)
    assert torch.equal(tp["blocks"]["ln1"]["scale"],
                       torch.ones_like(tp["blocks"]["ln1"]["scale"]))
    assert not tp["blocks"]["ln1"]["bias"].any()
    again, _ = M.init_model(3, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(tp), tree.leaves(again)))


@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_full_and_chunked_attention(hkv):
    rng = np.random.default_rng(hkv)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, hkv, 16)).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    full = tattn._sdpa_full(tq, tk, tv, causal=True, window=None)
    chunked = tattn._sdpa_chunked(tq, tk, tv, causal=True, window=None,
                                  chunk=8)
    want = np.asarray(rattn._sdpa_full(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       window=None))
    want_c = np.asarray(rattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=True,
                                            window=None, chunk=8))
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=1e-6)
    np.testing.assert_allclose(full.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(chunked.numpy(), want_c, atol=1e-6)
    rep = tattn._repeat_kv(tk, 4)
    assert rep.shape == (2, 32, 4, 16)
    assert torch.equal(rep[:, :, 3], tk[:, :, 3 // (4 // hkv)])


def test_chunked_attention_in_the_model():
    cfg = get_arch("llama3-405b").reduced()
    tp, _ = M.init_model(1, cfg, device="cpu")
    _, tb = _batch(cfg.vocab)
    full, _ = M.loss_fn(cfg, tp, tb)
    import dataclasses
    ch = dataclasses.replace(cfg, attn_impl="chunked")
    chunked, _ = M.loss_fn(ch, tp, tb)
    assert abs(float(full) - float(chunked)) <= 1e-6 * float(full)


def test_chunked_ce_equals_full():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    labels = rng.integers(0, 64, (2, 32)).astype(np.int32)
    mask = (rng.random((2, 32)) < 0.8).astype(np.float32)
    tx, tt, tl, tm = (torch.as_tensor(a) for a in (x, table, labels, mask))
    full, fm = tlosses.chunked_cross_entropy(tx, tt, tl, chunk=32, mask=tm)
    part, _ = tlosses.chunked_cross_entropy(tx, tt, tl, chunk=8, mask=tm)
    odd, _ = tlosses.chunked_cross_entropy(tx, tt, tl, chunk=12, mask=tm)
    want, wm = rlosses.chunked_cross_entropy(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels), chunk=8,
        mask=jnp.asarray(mask))
    assert abs(float(full) - float(part)) <= 1e-6 * float(full)
    assert abs(float(odd) - float(part)) <= 1e-6 * float(full)
    assert abs(float(part) - float(want)) <= 1e-6 * float(want)
    assert float(fm["tokens"]) == float(wm["tokens"]) == mask.sum()
    logits = tx @ tt.T
    lse = torch.logsumexp(logits, -1)
    ce = (lse - torch.gather(logits, -1, tl[..., None].long())[..., 0])
    plain = (ce * tm).sum() / tm.sum() + 1e-4 * (lse ** 2 * tm).sum() \
        / tm.sum()
    assert abs(float(plain) - float(full)) <= 1e-6 * float(full)


def test_remat_changes_no_bit():
    import dataclasses
    cfg = get_arch("olmo-1b").reduced()
    on = dataclasses.replace(cfg, remat="block")
    off = dataclasses.replace(cfg, remat="none")
    tp, _ = M.init_model(2, cfg, device="cpu")
    _, tb = _batch(cfg.vocab, seed=3)
    (l_on, _), g_on = M.value_and_grad(on, tp, tb)
    (l_off, _), g_off = M.value_and_grad(off, tp, tb)
    assert torch.equal(l_on, l_off)
    for a, b in zip(tree.leaves(g_on), tree.leaves(g_off)):
        assert torch.equal(a, b)


def _billions(name):
    return float(re.search(r"-(\d+(?:\.\d+)?)b", name).group(1))


@pytest.mark.parametrize("name", list_archs())
def test_param_count(name):
    """The port's analytic count equals the reference's; a dense model's
    module holds that many parameters plus its norms' (which the analytic
    count leaves out; meta device, full width); each dense count is within
    20% of its name."""
    cfg = get_arch(name)
    assert cfg.param_count() == ref_arch(name).param_count()
    assert cfg.active_param_count() == ref_arch(name).active_param_count()
    if cfg.family == "dense":
        mod = M.LM(cfg, M.param_skeleton(cfg))
        per_norm = {"rmsnorm": 1, "layernorm": 2, "layernorm_np": 0}[
            cfg.norm] * cfg.d_model
        assert sum(p.numel() for p in mod.parameters()) == \
            cfg.param_count() + (2 * cfg.n_layers + 1) * per_norm
        assert abs(cfg.param_count() / 1e9 / _billions(name) - 1) < 0.2
    if name == "olmo-1b":
        assert cfg.param_count() == 1_176_764_416


@pytest.mark.parametrize("name", OTHERS)
def test_other_families_raise(name):
    """The hybrid, enc-dec and VLM families build (their parity lives in
    test_torch_hybrid.py, test_torch_encdec.py and test_torch_vlm.py);
    a family the model does not know raises ``ValueError`` from every
    entry point, as the reference's ``init_model`` does."""
    cfg = get_arch(name).reduced()
    tp, _ = M.init_model(0, cfg, device="cpu")
    assert [x.shape for x in tree.leaves(tp)] == \
        [x.shape for x in tree.leaves(M.param_skeleton(cfg))]
    bad = dataclasses.replace(cfg, family="unknown")
    with pytest.raises(ValueError, match="unknown family"):
        M.init_model(0, bad, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        M.param_skeleton(bad)
    _, tb = _batch(cfg.vocab)
    with pytest.raises(ValueError, match="unknown family"):
        M.loss_fn(bad, {}, tb)
    with pytest.raises(ValueError, match="unknown family"):
        M.make_caches(bad, 1, 8, device="cpu")


def test_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the raise on a machine without a card")
    cfg = get_arch("olmo-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_model(0, cfg)
