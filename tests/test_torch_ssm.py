"""The port's SSM blocks (models/ssm.py) and its SSM family (falcon-mamba,
mamba1) against the JAX package, f32 unless stated, from the reference's
parameters: the module's pieces on falcon-mamba's reduced config, mamba2
and the chunked SSD on zamba2's (its hybrid family: test_torch_hybrid.py),
and the family's entry points from the reference's
``init_model(key(0))`` through ``convert.params_from_numpy``.

Tolerances: outputs, states and logits within 1e-5 relative (f32, another
summation order; the port's scan is sequential, the reference's
associative); bf16 weights with an f32 cache within 2e-2 of the
reference's logits (bf16 rounding of the projections and the residual
stream, summed in another order); greedy and temperature tokens equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

NAME = "falcon-mamba-7b"
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x):
    return torch.as_tensor(np.array(x))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _block_params(name, impl="scan"):
    """(ref cfg, port cfg, ref ssm params, port ssm params) from the
    reference's ``ssm_init``, converted leaf by leaf."""
    rc = dataclasses.replace(ref_arch(name).reduced(), ssm_impl=impl)
    cfg = dataclasses.replace(get_arch(name).reduced(), ssm_impl=impl)
    rp, _ = rssm.ssm_init(jax.random.key(0), rc, jnp.float32)
    _, spec = tree.flatten(tssm.ssm_init(M._meta, cfg, torch.float32)[0])
    tp = tree.unflatten(spec, [_t(x) for x in jax.tree.leaves(rp)])
    return rc, cfg, rp, tp


@pytest.fixture(scope="module")
def pair():
    rc, cfg = ref_arch(NAME).reduced(), get_arch(NAME).reduced()
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    return rc, cfg, rp, tp


# --------------------------------------------------------------- pieces


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv(with_carry):
    x, w, b = _rand((2, 7, 24), 0), _rand((4, 24), 1), _rand((24,), 2)
    carry = _rand((2, 3, 24), 3) if with_carry else None
    ry, rc = rssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               None if carry is None else jnp.asarray(carry))
    ty, tc = tssm._causal_conv(_t(x), _t(w), _t(b),
                               None if carry is None else _t(carry))
    assert _rel(ty.numpy(), ry) <= RTOL
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))


def test_causal_conv_promotes_a_wider_carry():
    """A bf16 input against an f32 carry (the Engine's default cache under
    bf16 weights): both packages compute in f32 and carry f32."""
    x = _rand((2, 5, 16), 4)
    w, b, carry = _rand((4, 16), 5), _rand((16,), 6), _rand((2, 3, 16), 7)
    ry, rc = rssm._causal_conv(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(w, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16),
                               jnp.asarray(carry))
    ty, tc = tssm._causal_conv(_t(x).bfloat16(), _t(w).bfloat16(),
                               _t(b).bfloat16(), _t(carry))
    assert ry.dtype == jnp.float32 and rc.dtype == jnp.float32
    assert ty.dtype == torch.float32 and tc.dtype == torch.float32
    assert _rel(ty.numpy(), ry) <= RTOL
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", [(2, 9, 6, 3), (2, 9, 3, 1, 1)])
def test_scan_linear(with_h0, shape):
    """``h_t = a_t h_{t-1} + b_t`` over 9 steps, with and without an
    initial state; the second shape's ``a`` broadcasts over (dh, n) as
    mamba2's does."""
    a = np.exp(-np.abs(_rand(shape, 8)))
    full = shape[:3] + (4, 5) if len(shape) == 5 else shape
    b = _rand(full, 9)
    h0 = _rand(full[:1] + full[2:], 10) if with_h0 else None
    ra, rb = jnp.asarray(a), jnp.asarray(b)
    if len(shape) == 5:
        ra = jnp.broadcast_to(ra, full)     # the reference's scan needs it
    want = rssm._scan_linear(ra, rb, None if h0 is None else jnp.asarray(h0))
    got = tssm._scan_linear(_t(a), _t(b), None if h0 is None else _t(h0))
    assert got.shape == full
    assert _rel(got.numpy(), want) <= RTOL


def _core_cases(name, impl, chunk=None, monkeypatch=None):
    rc, cfg, rp, tp = _block_params(name, impl)
    if chunk is not None:
        monkeypatch.setattr(tssm, "SCAN_CHUNK", chunk)
    core = "mamba1_core" if cfg.ssm_variant == "mamba1" else "mamba2_core"
    di = cfg.ssm_expand * cfg.d_model
    b, t = 2, 10
    xz = _rand((b, t, 2 * di), 11, 0.5)
    rcache = rssm.make_ssm_cache(rc, b, jnp.float32)
    tcache = tssm.make_ssm_cache(cfg, b, torch.float32, device="cpu")
    # a cache holding a state, as after an earlier prefill
    st = _rand(tuple(rcache.state.shape), 12, 0.3)
    cv = _rand(tuple(rcache.conv.shape), 13, 0.3)
    rcache = rssm.SSMCache(conv=jnp.asarray(cv), state=jnp.asarray(st))
    tcache = tssm.SSMCache(conv=_t(cv), state=_t(st))
    return getattr(rssm, core), getattr(tssm, core), rc, cfg, rp, tp, xz, \
        rcache, tcache


_CORE_CASES = [(name, impl, mode, None)
               for name, impl in ((NAME, "scan"), ("zamba2-1.2b", "scan"),
                                  ("zamba2-1.2b", "chunked"))
               for mode in ("train", "prefill", "decode")] + \
    [(name, "scan", mode, 4) for name in (NAME, "zamba2-1.2b")
     for mode in ("train", "prefill")]


@pytest.mark.parametrize("name,impl,mode,chunk", _CORE_CASES)
def test_cores_match_reference(name, impl, mode, chunk, monkeypatch):
    """``mamba1_core`` (falcon-mamba) and ``mamba2_core`` (zamba2, on the
    scan and on the chunked SSD) in each mode: 'train' from no cache,
    'prefill' from a cache holding a state, 'decode' one token; with the
    port's scan in one chunk and in chunks of 4 steps (10 = 4 + 4 + 2)."""
    rf, tf, rc, cfg, rp, tp, xz, rcache, tcache = _core_cases(
        name, impl, chunk, monkeypatch)
    if mode == "decode":
        xz = xz[:, :1]
    use = mode != "train"
    ry, rnew = rf(rc, rp, jnp.asarray(xz), rcache if use else None, mode)
    ty, tnew = tf(cfg, tp, _t(xz), tcache if use else None, mode)
    assert _rel(ty.numpy(), ry) <= RTOL, (name, impl, mode)
    assert _rel(tnew.state.numpy(), rnew.state) <= RTOL
    np.testing.assert_array_equal(tnew.conv.numpy(), np.asarray(rnew.conv))


def test_make_ssm_cache():
    for name in (NAME, "zamba2-1.2b"):
        for dt, rdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            rc, cfg = ref_arch(name).reduced(), get_arch(name).reduced()
            want = rssm.make_ssm_cache(rc, 3, rdt)
            got = tssm.make_ssm_cache(cfg, 3, dt, device="cpu")
            for g, w in zip(got, want):
                assert tuple(g.shape) == w.shape
                assert str(g.dtype).split(".")[-1] == str(w.dtype)
                assert not g.any()


def test_ssm_apply_writes_the_cache_in_place():
    rc, cfg, rp, tp = _block_params(NAME)
    x = _rand((2, 6, cfg.d_model), 14, 0.3)
    tc = tssm.make_ssm_cache(cfg, 2, torch.float32, device="cpu")
    ptr = tc.state.data_ptr()
    ry, rnew = rssm.ssm_apply(rc, rp, jnp.asarray(x), mode="prefill",
                              cache=rssm.make_ssm_cache(rc, 2, jnp.float32))
    ty, tnew = tssm.ssm_apply(cfg, tp, _t(x), mode="prefill", cache=tc)
    assert tnew is tc and tc.state.data_ptr() == ptr
    assert _rel(ty.numpy(), ry) <= RTOL
    assert _rel(tc.state.numpy(), rnew.state) <= RTOL
    np.testing.assert_array_equal(tc.conv.numpy(), np.asarray(rnew.conv))


@pytest.mark.parametrize("name", [NAME, "zamba2-1.2b"])
def test_scan_vs_stepwise(name):
    """Counterpart of tests/test_models.py's: the prefill scan's outputs
    and state equal token-by-token decode's (2e-4, the reference test's
    bound)."""
    _, cfg, _, tp = _block_params(name)
    b, t = 2, 8
    x = _rand((b, t, cfg.d_model), 1, 0.3)
    c0 = tssm.make_ssm_cache(cfg, b, torch.float32, device="cpu")
    y_scan, c_scan = tssm.ssm_apply(cfg, tp, _t(x), mode="prefill",
                                    cache=c0)
    c = tssm.make_ssm_cache(cfg, b, torch.float32, device="cpu")
    ys = []
    for i in range(t):
        yt, c = tssm.ssm_apply(cfg, tp, _t(x[:, i:i + 1]), mode="decode",
                               cache=c)
        ys.append(yt)
    np.testing.assert_allclose(y_scan.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(c_scan.state.numpy(), c.state.numpy(),
                               rtol=2e-4, atol=2e-4)


# ------------------------------------------------------- model entry points


def test_loss_and_grads_match_reference(pair):
    rc, cfg, rp, tp = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 25)).astype(
        np.int32)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "labels": torch.as_tensor(toks[:, 1:])}
    (rl, rm), rg = jax.value_and_grad(lambda p: RM.loss_fn(rc, p, rb),
                                      has_aux=True)(rp)
    (tl, tm), tg = M.value_and_grad(cfg, tp, tb)
    assert abs(float(tl) - float(rl)) <= 2e-5 * abs(float(rl))
    assert float(tm["aux"]) == float(rm["aux"]) == 0.0
    want = [np.asarray(x) for x in jax.tree.leaves(rg)]
    got = convert.params_to_numpy(tg)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (i, err)


def _same_caches(got, want):
    g = convert.caches_to_numpy(got)
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert [a.shape for a in g] == [b.shape for b in w]
    for a, b in zip(g, w):
        assert _rel(a, b) <= RTOL


def test_prefill_decode_logits_and_caches(pair):
    rc, cfg, rp, tp = pair
    b, t = 2, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (b, t + 3)) \
        .astype(np.int32)
    rcache = RM.make_caches(rc, b, t + 4, jnp.float32)
    tcache = M.make_caches(cfg, b, t + 4, torch.float32, device="cpu")
    assert isinstance(tcache, tssm.SSMCache)
    assert tcache.state.shape == (cfg.n_layers, b, 2 * cfg.d_model,
                                  cfg.ssm_state)
    ptr = tcache.state.data_ptr()
    rcache, rl = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :t])},
                            rcache)
    out, tl = M.prefill(cfg, tp, {"tokens": torch.as_tensor(toks[:, :t])},
                        tcache)
    assert out.state.data_ptr() == ptr
    assert _rel(tl.numpy(), rl) <= RTOL
    _same_caches(tcache, rcache)
    for step in range(3):
        dec = {"tokens": toks[:, t + step:t + step + 1],
               "position": np.array([t + step], np.int32)}
        rcache, rl = RM.decode_step(rc, rp, rcache,
                                    {k: jnp.asarray(v) for k, v in
                                     dec.items()})
        _, tl = M.decode_step(cfg, tp, tcache,
                              {k: torch.as_tensor(v) for k, v in
                               dec.items()})
        assert _rel(tl.numpy(), rl) <= RTOL, step
        _same_caches(tcache, rcache)
    # the round trip through convert
    leaves = [np.asarray(x) for x in jax.tree.leaves(rcache)]
    back = convert.caches_from_numpy(cfg, leaves, device="cpu")
    for a, w in zip(convert.caches_to_numpy(back), leaves):
        np.testing.assert_array_equal(a, w)
    with pytest.raises(ValueError, match="2 .conv, state."):
        convert.caches_from_numpy(cfg, leaves[:1], device="cpu")


def _requests(mod, vocab, lens, news, temperature=0.0, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.Request(prompt=rng.integers(1, vocab - 1, n).astype(np.int32),
                        max_new_tokens=m, temperature=temperature)
            for n, m in zip(lens, news)]


def test_engine_greedy_and_temperature_match_reference(pair):
    rc, cfg, rp, tp = pair
    lens, news = (5, 11, 8), (6, 3, 5)
    rreq = _requests(RE, cfg.vocab, lens, news)
    treq = _requests(TE, cfg.vocab, lens, news)
    RE.Engine(rc, rp, max_batch=4, max_seq=24).generate(rreq)
    TE.Engine(cfg, tp, max_batch=4, max_seq=24).generate(treq)
    for r, t in zip(rreq, treq):
        np.testing.assert_array_equal(t.out_tokens, r.out_tokens)
    lens, news = (6, 9), (5, 5)
    rreq = _requests(RE, cfg.vocab, lens, news, temperature=0.8)
    treq = _requests(TE, cfg.vocab, lens, news, temperature=0.8)
    RE.Engine(rc, rp, max_batch=2, max_seq=20, seed=3).generate(rreq)
    key, draws = jax.random.key(3), []
    for _ in range(max(news)):
        key, k = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(
            k, (len(lens), cfg.vocab), jnp.float32)))
    it = iter(draws)
    TE.Engine(cfg, tp, max_batch=2, max_seq=20,
              gumbel=lambda shape: torch.from_numpy(np.array(next(it)))
              ).generate(treq)
    for r, t in zip(rreq, treq):
        np.testing.assert_array_equal(t.out_tokens, r.out_tokens)


def test_engine_greedy_matches_manual(pair):
    _, cfg, _, tp = pair
    eng = TE.Engine(cfg, tp, max_batch=2, max_seq=32)
    prompt = np.arange(5, 13, dtype=np.int32)
    [r] = eng.generate([TE.Request(prompt=prompt, max_new_tokens=4)])
    caches = M.make_caches(cfg, 1, 32, torch.float32, device="cpu")
    caches, logits = M.prefill(cfg, tp,
                               {"tokens": torch.as_tensor(prompt[None])},
                               caches)
    toks = [int(torch.argmax(logits[0, -1]))]
    for i in range(3):
        caches, logits = M.decode_step(cfg, tp, caches, {
            "tokens": torch.tensor([[toks[-1]]], dtype=torch.int32),
            "position": torch.tensor([len(prompt) + i], dtype=torch.int32)})
        toks.append(int(torch.argmax(logits[0, -1])))
    assert r.out_tokens.tolist() == toks


def test_bf16_weights_with_f32_cache_match_reference():
    """bf16 weights with the Engine's default f32 cache: the reference's
    SSM path runs (its carry stays bf16; the conv carry and the scan run
    in f32 by promotion), and the port's prefill and two decode steps
    agree with it within 2e-2, its cache staying f32; the Engine's greedy
    tokens are a manual loop's."""
    rc = dataclasses.replace(ref_arch(NAME).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_arch(NAME).reduced(), dtype="bfloat16")
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    assert tp["blocks"]["ssm"]["a_log"].dtype == torch.float32
    assert tp["blocks"]["ssm"]["in_proj"]["w"].dtype == torch.bfloat16
    b, t = 2, 10
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (b, t + 2)) \
        .astype(np.int32)
    rcache = RM.make_caches(rc, b, t + 2, jnp.float32)
    tcache = M.make_caches(cfg, b, t + 2, torch.float32, device="cpu")
    rcache, rl = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :t])},
                            rcache)
    _, tl = M.prefill(cfg, tp, {"tokens": torch.as_tensor(toks[:, :t])},
                      tcache)
    assert tcache.conv.dtype == torch.float32
    assert _rel(tl.numpy(), np.asarray(rl, np.float32)) <= 2e-2
    for step in range(2):
        dec = {"tokens": toks[:, t + step:t + step + 1],
               "position": np.array([t + step], np.int32)}
        rcache, rl = RM.decode_step(rc, rp, rcache,
                                    {k: jnp.asarray(v) for k, v in
                                     dec.items()})
        _, tl = M.decode_step(cfg, tp, tcache,
                              {k: torch.as_tensor(v) for k, v in
                               dec.items()})
        assert _rel(tl.numpy(), np.asarray(rl, np.float32)) <= 2e-2, step
    assert tcache.state.dtype == torch.float32


def test_launch_serve_smoke_on_cpu(capsys):
    out, _ = launch_serve.main(["--arch", NAME, "--smoke", "--device",
                                "cpu", "--requests", "3", "--new-tokens",
                                "4"])
    assert [len(r.out_tokens) for r in out] == [4, 4, 4]
    assert f"[serve] {NAME}-smoke: 3 reqs, 12 tokens" in \
        capsys.readouterr().out


def test_full_width_layout_matches_reference():
    """``param_skeleton`` of falcon-mamba-7b at full width (64 layers,
    7.005e9 parameters, on the meta device) has the reference's leaves
    (``jax.eval_shape`` of its ``init_model``) in order, with their shapes
    and dtypes (``a_log`` and ``d_skip`` f32 in a bf16 model); the
    reduced one its axes and its ``a_log``."""
    full = M.param_skeleton(get_arch(NAME))
    want = jax.eval_shape(lambda: RM.init_model(jax.random.key(0),
                                                ref_arch(NAME))[0])
    got = [(tuple(x.shape), str(x.dtype).split(".")[-1])
           for x in tree.leaves(full)]
    assert got == [(tuple(x.shape), str(x.dtype))
                   for x in jax.tree.leaves(want)]
    n = sum(x.numel() for x in tree.leaves(full))
    assert n == 7_005_278_208      # param_count() leaves out a_log & co.
    assert abs(get_arch(NAME).param_count() / 1e9 - 6.99) < 0.01
    rc, cfg = ref_arch(NAME).reduced(), get_arch(NAME).reduced()
    rp, raxes = RM.init_model(jax.random.key(0), rc)
    tp, taxes = M.init_model(0, cfg, device="cpu")
    assert taxes == raxes
    # log(1..n) in f32: torch's and XLA's log differ in the last bit
    np.testing.assert_allclose(tp["blocks"]["ssm"]["a_log"].numpy(),
                               np.asarray(rp["blocks"]["ssm"]["a_log"]),
                               rtol=2 ** -23, atol=0)


# ------------------------------------------- reference behaviours, pinned


def test_falcon_mamba_gets_sinusoidal_positions(pair):
    """Reference caveat: ``rope == "none"`` means sinusoidal absolute
    positions, added to the embeddings, a branch meant for whisper that a
    Mamba model takes too. Both packages add the same table in prefill
    and, from the device-side position, in decode."""
    rc, cfg, rp, tp = pair
    assert cfg.rope == rc.rope == "none"
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 7)).astype(
        np.int32)
    rx, _, _ = RM._embed_inputs(rc, rp, {"tokens": jnp.asarray(toks)})
    tx, _, _ = M._embed_inputs(cfg, tp, {"tokens": torch.as_tensor(toks)})
    table = tp["embed"]["table"].numpy()[toks]
    want = np.asarray(RM._sinusoid(7, cfg.d_model))
    assert np.abs(want).max() == 1.0
    want = np.broadcast_to(want, table.shape)
    np.testing.assert_allclose(np.asarray(rx) - table, want, atol=1e-6)
    np.testing.assert_allclose(tx.numpy() - table, want, atol=1e-6)
    got = M._sinusoid(1, cfg.d_model,
                      offset=torch.tensor(5, dtype=torch.int32))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(RM._sinusoid(1, cfg.d_model, offset=5)),
        rtol=1e-6, atol=1e-6)
