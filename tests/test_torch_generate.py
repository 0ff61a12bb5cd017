"""The port's serving path (KV caches, prefill, decode, the LLM Engine,
the serve launcher) against the JAX package on the four reduced dense
architectures (f32), from the reference's ``init_model(key(0))``
parameters carried over by ``convert.params_from_numpy``.

Tolerances: logits within 1e-5 relative (f32, another summation order);
f32 caches within 1e-5 of their largest entry, int8 codes equal and
their f32 scales within 1e-6 relative; ``_quantize`` bit-equal on the
same input; greedy and temperature tokens equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

DENSE = ("olmo-1b", "stablelm-1.6b", "llama3-405b", "command-r-plus-104b")
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    name = request.param
    rc, cfg = ref_arch(name).reduced(), get_arch(name).reduced()
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    return name, rc, cfg, rp, tp


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, t)).astype(np.int32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _same_caches(got, want, name):
    """Port caches (a KVCache) against the reference's: f32 buffers
    within RTOL of their largest entry, int8 codes equal, lengths
    equal, scales within 1e-6 relative."""
    g = convert.caches_to_numpy(got)
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(g) == len(w), name
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (name, i)
        if b.dtype == np.int8 or i == 2:
            np.testing.assert_array_equal(a, b, err_msg=f"{name} leaf {i}")
        else:
            tol = 1e-6 if i >= 3 else RTOL
            assert _rel(a, b) <= tol, (name, i, _rel(a, b))


def _requests(mod, vocab, lens, news, temperature=0.0, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.Request(prompt=rng.integers(1, vocab - 1, n).astype(np.int32),
                        max_new_tokens=m, temperature=temperature)
            for n, m in zip(lens, news)]


# ---------------------------------------------------------------- int8


def test_quantize_bit_equal_including_ties():
    """Codes and scales equal the reference's bit for bit, on random rows
    and on rows whose entries land exactly on a half-integer multiple of
    their scale (round half to even in both)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 3
    # rows of ties: the max 127 * 0.25 fixes the scale; entries at
    # (k + 1/2) * scale divide back to k + 1/2 exactly where f32 allows
    ties = np.zeros((1, 1, 1, 16), np.float32)
    ties[..., 0] = 127 * 0.25
    scale = np.float32(ties[..., 0].max()) / np.float32(127.0) \
        + np.float32(1e-8)
    halves = np.arange(15, dtype=np.float32) - 7 + np.float32(0.5)
    ties[0, 0, 0, 1:] = halves * scale
    assert np.sum(ties[0, 0, 0, 1:] / scale == halves) >= 8
    for arr in (x, ties):
        rq, rs = RA._quantize(jnp.asarray(arr))
        tq, ts = TA._quantize(torch.as_tensor(arr))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    # ties to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    codes = tq.numpy()[0, 0, 0, 1:]
    exact = ties[0, 0, 0, 1:] / scale == halves
    np.testing.assert_array_equal(codes[exact],
                                  np.round(halves[exact]).astype(np.int8))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("onehot", [False, True])
def test_cache_update_buffers(quantized, onehot):
    """A write of 1 (one-hot or slice) or 4 tokens into a cache already
    holding 3, and one that runs past the end (clamped as
    ``dynamic_update_slice`` clamps): the buffers equal the reference's,
    written in place in the port."""
    rng = np.random.default_rng(1)
    b, s, hkv, d = 2, 8, 2, 4
    for t_new, start in ((1, 3), (4, 3), (3, 7)):
        if onehot and t_new != 1:
            continue
        rc = RA.make_cache(b, s, hkv, d, jnp.float32, quantized=quantized)
        tc = TA.make_cache(b, s, hkv, d, torch.float32, quantized=quantized,
                           device="cpu")
        rc = rc._replace(length=jnp.asarray(start, jnp.int32))
        tc.length.fill_(start)
        kn = rng.standard_normal((b, t_new, hkv, d)).astype(np.float32)
        vn = rng.standard_normal((b, t_new, hkv, d)).astype(np.float32)
        want = RA.cache_update(rc, jnp.asarray(kn), jnp.asarray(vn),
                               onehot=onehot)
        got = TA.cache_update(tc, torch.as_tensor(kn), torch.as_tensor(vn),
                              onehot=onehot)
        assert got.k.data_ptr() == tc.k.data_ptr()
        for g, w in zip(convert.caches_to_numpy(got),
                        [np.asarray(x) for x in want]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("quantized", [False, True])
def test_sdpa_decode_gqa_window(quantized):
    """One query of 8 heads over 2 kv heads against a cache of length 13
    of 20, with and without a window of 5."""
    rng = np.random.default_rng(2)
    b, s, hkv, h, d = 2, 20, 2, 8, 16
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    rc = RA.make_cache(b, s, hkv, d, jnp.float32, quantized=quantized)
    tc = TA.make_cache(b, s, hkv, d, torch.float32, quantized=quantized,
                       device="cpu")
    rc = RA.cache_update(rc, jnp.asarray(k[:, :13]), jnp.asarray(v[:, :13]))
    TA.cache_update(tc, torch.as_tensor(k[:, :13]), torch.as_tensor(v[:, :13]))
    outs = []
    for window in (None, 5):
        want = RA._sdpa_decode(jnp.asarray(q), rc, window=window)
        got = TA._sdpa_decode(torch.as_tensor(q), tc, window=window)
        tol = 1e-2 if quantized else 1e-6   # bf16 p @ v on int8 caches
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) \
            <= tol, window
        outs.append(got.float().numpy())
    assert not np.allclose(outs[0], outs[1])


# ------------------------------------------------------- model entry points


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_decode_logits_and_caches(pair, quantized):
    name, rc, cfg, rp, tp = pair
    b, t = 2, 12
    toks = _tokens(cfg.vocab, b, t + 2, seed=3)
    rcache = RM.make_caches(rc, b, t + 4, jnp.float32, quantized_kv=quantized)
    tcache = M.make_caches(cfg, b, t + 4, torch.float32,
                           quantized_kv=quantized, device="cpu")
    rcache, rl = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :t])},
                            rcache)
    out, tl = M.prefill(cfg, tp, {"tokens": torch.as_tensor(toks[:, :t])},
                        tcache)
    assert out.k.data_ptr() == tcache.k.data_ptr()
    assert tl.shape == (b, 1, cfg.vocab) and tl.dtype == torch.float32
    assert _rel(tl.numpy(), rl) <= RTOL, name
    _same_caches(tcache, rcache, name)
    for step in range(2):
        dec = {"tokens": toks[:, t + step:t + step + 1],
               "position": np.array([t + step], np.int32)}
        rcache, rl = RM.decode_step(rc, rp, rcache,
                                    {k: jnp.asarray(v) for k, v in
                                     dec.items()})
        _, tl = M.decode_step(cfg, tp, tcache,
                              {k: torch.as_tensor(v) for k, v in
                               dec.items()})
        assert _rel(tl.numpy(), rl) <= RTOL, (name, step)
        _same_caches(tcache, rcache, name)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_resumes_from_reference_caches(pair, quantized):
    """The reference's prefill caches, carried over by
    ``caches_from_numpy``, resume in the port's decode_step."""
    name, rc, cfg, rp, tp = pair
    b, t = 2, 10
    toks = _tokens(cfg.vocab, b, t + 1, seed=4)
    rcache = RM.make_caches(rc, b, t + 3, jnp.float32, quantized_kv=quantized)
    rcache, _ = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :t])},
                           rcache)
    tcache = convert.caches_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rcache)], device="cpu")
    assert tcache.length.dtype == torch.int32
    assert (tcache.k_scale is not None) == quantized
    _same_caches(tcache, rcache, name)
    dec = {"tokens": toks[:, t:], "position": np.array([t], np.int32)}
    rcache, rl = RM.decode_step(rc, rp, rcache,
                                {k: jnp.asarray(v) for k, v in dec.items()})
    _, tl = M.decode_step(cfg, tp, tcache,
                          {k: torch.as_tensor(v) for k, v in dec.items()})
    assert _rel(tl.numpy(), rl) <= RTOL, name
    _same_caches(tcache, rcache, name)


def test_caches_from_numpy_rejects_other_shapes():
    cfg = get_arch("olmo-1b").reduced()
    leaves = convert.caches_to_numpy(M.make_caches(cfg, 2, 8, torch.float32,
                                                   device="cpu"))
    with pytest.raises(ValueError, match="3 .* or 5"):
        convert.caches_from_numpy(cfg, leaves[:2], device="cpu")
    with pytest.raises(ValueError, match="cache shape"):
        convert.caches_from_numpy(cfg, [leaves[0][:, :, :, :1]] + leaves[1:],
                                  device="cpu")


def test_serve_steps_smoke_and_consistency(pair):
    """Counterpart of tests/test_models.py's: prefill of T-1 tokens and
    one decode step against prefill of all T, within 2e-2 relative."""
    name, rc, cfg, rp, tp = pair
    T, B = 16, 2
    toks = torch.as_tensor(_tokens(cfg.vocab, B, T, seed=3))
    prefill = steps.build_prefill_step(cfg)
    decode = steps.build_decode_step(cfg)
    c_full = M.make_caches(cfg, B, T + 4, torch.float32, device="cpu")
    _, logits_full = prefill(tp, {"tokens": toks}, c_full)
    assert logits_full.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits_full).all())
    c_part = M.make_caches(cfg, B, T + 4, torch.float32, device="cpu")
    c_part, _ = prefill(tp, {"tokens": toks[:, :-1]}, c_part)
    _, logits_dec = decode(tp, c_part, {
        "tokens": toks[:, -1:],
        "position": torch.full((1,), T - 1, dtype=torch.int32)})
    assert _rel(logits_dec.numpy(), logits_full.numpy()) < 2e-2, name


def test_serve_steps_take_no_mesh():
    """A mesh without a plan (or a plan without a mesh) is refused; the
    steps over a mesh are held in tests/test_torch_parallel.py."""
    cfg = get_arch("olmo-1b").reduced()
    for build in (steps.build_prefill_step, steps.build_decode_step):
        with pytest.raises(ValueError, match="together"):
            build(cfg, mesh=object())
        with pytest.raises(ValueError, match="together"):
            build(cfg, plan=object())


def test_bf16_weights_with_f32_cache_decode():
    """The Engine's default f32 cache under bf16 weights: the reference's
    decode_step raises (its scan carry would turn f32); the port keeps the
    residual stream bf16, and decode agrees with prefill within 2e-2."""
    name = "olmo-1b"
    rc = dataclasses.replace(ref_arch(name).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype="bfloat16")
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    T, B = 12, 2
    toks = _tokens(cfg.vocab, B, T, seed=6)
    rcache = RM.make_caches(rc, B, T + 2, jnp.float32)
    rcache, rl = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :-1])},
                            rcache)
    with pytest.raises(TypeError, match="carry"):
        RM.decode_step(rc, rp, rcache,
                       {"tokens": jnp.asarray(toks[:, -1:]),
                        "position": jnp.asarray([T - 1], jnp.int32)})
    tc = M.make_caches(cfg, B, T + 2, torch.float32, device="cpu")
    tc, tl = M.prefill(cfg, tp, {"tokens": torch.as_tensor(toks[:, :-1])},
                       tc)
    assert tc.k.dtype == torch.float32
    assert _rel(tl.numpy(), np.asarray(rl, np.float32)) <= 2e-2
    _, ld = M.decode_step(cfg, tp, tc, {
        "tokens": torch.as_tensor(toks[:, -1:]),
        "position": torch.full((1,), T - 1, dtype=torch.int32)})
    full = M.make_caches(cfg, B, T + 2, torch.float32, device="cpu")
    _, lf = M.prefill(cfg, tp, {"tokens": torch.as_tensor(toks)}, full)
    assert _rel(ld.numpy(), lf.numpy()) < 2e-2


# ------------------------------------------------------------------ Engine


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_greedy_matches_reference(pair, quantized):
    """Mixed prompt lengths (left-padded) and per-request max_new_tokens:
    the port's greedy tokens equal the reference's."""
    name, rc, cfg, rp, tp = pair
    lens, news = (5, 11, 8), (6, 3, 5)
    rreq = _requests(RE, cfg.vocab, lens, news)
    treq = _requests(TE, cfg.vocab, lens, news)
    RE.Engine(rc, rp, max_batch=4, max_seq=24,
              quantized_kv=quantized).generate(rreq)
    TE.Engine(cfg, tp, max_batch=4, max_seq=24,
              quantized_kv=quantized).generate(treq)
    for r, t in zip(rreq, treq):
        assert t.out_tokens.dtype == np.int32
        np.testing.assert_array_equal(t.out_tokens, r.out_tokens,
                                      err_msg=name)


def test_categorical_is_argmax_of_gumbel():
    """Under this jax, ``categorical(k, l) == argmax(l + gumbel(k,
    l.shape))``: the form the port samples with the draws replayed."""
    logits = jnp.asarray(np.random.default_rng(7).standard_normal((3, 256)),
                         jnp.float32)
    for i in range(8):
        k = jax.random.key(i)
        want = jax.random.categorical(k, logits)
        g = jax.random.gumbel(k, logits.shape, jnp.float32)
        np.testing.assert_array_equal(np.asarray(jnp.argmax(logits + g, -1)),
                                      np.asarray(want))


def test_engine_temperature_matches_reference_draws(pair):
    """T = 0.8: the reference's Gumbel draws, replayed from its key as it
    splits it a step, give the reference's tokens in the port."""
    name, rc, cfg, rp, tp = pair
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

    def gumbel(shape):
        g = torch.from_numpy(np.array(next(it)))
        assert tuple(g.shape) == tuple(shape)
        return g

    TE.Engine(cfg, tp, max_batch=2, max_seq=20, gumbel=gumbel).generate(treq)
    for r, t in zip(rreq, treq):
        np.testing.assert_array_equal(t.out_tokens, r.out_tokens,
                                      err_msg=name)


def test_engine_default_draws_are_seeded():
    cfg = get_arch("olmo-1b").reduced()
    params, _ = M.init_model(0, cfg, device="cpu")
    outs = []
    for seed in (1, 1, 2):
        reqs = _requests(TE, cfg.vocab, (7, 4), (6, 6), temperature=1.0)
        TE.Engine(cfg, params, max_batch=2, max_seq=16,
                  seed=seed).generate(reqs)
        outs.append(np.stack([r.out_tokens for r in reqs]))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])


def test_engine_greedy_matches_manual():
    """Counterpart of tests/test_substrates.py's: the Engine's tokens are
    a manual prefill + decode_step loop's."""
    cfg = get_arch("stablelm-1.6b").reduced()
    params, _ = M.init_model(0, cfg, device="cpu")
    eng = TE.Engine(cfg, params, max_batch=2, max_seq=64)
    prompt = np.arange(5, 13, dtype=np.int32)
    [r] = eng.generate([TE.Request(prompt=prompt, max_new_tokens=4)])
    caches = M.make_caches(cfg, 1, 64, torch.float32, device="cpu")
    caches, logits = M.prefill(cfg, params,
                               {"tokens": torch.as_tensor(prompt[None])},
                               caches)
    toks = [int(torch.argmax(logits[0, -1]))]
    for i in range(3):
        dec = {"tokens": torch.tensor([[toks[-1]]], dtype=torch.int32),
               "position": torch.tensor([len(prompt) + i],
                                        dtype=torch.int32)}
        caches, logits = M.decode_step(cfg, params, caches, dec)
        toks.append(int(torch.argmax(logits[0, -1])))
    assert r.out_tokens.tolist() == toks


def test_engine_rejects_too_long_requests():
    cfg = get_arch("olmo-1b").reduced()
    params, _ = M.init_model(0, cfg, device="cpu")
    eng = TE.Engine(cfg, params, max_batch=1, max_seq=10)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate([TE.Request(prompt=np.arange(1, 9, dtype=np.int32),
                                 max_new_tokens=4)])


def test_generate_trace_count_contract():
    """generate_trace_count rises once per new (cfg, shapes) signature of
    the prefill and decode drivers and never when one repeats, across
    Engines."""
    cfg = get_arch("llama3-405b").reduced()
    params, _ = M.init_model(0, cfg, device="cpu")

    def serve(b, max_seq=32, **kw):
        reqs = _requests(TE, cfg.vocab, (6,) * b, (3,) * b)
        TE.Engine(cfg, params, max_batch=4, max_seq=max_seq,
                  **kw).generate(reqs)

    before = TE.generate_trace_count()
    serve(2)
    first = TE.generate_trace_count()
    assert first == before + 2                # prefill and decode
    serve(2)                                  # a new Engine, same shapes
    assert TE.generate_trace_count() == first
    serve(3)                                  # a new batch size
    assert TE.generate_trace_count() == first + 2
    serve(3, quantized_kv=True)               # new cache leaves
    assert TE.generate_trace_count() == first + 4
    serve(3, quantized_kv=True)
    assert TE.generate_trace_count() == first + 4


def test_left_padding_couples_requests_in_both_packages():
    """Reference caveat (ROADMAP Queue 3): prompts are left-padded with
    token 0 and prefilled without a pad mask, so a request's output
    depends on the lengths of the other prompts in its batch. Both
    packages give the same tokens alone and beside a longer prompt, and
    in both the short prompt's tokens change."""
    rc, cfg = ref_arch("olmo-1b").reduced(), get_arch("olmo-1b").reduced()
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    short = np.array([17, 3, 99, 42], np.int32)
    long_ = np.arange(30, 44, dtype=np.int32)
    got = {}
    for pkg, eng in (("ref", RE.Engine(rc, rp, max_batch=2, max_seq=32)),
                     ("port", TE.Engine(cfg, tp, max_batch=2, max_seq=32))):
        mod = RE if pkg == "ref" else TE
        alone = eng.generate([mod.Request(prompt=short, max_new_tokens=8)])
        paired = eng.generate([mod.Request(prompt=short, max_new_tokens=8),
                               mod.Request(prompt=long_, max_new_tokens=8)])
        got[pkg] = (alone[0].out_tokens, paired[0].out_tokens)
    for a, b in zip(got["ref"], got["port"]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(*got["port"])


# ---------------------------------------------------------------- launcher


def test_launch_serve_smoke_on_cpu(capsys):
    out, stats = launch_serve.main(["--arch", "olmo-1b", "--smoke",
                                    "--device", "cpu", "--requests", "3",
                                    "--new-tokens", "5", "--int8-kv",
                                    "--kv-select"])
    assert [len(r.out_tokens) for r in out] == [5, 5, 5]
    assert stats["uncertified"] == 0
    text = capsys.readouterr().out
    assert "[serve] olmo-1b-smoke: 3 reqs, 15 tokens" in text
    assert "[kv-select]" in text


def test_launch_serve_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "olmo-1b"])
