"""The port's MoE family (models/moe.py and its place in models/model.py)
against the JAX package on the reduced arctic-480b (top-2, dense
residual) and llama4-maverick (top-1, shared expert, a dense block then a
MoE block a unit) configs, f32, from the reference's
``init_model(key(0))`` parameters carried over by
``convert.params_from_numpy``.

Tolerances: ``moe_apply``'s output and the logits within 1e-5 relative
(f32, another summation order), ``aux`` within 1e-6 relative, dispatch
masks equal and the combine gates within 1e-6; block gradients within
1e-5 and full-model gradients within 1e-4 of each leaf's largest entry;
greedy and temperature tokens equal. The reference's routing masks are
read off its ``einsum`` operands (a spy on the module's ``jnp``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

MOE = ("arctic-480b", "llama4-maverick-400b-a17b")
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, **changes):
    rc = dataclasses.replace(ref_arch(name).reduced(), **changes)
    cfg = dataclasses.replace(get_arch(name).reduced(), **changes)
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    return rc, cfg, rp, tp


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    return (request.param,) + _pair(request.param)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, t)).astype(np.int32)


def _moe_block(params):
    """Unit 0's MoE sub-block (the last of a unit), of either package."""
    units = params["units"]
    last = units[sorted(units)[-1]]
    if isinstance(jax.tree.leaves(last)[0], torch.Tensor):
        return tree.map(lambda x: x[0], last)
    return jax.tree.map(lambda x: x[0], last)


class _EinsumSpy:
    """Stands in for ``jnp`` in the reference's moe module and records the
    dispatch and combine operands of its einsums where they are concrete
    (not under the model's scan)."""

    def __init__(self):
        self.masks = {"dispatch": [], "combine": []}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if isinstance(ops[1], jax.core.Tracer):
            pass
        elif spec == "ngd,ngec->encd":
            self.masks["dispatch"].append(np.asarray(ops[1]))
        elif spec == "encd,ngec->ngd":
            self.masks["combine"].append(np.asarray(ops[1]))
        return jnp.einsum(spec, *ops, **kw)


@pytest.fixture
def spy(monkeypatch):
    """(the reference's recorded masks, the port's recorded Routes)."""
    s = _EinsumSpy()
    monkeypatch.setattr(rmoe, "jnp", s)
    routes = []
    real = tmoe._route

    def recording(*a, **kw):
        r = real(*a, **kw)
        routes.append(r)
        return r

    monkeypatch.setattr(tmoe, "_route", recording)
    return s.masks, routes


# ------------------------------------------------------------- moe_apply


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("bt", [(2, 18), (3, 2000)])
def test_moe_apply_matches_reference(name, cf, dropless, bt, spy):
    """Capacity factors 8 (no drop) and 0.5 (drops), dropless on and off,
    18 tokens a row (one group of 36) and 6000 tokens (the group halves
    from 4096 to 16): y, aux, the dispatch masks and the gates."""
    rc, cfg, rp, tp = _pair(name, moe_capacity_factor=cf)
    rb, tb = _moe_block(rp), _moe_block(tp)
    x = np.random.default_rng(1).standard_normal(
        bt + (cfg.d_model,)).astype(np.float32)
    ry, raux = rmoe.moe_apply(rc, rb["moe"], jnp.asarray(x),
                              dropless=dropless)
    ty, taux = tmoe.moe_apply(cfg, tb["moe"], torch.as_tensor(x),
                              dropless=dropless)
    assert _rel(ty.numpy(), ry) <= RTOL
    assert abs(float(taux) - float(raux)) <= 1e-6 * abs(float(raux))
    masks, routes = spy
    [r] = routes
    g, cap = tmoe.group_and_capacity(cfg, bt[0] * bt[1], dropless=dropless)
    assert (r.group, r.cap) == (g, cap)
    if bt[1] == 2000:
        assert g == 16
    want_d, want_c = masks["dispatch"][0], masks["combine"][0]
    assert r.dispatch.shape == want_d.shape
    np.testing.assert_array_equal(r.dispatch.numpy(), want_d)
    np.testing.assert_array_equal(r.combine.numpy() > 0, want_c > 0)
    np.testing.assert_allclose(r.combine.numpy(), want_c, rtol=1e-6,
                               atol=0)
    kept = float(want_d.sum()) / (bt[0] * bt[1] * cfg.moe_top_k)
    if dropless or cf == 8.0:
        assert kept == 1.0
    else:
        assert kept < 1.0


@pytest.mark.parametrize("name", MOE)
def test_block_gradients_match_jax_grad(name):
    """A MoE block in train mode, ``sum(out^2) + aux``: the gradients of
    the router, the experts and the shared expert / dense residual MLP
    (every leaf of the block) against ``jax.grad``, at capacity 0.5."""
    rc, cfg, rp, tp = _pair(name, moe_capacity_factor=0.5)
    rb, tb = _moe_block(rp), _moe_block(tp)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16)[None, :]

    def rf(p):
        out, _, aux = RM.dense_block_apply(rc, p, jnp.asarray(x),
                                           mode="train",
                                           positions=jnp.asarray(pos))
        return jnp.sum(out * out) + aux

    want = jax.grad(rf)(rb)
    leaves, spec = tree.flatten(tb)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    out, _, aux = M.dense_block_apply(cfg, tree.unflatten(spec, xs),
                                      torch.as_tensor(x),
                                      positions=torch.as_tensor(pos),
                                      mode="train")
    got = torch.autograd.grad((out * out).sum() + aux, xs)
    wl = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(wl) == len(got)
    names = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert "moe/router/w" in names and any(n.startswith("mlp/")
                                           for n in names)
    for n, g, w in zip(names, got, wl):
        assert np.abs(w).max() > 0, n
        err = np.abs(g.numpy() - w).max()
        assert err <= RTOL * np.abs(w).max(), (name, n, err)


def test_router_gradients_nonzero_as_reference_test():
    """Counterpart of tests/test_models.py's router-gradient test."""
    cfg = get_arch("llama4-maverick-400b-a17b").reduced()
    params, _ = M.init_model(0, cfg, device="cpu")
    p = tree.map(lambda x: x[0].detach().clone().requires_grad_(True),
                 params["units"]["sub1"]["moe"])
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, 8, 64)).astype(np.float32))
    y, aux = tmoe.moe_apply(cfg, p, x)
    ((y * y).sum() + aux).backward()
    assert float(p["router"]["w"].grad.abs().sum()) > 0


# ------------------------------------------------------- model entry points


def test_loss_and_grads_match_reference(pair):
    name, rc, cfg, rp, tp = pair
    toks = _tokens(cfg.vocab, 2, 33, seed=0)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "labels": torch.as_tensor(toks[:, 1:])}
    (rl, rm), rg = jax.value_and_grad(lambda p: RM.loss_fn(rc, p, rb),
                                      has_aux=True)(rp)
    (tl, tm), tg = M.value_and_grad(cfg, tp, tb)
    assert abs(float(tl) - float(rl)) <= 2e-5 * abs(float(rl)), name
    assert float(rm["aux"]) > 0
    assert abs(float(tm["aux"]) - float(rm["aux"])) <= \
        1e-6 * float(rm["aux"])
    tl2, tm2 = M.loss_fn(cfg, tp, tb)
    assert float(tl2) == float(tl) and float(tm2["aux"]) == \
        float(tm["aux"])
    want = [np.asarray(x) for x in jax.tree.leaves(rg)]
    got = convert.params_to_numpy(tg)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, i, err)
    mod = M.LM(cfg, tp)
    assert torch.equal(mod(tb)[0], tl2)


def _same_caches(got, want, name):
    g = convert.caches_to_numpy(got)
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(g) == len(w), name
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (name, i)
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{name} leaf {i}")
        else:
            assert _rel(a, b) <= RTOL, (name, i, _rel(a, b))


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_decode_logits_and_caches(pair, quantized):
    """Prefill (drops at capacity 8: none) and three dropless decode
    steps: logits and every unit's caches, written in place."""
    name, rc, cfg, rp, tp = pair
    b, t = 2, 12
    toks = _tokens(cfg.vocab, b, t + 3, seed=3)
    rcache = RM.make_caches(rc, b, t + 4, jnp.float32,
                            quantized_kv=quantized)
    tcache = M.make_caches(cfg, b, t + 4, torch.float32,
                           quantized_kv=quantized, device="cpu")
    assert sorted(tcache) == [f"sub{i}" for i in range(cfg.moe_every)]
    k0 = tcache["sub0"].k.data_ptr()
    rcache, rl = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :t])},
                            rcache)
    out, tl = M.prefill(cfg, tp, {"tokens": torch.as_tensor(toks[:, :t])},
                        tcache)
    assert out["sub0"].k.data_ptr() == k0
    assert _rel(tl.numpy(), rl) <= RTOL, name
    _same_caches(tcache, rcache, name)
    for step in range(3):
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
def test_caches_round_trip_through_convert(pair, quantized):
    """The reference's prefill caches carried over by
    ``caches_from_numpy`` resume in the port's decode_step, and
    ``caches_to_numpy`` gives the leaves back."""
    name, rc, cfg, rp, tp = pair
    b, t = 2, 10
    toks = _tokens(cfg.vocab, b, t + 1, seed=4)
    rcache = RM.make_caches(rc, b, t + 3, jnp.float32,
                            quantized_kv=quantized)
    rcache, _ = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :t])},
                           rcache)
    leaves = [np.asarray(x) for x in jax.tree.leaves(rcache)]
    tcache = convert.caches_from_numpy(cfg, leaves, device="cpu")
    assert tcache["sub0"].length.dtype == torch.int32
    for a, w in zip(convert.caches_to_numpy(tcache), leaves):
        np.testing.assert_array_equal(a, w)
    dec = {"tokens": toks[:, t:], "position": np.array([t], np.int32)}
    rcache, rl = RM.decode_step(rc, rp, rcache,
                                {k: jnp.asarray(v) for k, v in dec.items()})
    _, tl = M.decode_step(cfg, tp, tcache,
                          {k: torch.as_tensor(v) for k, v in dec.items()})
    assert _rel(tl.numpy(), rl) <= RTOL, name
    _same_caches(tcache, rcache, name)
    with pytest.raises(ValueError, match="leaves"):
        convert.caches_from_numpy(cfg, leaves[:-1], device="cpu")
    with pytest.raises(ValueError, match="cache shape"):
        convert.caches_from_numpy(cfg, [leaves[0][..., :1]]
                                  + leaves[1:], device="cpu")


def _requests(mod, vocab, lens, news, temperature=0.0, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.Request(prompt=rng.integers(1, vocab - 1, n).astype(np.int32),
                        max_new_tokens=m, temperature=temperature)
            for n, m in zip(lens, news)]


def test_engine_greedy_matches_reference(pair):
    name, rc, cfg, rp, tp = pair
    lens, news = (5, 11, 8), (6, 3, 5)
    rreq = _requests(RE, cfg.vocab, lens, news)
    treq = _requests(TE, cfg.vocab, lens, news)
    RE.Engine(rc, rp, max_batch=4, max_seq=24).generate(rreq)
    TE.Engine(cfg, tp, max_batch=4, max_seq=24).generate(treq)
    for r, t in zip(rreq, treq):
        np.testing.assert_array_equal(t.out_tokens, r.out_tokens,
                                      err_msg=name)


def test_engine_temperature_matches_reference_draws(pair):
    """T = 0.8 with the reference's Gumbel draws replayed from its key."""
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
    TE.Engine(cfg, tp, max_batch=2, max_seq=20,
              gumbel=lambda shape: torch.from_numpy(np.array(next(it)))
              ).generate(treq)
    for r, t in zip(rreq, treq):
        np.testing.assert_array_equal(t.out_tokens, r.out_tokens,
                                      err_msg=name)


def test_engine_greedy_matches_manual(pair):
    """The Engine's tokens are a manual prefill + decode_step loop's."""
    name, rc, cfg, rp, tp = pair
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


@pytest.mark.parametrize("name", MOE)
def test_launch_serve_smoke_on_cpu(name, capsys):
    out, _ = launch_serve.main(["--arch", name, "--smoke", "--device",
                                "cpu", "--requests", "3", "--new-tokens",
                                "4"])
    assert [len(r.out_tokens) for r in out] == [4, 4, 4]
    assert f"[serve] {name}-smoke: 3 reqs, 12 tokens" in \
        capsys.readouterr().out


@pytest.mark.parametrize("name", MOE)
def test_full_width_layout_matches_reference(name):
    """``param_skeleton`` at full width (meta tensors) has the reference's
    leaves (``jax.eval_shape`` of its ``init_model``: no allocation), in
    order, with their shapes and dtypes (the router f32 in a bf16 model),
    and the reduced ``init_model`` the reference's key paths and axes."""
    full = M.param_skeleton(get_arch(name))
    want = jax.eval_shape(lambda: RM.init_model(jax.random.key(0),
                                                ref_arch(name))[0])
    got = [(tuple(x.shape), str(x.dtype).split(".")[-1])
           for x in tree.leaves(full)]
    assert got == [(tuple(x.shape), str(x.dtype))
                   for x in jax.tree.leaves(want)]
    assert ("float32" in {d for _, d in got}) and \
        ("bfloat16" in {d for _, d in got})
    rc, cfg = ref_arch(name).reduced(), get_arch(name).reduced()
    rp, raxes = RM.init_model(jax.random.key(0), rc)
    tp, taxes = M.init_model(0, cfg, device="cpu")
    assert taxes == raxes
    rpaths = ["".join(f"/{k.key}" for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(rp)[0]]
    tpaths = ["".join(f"/{k}" for k in path) for path in _paths(tp)]
    assert tpaths == rpaths


def _paths(node, prefix=()):
    if isinstance(node, dict):
        out = []
        for k in sorted(node):
            out += _paths(node[k], prefix + (k,))
        return out
    return [prefix]


def test_family_sizes_at_full_width():
    """The cuts the card runs: llama4 at one unit (2 layers) and arctic at
    one layer, counted on the meta skeleton."""
    for name, layers, billions in (("llama4-maverick-400b-a17b", 2, 18.55),
                                   ("arctic-480b", 1, 14.07)):
        cfg = dataclasses.replace(get_arch(name), n_layers=layers)
        n = sum(x.numel() for x in tree.leaves(M.param_skeleton(cfg)))
        assert abs(n / 1e9 - billions) < 0.01, (name, n)
        assert abs(cfg.param_count() / 1e9 - billions) < 0.01


def test_waiting_families_raise():
    """The families that waited for their slice now build their caches,
    with the reference's leaves and shapes (``jax.eval_shape`` of its
    ``make_caches``); a family the model does not know still raises."""
    for name in ("zamba2-1.2b", "whisper-medium", "qwen2-vl-2b"):
        cfg = dataclasses.replace(get_arch(name).reduced(), n_layers=5)
        rc = dataclasses.replace(ref_arch(name).reduced(), n_layers=5)
        got = tree.leaves(M.make_caches(cfg, 1, 8, device="meta"))
        want = jax.tree.leaves(jax.eval_shape(
            lambda: RM.make_caches(rc, 1, 8)))
        assert [tuple(x.shape) for x in got] == \
            [tuple(x.shape) for x in want], name
        with pytest.raises(ValueError, match="unknown family"):
            M.make_caches(dataclasses.replace(cfg, family="x"), 1, 8,
                          device="cpu")


# ------------------------------------------- reference behaviours, pinned


def test_expert_fan_in_is_the_expert_count():
    """Reference caveat: ``moe_init`` draws the stacked experts with
    ``trunc_normal``'s default fan-in, ``shape[0]`` = E, so their std is
    0.88 / sqrt(E), not 0.88 / sqrt(d). Both packages draw so."""
    name = "llama4-maverick-400b-a17b"
    rc = dataclasses.replace(ref_arch(name).reduced(), moe_experts=16)
    cfg = dataclasses.replace(get_arch(name).reduced(), moe_experts=16)
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp, _ = M.init_model(0, cfg, device="cpu")
    trunc = 0.8796   # std of a normal truncated to [-2, 2]
    for leaf in ("wi", "wg", "wo"):
        for w in (np.asarray(rp["units"]["sub1"]["moe"][leaf]),
                  tp["units"]["sub1"]["moe"][leaf].numpy()):
            std = float(w.std())
            assert abs(std - trunc / 16 ** 0.5) < 0.01, (leaf, std)
    assert tp["units"]["sub1"]["moe"]["router"]["w"].dtype == torch.float32


@pytest.mark.parametrize("name", MOE)
def test_embedding_fan_in_is_the_vocab(name):
    """Reference caveat: ``embed_init`` draws the table with
    ``trunc_normal``'s default fan-in, ``shape[0]`` = vocab, so a token's
    embedding has std 0.88 / sqrt(vocab) (0.0020 at llama4's 202048),
    small beside the blocks' outputs, which the tokens share through
    attention: with random weights the router sees nearly one direction
    and one expert takes most tokens. Both packages draw so."""
    rc = dataclasses.replace(ref_arch(name).reduced(), vocab=4096)
    cfg = dataclasses.replace(get_arch(name).reduced(), vocab=4096)
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp, _ = M.init_model(0, cfg, device="cpu")
    trunc = 0.8796   # std of a normal truncated to [-2, 2]
    for w in (np.asarray(rp["embed"]["table"]),
              tp["embed"]["table"].numpy()):
        assert w.shape == (4096, cfg.d_model)
        assert abs(float(w.std()) * 4096 ** 0.5 / trunc - 1) < 0.02


def test_groups_shrink_and_capacity_collapses(spy):
    """Reference caveat: the group halves until it divides the token
    count, and the capacity shrinks with it. llama4 at full width on 8
    prompts padded to 920 tokens (7360 tokens): g = 64, cap = 1; on 8 x
    1024 tokens: two groups of 4096, cap 40 (arctic's 80). Both packages
    route so (llama4's 128 experts at the reduced width), and a quarter of
    the tokens lose their slot where 2 groups of 4096 would keep almost
    all."""
    full = get_arch("llama4-maverick-400b-a17b")
    assert tmoe.group_and_capacity(full, 7360) == (64, 1)
    assert tmoe.group_and_capacity(full, 8 * 1024) == (4096, 40)
    assert tmoe.group_and_capacity(get_arch("arctic-480b"), 8 * 1024) == \
        (4096, 80)
    assert tmoe.group_and_capacity(full, 8, dropless=True) == (8, 8)
    rc, cfg, rp, tp = _pair("llama4-maverick-400b-a17b", moe_experts=128,
                            moe_capacity_factor=1.25)
    x = np.random.default_rng(3).standard_normal(
        (8, 920, cfg.d_model)).astype(np.float32)
    rmoe.moe_apply(rc, _moe_block(rp)["moe"], jnp.asarray(x))
    tmoe.moe_apply(cfg, _moe_block(tp)["moe"], torch.as_tensor(x))
    masks, routes = spy
    assert masks["dispatch"][0].shape == (115, 64, 128, 1)
    np.testing.assert_array_equal(routes[0].dispatch.numpy(),
                                  masks["dispatch"][0])
    dropped = 1 - float(masks["dispatch"][0].sum()) / 7360
    assert 0.15 < dropped < 0.35, dropped


def test_groups_span_requests():
    """Reference caveat: tokens are grouped over (batch, time), so under
    capacity pressure one request's output depends on another request's
    tokens. In both packages, changing row 1 changes row 0's output, and
    the port equals the reference either way."""
    rc, cfg, rp, tp = _pair("arctic-480b", moe_capacity_factor=0.5)
    rb, tb = _moe_block(rp), _moe_block(tp)
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    x2 = x.copy()
    x2[1] = np.random.default_rng(5).standard_normal((16, cfg.d_model))
    outs = {}
    for pkg in ("ref", "port"):
        row0 = []
        for arr in (x, x2):
            if pkg == "ref":
                y, _ = rmoe.moe_apply(rc, rb["moe"], jnp.asarray(arr))
                row0.append(np.asarray(y)[0])
            else:
                y, _ = tmoe.moe_apply(cfg, tb["moe"], torch.as_tensor(arr))
                row0.append(y.numpy()[0])
        outs[pkg] = row0
        assert not np.allclose(row0[0], row0[1]), pkg
    for a, b in zip(outs["port"], outs["ref"]):
        assert _rel(a, b) <= RTOL


def test_prefill_drops_decode_is_dropless(spy):
    """Reference caveat: prefill routes under capacity, decode dropless,
    so a decode step's logits equal a prefill's only where the last
    prompt token kept its expert slot. llama4 reduced (a dense block then
    a MoE block, so the MoE reaches no cache) at capacity 0.75, 6
    requests: the port equals the reference on both paths; requests whose
    last token kept its slot agree within 1e-5, and at least one that
    lost it does not."""
    rc, cfg, rp, tp = _pair("llama4-maverick-400b-a17b",
                            moe_capacity_factor=0.75)
    b, t = 6, 12
    toks = _tokens(cfg.vocab, b, t, seed=7)
    masks, routes = spy
    got = {}
    for pkg in ("ref", "port"):
        if pkg == "ref":
            c = RM.make_caches(rc, b, t + 1, jnp.float32)
            _, full = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks)}, c)
            c = RM.make_caches(rc, b, t + 1, jnp.float32)
            c, _ = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :-1])},
                              c)
            _, dec = RM.decode_step(rc, rp, c, {
                "tokens": jnp.asarray(toks[:, -1:]),
                "position": jnp.asarray([t - 1], jnp.int32)})
        else:
            c = M.make_caches(cfg, b, t + 1, torch.float32, device="cpu")
            _, full = M.prefill(cfg, tp, {"tokens": torch.as_tensor(toks)},
                                c)
            c = M.make_caches(cfg, b, t + 1, torch.float32, device="cpu")
            c, _ = M.prefill(cfg, tp,
                             {"tokens": torch.as_tensor(toks[:, :-1])}, c)
            _, dec = M.decode_step(cfg, tp, c, {
                "tokens": torch.as_tensor(toks[:, -1:]),
                "position": torch.tensor([t - 1], dtype=torch.int32)})
        got[pkg] = (np.asarray(full)[:, 0], np.asarray(dec)[:, 0])
    for a, w in zip(got["port"], got["ref"]):
        assert _rel(a, w) <= RTOL
    # the port's full prefill's routing: (n, g, E, cap) -> kept slots a
    # token (the reference's masks lie under its scan)
    d = routes[0].dispatch.numpy().reshape(b, t, -1).sum(-1)
    kept = d[:, -1] == cfg.moe_top_k
    assert kept.any() and not kept.all(), kept
    full, dec = got["port"]
    for i in range(b):
        rel = _rel(dec[i], full[i])
        assert (rel <= RTOL) == bool(kept[i]), (i, rel, kept[i])
