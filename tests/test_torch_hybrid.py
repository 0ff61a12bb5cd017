"""The port's hybrid family (zamba2: Mamba2 units closed by ONE
parameter-shared attention block, a tail of Mamba2 blocks, the sliding
window) against the JAX package, f32, from the reference's
``init_model(key(0))`` parameters through ``convert.params_from_numpy``.

The reduced config is cut to ``n_layers=5``: with ``hybrid_attn_every`` 2
that is 2 units and a tail of 1 (the reduced default, 4 layers, has no
tail). The reduced ``attn_window`` is the published 8192, which nothing
at these sizes reaches, so the window tests replace it with 8 at prompts
of 16-20 tokens; the chunked route runs at the reduced ``attn_chunk`` 16.

Tolerances: the loss, logits and caches within 1e-5 relative (f32,
another summation order; the port's SSM scan is sequential, the
reference's associative), every gradient leaf within 1e-5 of its largest
entry; greedy tokens equal."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

NAME = "zamba2-1.2b"
LAYERS = 5          # 2 units of 2 Mamba2 blocks + the shared block, tail 1
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _pair_of(changes):
    changes = {"n_layers": LAYERS, **dict(changes)}
    rc = dataclasses.replace(ref_arch(NAME).reduced(), **changes)
    cfg = dataclasses.replace(get_arch(NAME).reduced(), **changes)
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    return rc, cfg, rp, tp


def _pair(**changes):
    """(ref cfg, port cfg, ref params, port params), the reference's
    ``init_model(key(0))`` at the cut config with ``changes`` (one
    parameter draw per config in this module)."""
    return _pair_of(tuple(sorted(changes.items())))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, t)).astype(np.int32)


def _same_caches(got, want):
    g = convert.caches_to_numpy(got)
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert [a.shape for a in g] == [b.shape for b in w]
    for a, b in zip(g, w):
        if np.abs(b).max() == 0:
            assert np.abs(a).max() == 0
        else:
            assert _rel(a, b) <= RTOL


def _dec(toks, pos):
    return {"tokens": toks, "position": np.array([pos], np.int32)}


# ------------------------------------------------------------ parameters


def test_param_tree_matches_reference(pair):
    """The units stacked twice (n_units, k_unit, ...), a tail, ONE shared
    block: the reference's leaves, shapes, dtypes and axes at the cut
    config, and its leaves and shapes at full width (zamba2-1.2b: 6 units
    of 6, a tail of 2; ``jax.eval_shape``, nothing allocated)."""
    rc, cfg, rp, tp = pair
    assert M._hybrid_shape(cfg) == (2, 2, 1)
    assert tp["units"]["ssm"]["in_proj"]["w"].shape[:2] == (2, 2)
    assert tp["tail"]["ssm"]["in_proj"]["w"].shape[0] == 1
    assert tp["shared_attn"]["attn"]["wq"]["w"].ndim == 2   # not stacked
    _, raxes = RM.init_model(jax.random.key(0), rc)
    _, taxes = M.init_model(0, cfg, device="cpu")
    assert taxes == raxes
    assert taxes["units"]["ssm"]["in_proj"]["w"] == (
        "layers", "layers", "embed", "ssm_inner")
    full = M.param_skeleton(get_arch(NAME))
    want = jax.eval_shape(lambda: RM.init_model(jax.random.key(0),
                                                ref_arch(NAME))[0])
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in tree.leaves(full)] == \
        [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(want)]
    assert M._hybrid_shape(get_arch(NAME)) == (6, 6, 2)
    assert sorted(full) == sorted(want)


def test_loss_and_grads_match_reference(pair):
    rc, cfg, rp, tp = pair
    toks = _tokens(cfg.vocab, 2, 25, 0)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "labels": torch.as_tensor(toks[:, 1:])}
    (rl, rm), rg = jax.value_and_grad(lambda p: RM.loss_fn(rc, p, rb),
                                      has_aux=True)(rp)
    (tl, tm), tg = M.value_and_grad(cfg, tp, tb)
    assert abs(float(tl) - float(rl)) <= RTOL * abs(float(rl))
    assert float(tm["aux"]) == float(rm["aux"]) == 0.0
    want = [np.asarray(x) for x in jax.tree.leaves(rg)]
    got = convert.params_to_numpy(tg)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), i
    # the shared block's gradient sums over every unit that applies it
    assert np.abs(convert.params_to_numpy(tg["shared_attn"])[0]).max() > 0


# ----------------------------------------------------------------- serving


@pytest.mark.parametrize("impl,window,t", [
    ("full", None, 20), ("chunked", None, 16), ("full", 8, 20),
    ("chunked", 8, 16)])
def test_prefill_decode_logits_and_caches(impl, window, t):
    """Prefill of ``t`` tokens, then 4 decode steps: the logits and every
    cache (each unit's KV cache, the units' and the tail's SSM states and
    conv carries) equal to the reference's after each call, on the full
    and the chunked attention routes, with no window and with a window of
    8 that the prompt and every decode step cross."""
    rc, cfg, rp, tp = _pair(attn_impl=impl, attn_window=window)
    b, s_max = 2, t + 6
    toks = _tokens(cfg.vocab, b, t + 4, 3)
    rcache = RM.make_caches(rc, b, s_max, jnp.float32)
    tcache = M.make_caches(cfg, b, s_max, torch.float32, device="cpu")
    ptr = tcache["units"]["attn"].k.data_ptr()
    rcache, rl = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :t])},
                            rcache)
    out, tl = M.prefill(cfg, tp, {"tokens": torch.as_tensor(toks[:, :t])},
                        tcache)
    assert out["units"]["attn"].k.data_ptr() == ptr   # written in place
    assert _rel(tl.numpy(), rl) <= RTOL
    _same_caches(tcache, rcache)
    for step in range(4):
        dec = _dec(toks[:, t + step:t + step + 1], t + step)
        rcache, rl = RM.decode_step(rc, rp, rcache,
                                    {k: jnp.asarray(v) for k, v in
                                     dec.items()})
        _, tl = M.decode_step(cfg, tp, tcache,
                              {k: torch.as_tensor(v) for k, v in
                               dec.items()})
        assert _rel(tl.numpy(), rl) <= RTOL, step
        _same_caches(tcache, rcache)


def test_the_window_changes_the_answer():
    """A window of 8 under 20-token prompts changes the prefill's and a
    decode step's logits in both packages, by the same amount: the tests
    above exercise it."""
    b, t = 2, 20
    toks = _tokens(256, b, t + 1, 4)
    got = {}
    for window in (None, 8):
        rc, cfg, rp, tp = _pair(attn_window=window)
        rcache = RM.make_caches(rc, b, t + 1, jnp.float32)
        tcache = M.make_caches(cfg, b, t + 1, torch.float32, device="cpu")
        rcache, rpre = RM.prefill(rc, rp, {"tokens": jnp.asarray(
            toks[:, :t])}, rcache)
        _, tpre = M.prefill(cfg, tp, {"tokens": torch.as_tensor(
            toks[:, :t])}, tcache)
        dec = _dec(toks[:, t:], t)
        _, rdec = RM.decode_step(rc, rp, rcache,
                                 {k: jnp.asarray(v) for k, v in dec.items()})
        _, tdec = M.decode_step(cfg, tp, tcache,
                                {k: torch.as_tensor(v) for k, v in
                                 dec.items()})
        got[window] = (np.asarray(rpre), tpre.numpy(), np.asarray(rdec),
                       tdec.numpy())
    for i in (0, 2):
        moved = _rel(got[8][i], got[None][i])
        assert moved > 1e-3, i
        assert abs(_rel(got[8][i + 1], got[None][i + 1]) - moved) \
            <= 2 * RTOL, i


def test_every_unit_has_its_own_kv_cache(pair):
    """The shared block's parameters serve every unit, but each unit
    writes its own KV cache: after a prefill, unit u's k / v are the
    reference's unit u's, and the units' differ (they attend different
    inputs). A port sharing one cache across units would hold the last
    unit's k / v in every slot."""
    rc, cfg, rp, tp = pair
    b, t = 2, 12
    toks = _tokens(cfg.vocab, b, t, 5)
    rcache = RM.make_caches(rc, b, t, jnp.float32)
    tcache = M.make_caches(cfg, b, t, torch.float32, device="cpu")
    rcache, _ = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks)}, rcache)
    M.prefill(cfg, tp, {"tokens": torch.as_tensor(toks)}, tcache)
    rkv, tkv = rcache["units"]["attn"], tcache["units"]["attn"]
    assert isinstance(tkv, tattn.KVCache)
    assert tkv.k.shape == (2, b, t, cfg.n_kv_heads, cfg.head_dim_)
    assert tkv.length.tolist() == [t, t]
    for u in range(2):
        for got, want in ((tkv.k[u], rkv.k[u]), (tkv.v[u], rkv.v[u])):
            assert _rel(got.numpy(), want) <= RTOL, u
    assert _rel(tkv.k[0].numpy(), tkv.k[1].numpy()) > 0.1
    assert isinstance(tcache["units"]["ssm"], tssm.SSMCache)
    assert tcache["units"]["ssm"].state.shape[:2] == (2, 2)
    assert tcache["tail"].state.shape[0] == 1


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_resumes_from_reference_caches(pair, quantized):
    """The reference's prefill caches (the tail's and units' SSM caches,
    each unit's KV cache; int8 with scales too) carried over by
    ``caches_from_numpy`` resume in the port's decode_step, and
    ``caches_to_numpy`` gives the leaves back."""
    rc, cfg, rp, tp = pair
    b, t = 2, 10
    toks = _tokens(cfg.vocab, b, t + 1, 6)
    rcache = RM.make_caches(rc, b, t + 3, jnp.float32,
                            quantized_kv=quantized)
    rcache, _ = RM.prefill(rc, rp, {"tokens": jnp.asarray(toks[:, :t])},
                           rcache)
    leaves = [np.asarray(x) for x in jax.tree.leaves(rcache)]
    assert len(leaves) == (9 if quantized else 7)
    tcache = convert.caches_from_numpy(cfg, leaves, device="cpu")
    assert tcache["units"]["attn"].length.dtype == torch.int32
    for a, w in zip(convert.caches_to_numpy(tcache), leaves):
        np.testing.assert_array_equal(a, w)
    dec = _dec(toks[:, t:], t)
    rcache, rl = RM.decode_step(rc, rp, rcache,
                                {k: jnp.asarray(v) for k, v in dec.items()})
    _, tl = M.decode_step(cfg, tp, tcache,
                          {k: torch.as_tensor(v) for k, v in dec.items()})
    assert _rel(tl.numpy(), rl) <= RTOL
    _same_caches(tcache, rcache)
    with pytest.raises(ValueError, match="leaves; .* 7 or 9"):
        convert.caches_from_numpy(cfg, leaves[:-1], device="cpu")


def test_caches_without_a_tail_round_trip():
    """At the reduced default (4 layers: 2 units, no tail) the caches
    hold no ``tail``, in both packages, and convert carries them over."""
    rc, cfg, rp, _ = _pair(n_layers=4)
    rcache = RM.make_caches(rc, 1, 6, jnp.float32)
    tcache = M.make_caches(cfg, 1, 6, torch.float32, device="cpu")
    assert sorted(rcache) == sorted(tcache) == ["units"]
    leaves = [np.asarray(x) for x in jax.tree.leaves(rcache)]
    back = convert.caches_from_numpy(cfg, leaves, device="cpu")
    for a, w in zip(convert.caches_to_numpy(back), leaves):
        np.testing.assert_array_equal(a, w)


def _requests(mod, vocab, lens, news, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.Request(prompt=rng.integers(1, vocab - 1, n).astype(np.int32),
                        max_new_tokens=m) for n, m in zip(lens, news)]


@pytest.mark.parametrize("window", [None, 8])
def test_engine_greedy_matches_reference(window):
    """``Engine.generate``'s greedy tokens equal the reference Engine's on
    mixed prompt lengths (left-padded), with and without the window."""
    rc, cfg, rp, tp = _pair(attn_window=window)
    lens, news = (5, 14, 9), (6, 3, 5)
    rreq = _requests(RE, cfg.vocab, lens, news)
    treq = _requests(TE, cfg.vocab, lens, news)
    RE.Engine(rc, rp, max_batch=4, max_seq=24).generate(rreq)
    TE.Engine(cfg, tp, max_batch=4, max_seq=24).generate(treq)
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


def test_launch_serve_smoke_on_cpu(capsys):
    out, _ = launch_serve.main(["--arch", NAME, "--smoke", "--device",
                                "cpu", "--requests", "3", "--new-tokens",
                                "4"])
    assert [len(r.out_tokens) for r in out] == [4, 4, 4]
    assert f"[serve] {NAME}-smoke: 3 reqs, 12 tokens" in \
        capsys.readouterr().out
