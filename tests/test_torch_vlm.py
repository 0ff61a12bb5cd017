"""The port's VLM family (qwen2-vl: stub patch embeddings before the
tokens, M-RoPE over three position streams, biases) against the JAX
package, f32, from the reference's ``init_model(key(0))`` parameters
through ``convert.params_from_numpy``.

Positions follow Qwen2-VL's rope index: a g x g grid of image tokens at
(0, row, col), text from g onward on all three streams, decode steps
continuing on all three. ``launch.shapes.make_inputs`` puts ``arange`` on
every stream, where a swapped band or stream would not show; these
streams differ.

Tolerances: M-RoPE outputs, losses, logits and caches within 1e-5
relative (f32, another summation order); every gradient leaf within 1e-5
of its largest entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import common as rcm  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

NAME = "qwen2-vl-2b"
RTOL = 1e-5
GRID = 3            # a 3 x 3 grid of image tokens


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_biases(params, seed=1):
    """The reference's tree with every bias drawn from N(0, 0.1^2): the
    drawn zeros would hide a bias left out."""
    rng = np.random.default_rng(seed)
    flat, spec = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in flat:
        if getattr(path[-1], "key", None) == "b":
            leaf = jnp.asarray(rng.standard_normal(leaf.shape) * 0.1,
                               leaf.dtype)
        out.append(leaf)
    return jax.tree_util.tree_unflatten(spec, out)


@pytest.fixture(scope="module")
def pair():
    rc, cfg = ref_arch(NAME).reduced(), get_arch(NAME).reduced()
    rp, _ = RM.init_model(jax.random.key(0), rc)
    rp = _with_biases(rp)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    return rc, cfg, rp, tp


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _positions(b, g, t_text):
    """Qwen2-VL's rope index for a g x g image then ``t_text`` text tokens:
    (B, 3, g*g + t_text) int32."""
    rows, cols = np.divmod(np.arange(g * g), g)
    text = np.arange(g, g + t_text)
    pos = np.stack([np.concatenate([np.zeros(g * g, int), text]),
                    np.concatenate([rows, text]),
                    np.concatenate([cols, text])])
    return np.broadcast_to(pos, (b, 3, pos.shape[1])).astype(np.int32)


def _inputs(cfg, b, t_text, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t_text + 1)).astype(np.int32)
    vis = rng.standard_normal((b, GRID * GRID, cfg.d_model)).astype(
        np.float32)
    return toks, vis, _positions(b, GRID, t_text)


def _same_caches(got, want):
    g = convert.caches_to_numpy(got)
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert [a.shape for a in g] == [b.shape for b in w]
    for a, b in zip(g, w):
        assert _rel(a, b) <= RTOL


# ------------------------------------------------------------------ M-RoPE


@pytest.mark.parametrize("d", [16, 128])
def test_mrope_matches_reference_on_distinct_streams(d):
    """``apply_mrope`` of (B, T, H, D) at head widths 16 and 128 with three
    different position streams (B, 3, T) equals the reference's."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 3, 7)).astype(np.int32)
    want = rcm.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tcm.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6)
    assert _rel(got.numpy(), want) <= RTOL
    # a stream swapped is another rotation
    swapped = tcm.apply_mrope(torch.as_tensor(x),
                              torch.as_tensor(pos[:, [0, 2, 1]]), 1e6)
    assert _rel(swapped.numpy(), want) > 1e-2


@pytest.mark.parametrize("d,bands", [(16, (8, 4, 4)), (128, (64, 32, 32))])
def test_mrope_bands_are_half_quarter_quarter(d, bands):
    """Reference caveat: the head splits into bands of 1/2, 1/4, 1/4 (64 /
    32 / 32 at width 128), where Qwen2-VL's published ``mrope_section``
    [16, 24, 24] gives 32 / 48 / 48. Each stream rotates its own band
    only, in both packages: with the other streams at position 0 (no
    rotation), exactly its band moves."""
    x = np.random.default_rng(3).standard_normal((1, 4, 2, d)).astype(
        np.float32)
    edges = np.cumsum((0,) + bands)
    for s in range(3):
        pos = np.zeros((1, 3, 4), np.int32)
        pos[:, s] = [3, 5, 7, 11]
        for out in (np.asarray(rcm.apply_mrope(jnp.asarray(x),
                                               jnp.asarray(pos), 1e4)),
                    tcm.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos),
                                    1e4).numpy()):
            moved = np.abs(out - x).max(axis=(0, 1, 2)) > 1e-6
            want = np.zeros(d, bool)
            want[edges[s]:edges[s + 1]] = True
            np.testing.assert_array_equal(moved, want)


# ------------------------------------------------------------------ model


def test_param_tree_matches_reference(pair):
    rc, cfg, _, _ = pair
    _, raxes = RM.init_model(jax.random.key(0), rc)
    _, taxes = M.init_model(0, cfg, device="cpu")
    assert taxes == raxes
    full = M.param_skeleton(get_arch(NAME))
    want = jax.eval_shape(lambda: RM.init_model(jax.random.key(0),
                                                ref_arch(NAME))[0])
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in tree.leaves(full)] == \
        [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(want)]


def test_loss_and_grads_match_reference(pair):
    """The vision embeddings go before the tokens, the labels gain Tv
    zeros that the mask drops: the loss, its token count (text only) and
    every gradient equal the reference's."""
    rc, cfg, rp, tp = pair
    toks, vis, pos = _inputs(cfg, 2, 11, 4)
    rb = {"tokens": jnp.asarray(toks[:, :-1]), "vision_embeds":
          jnp.asarray(vis), "positions": jnp.asarray(pos),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in rb.items()}
    (rl, rm), rg = jax.value_and_grad(lambda p: RM.loss_fn(rc, p, rb),
                                      has_aux=True)(rp)
    (tl, tm), tg = M.value_and_grad(cfg, tp, tb)
    assert abs(float(tl) - float(rl)) <= RTOL * abs(float(rl))
    assert float(tm["tokens"]) == float(rm["tokens"]) == 2 * 11
    want = [np.asarray(x) for x in jax.tree.leaves(rg)]
    got = convert.params_to_numpy(tg)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), i


def test_label_mask_drops_the_vision_positions(pair):
    """The CE is the mean over the text positions alone: the same number
    from the port's final hidden states with the vision rows cut off; and
    the vision embeddings reach the loss through attention."""
    _, cfg, _, tp = pair
    toks, vis, pos = _inputs(cfg, 2, 9, 5)
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "vision_embeds": torch.as_tensor(vis),
          "positions": torch.as_tensor(pos),
          "labels": torch.as_tensor(toks[:, 1:])}
    loss, metrics = M.loss_fn(cfg, tp, tb)
    x, p, mask = M._embed_inputs(cfg, tp, tb)
    assert x.shape[1] == GRID * GRID + 9
    assert mask[:, :GRID * GRID].sum() == 0 and mask[:, GRID * GRID:].all()
    x, _, _ = M._apply_stacks(cfg, tp, x, mode="train", positions=p)
    logits = M._logits(cfg, tp, x[:, GRID * GRID:]).double()
    ce = torch.logsumexp(logits, -1) - logits.gather(
        -1, tb["labels"].long()[..., None])[..., 0]
    assert abs(float(metrics["ce"]) - float(ce.mean())) <= \
        RTOL * float(ce.mean())
    other = dict(tb, vision_embeds=tb["vision_embeds"] + 1.0)
    assert abs(float(M.loss_fn(cfg, tp, other)[0]) - float(loss)) > 1e-4


def test_prefill_decode_with_mrope_positions(pair):
    """Prefill of 9 image and 8 text tokens at Qwen2-VL's positions, then
    3 decode steps at (B, 3, 1) positions: the logits and the KV caches
    equal the reference's after every call."""
    rc, cfg, rp, tp = pair
    b, t = 2, 8
    toks, vis, pos = _inputs(cfg, b, t + 3, 6)
    n = GRID * GRID + t
    rcache = RM.make_caches(rc, b, n + 3, jnp.float32)
    tcache = M.make_caches(cfg, b, n + 3, torch.float32, device="cpu")
    pre = {"tokens": toks[:, :t], "vision_embeds": vis,
           "positions": pos[:, :, :n]}
    rcache, rl = RM.prefill(rc, rp, {k: jnp.asarray(v) for k, v in
                                     pre.items()}, rcache)
    _, tl = M.prefill(cfg, tp, {k: torch.as_tensor(v) for k, v in
                                pre.items()}, tcache)
    assert _rel(tl.numpy(), rl) <= RTOL
    _same_caches(tcache, rcache)
    for step in range(3):
        dec = {"tokens": toks[:, t + step:t + step + 1],
               "position": pos[:, :, n + step:n + step + 1]}
        assert dec["position"].shape == (b, 3, 1)
        rcache, rl = RM.decode_step(rc, rp, rcache,
                                    {k: jnp.asarray(v) for k, v in
                                     dec.items()})
        _, tl = M.decode_step(cfg, tp, tcache,
                              {k: torch.as_tensor(v) for k, v in
                               dec.items()})
        assert _rel(tl.numpy(), rl) <= RTOL, step
        _same_caches(tcache, rcache)
    assert tcache.length.tolist() == [n + 3] * cfg.n_layers


@pytest.mark.parametrize("quantized", [False, True])
def test_cache_round_trip(pair, quantized):
    rc, cfg, rp, tp = pair
    toks, vis, pos = _inputs(cfg, 2, 6, 7)
    n = GRID * GRID + 6
    rcache = RM.make_caches(rc, 2, n + 1, jnp.float32,
                            quantized_kv=quantized)
    rcache, _ = RM.prefill(rc, rp, {
        "tokens": jnp.asarray(toks[:, :6]), "vision_embeds":
        jnp.asarray(vis), "positions": jnp.asarray(pos[:, :, :n])}, rcache)
    leaves = [np.asarray(x) for x in jax.tree.leaves(rcache)]
    tcache = convert.caches_from_numpy(cfg, leaves, device="cpu")
    for a, w in zip(convert.caches_to_numpy(tcache), leaves):
        np.testing.assert_array_equal(a, w)
    dec = {"tokens": toks[:, 6:], "position": pos[:, :, n - 1:n] + 1}
    rcache, rl = RM.decode_step(rc, rp, rcache,
                                {k: jnp.asarray(v) for k, v in dec.items()})
    _, tl = M.decode_step(cfg, tp, tcache,
                          {k: torch.as_tensor(v) for k, v in dec.items()})
    assert _rel(tl.numpy(), rl) <= RTOL
    _same_caches(tcache, rcache)


def test_engine_has_no_vision_path(pair):
    """The reference's Engine builds token-only batches, so its prefill
    fails for a VLM (``KeyError: 'vision_embeds'``); the port's raises a
    ``ValueError`` naming the input, and so does the launcher."""
    rc, cfg, rp, tp = pair
    prompt = np.arange(3, 9, dtype=np.int32)
    with pytest.raises(KeyError, match="vision_embeds"):
        RE.Engine(rc, rp, max_batch=1, max_seq=16).generate(
            [RE.Request(prompt=prompt, max_new_tokens=2)])
    with pytest.raises(ValueError, match="vision_embeds"):
        TE.Engine(cfg, tp, max_batch=1, max_seq=16).generate(
            [TE.Request(prompt=prompt, max_new_tokens=2)])
    with pytest.raises(ValueError, match="vision_embeds"):
        launch_serve.main(["--arch", NAME, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="positions"):
        M.prefill(cfg, tp, {"tokens": torch.as_tensor(prompt[None]),
                            "vision_embeds": torch.zeros(1, 2, cfg.d_model)},
                  M.make_caches(cfg, 1, 16, device="cpu"))


def test_make_inputs_streams_are_equal():
    """``launch.shapes.make_inputs`` gives a VLM ``arange`` on all three
    streams, in both packages: a swapped stream would not show with such
    inputs, so the tests above build distinct streams."""
    from repro.launch import shapes as RS
    from repro_torch.launch import shapes as TS
    rpos = np.asarray(RS.make_inputs(ref_arch(NAME).reduced(), "prefill",
                                     16, 2)["positions"])
    tpos = TS.make_inputs(get_arch(NAME).reduced(), "prefill", 16, 2,
                          device="cpu")["positions"]
    np.testing.assert_array_equal(tpos.numpy(), rpos)
    assert (rpos == rpos[:, :1]).all()
    assert (_positions(2, GRID, 4) != _positions(2, GRID, 4)[:, :1]).any()
