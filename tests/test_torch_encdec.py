"""The port's enc-dec family (whisper: an encoder over stub frame
embeddings, a decoder that cross-attends its memory, layernorm, gelu,
biases, sinusoidal positions) against the JAX package, f32, from the
reference's ``init_model(key(0))`` parameters through
``convert.params_from_numpy``. The drawn biases are zeros, so the
parameters' biases and norm offsets are replaced by seeded normals in
both packages before a test reads them.

Tolerances: encoder outputs, logits, losses and caches within 1e-5
relative (f32, another summation order); every gradient leaf within 1e-5
of its largest entry, but the key biases', which are zero in exact
arithmetic (the softmax cancels them), under 1e-6 of the largest
gradient entry in both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

NAME = "whisper-medium"
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_offsets(params, seed=1):
    """The reference's tree with every bias and norm offset (``b``,
    ``bias``) drawn from N(0, 0.1^2): zeros would hide a bias left out."""
    rng = np.random.default_rng(seed)
    flat, spec = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in flat:
        if getattr(path[-1], "key", None) in ("b", "bias"):
            leaf = jnp.asarray(rng.standard_normal(leaf.shape) * 0.1,
                               leaf.dtype)
        out.append(leaf)
    return jax.tree_util.tree_unflatten(spec, out)


@pytest.fixture(scope="module")
def pair():
    rc, cfg = ref_arch(NAME).reduced(), get_arch(NAME).reduced()
    rp, _ = RM.init_model(jax.random.key(0), rc)
    rp = _with_offsets(rp)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    return rc, cfg, rp, tp


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _frames(b, s, d, seed):
    return (np.random.default_rng(seed).standard_normal((b, s, d))
            ).astype(np.float32)


def _tokens(vocab, b, t, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, t)).astype(np.int32)


def _layer(params, i, key):
    """Layer ``i`` of a stacked block tree of either package."""
    if isinstance(tree.leaves(params)[0], torch.Tensor):
        return tree.map(lambda x: x[i], params[key])
    return jax.tree.map(lambda x: x[i], params[key])


def _names(node, prefix=""):
    """Dotted names of a tree's leaves, in the reference's leaf order."""
    out = []
    for k in sorted(node):
        if isinstance(node[k], dict):
            out += _names(node[k], f"{prefix}{k}.")
        else:
            out.append(prefix + k)
    return out


def _same_caches(got, want):
    g = convert.caches_to_numpy(got)
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert [a.shape for a in g] == [b.shape for b in w]
    for a, b in zip(g, w):
        assert _rel(a, b) <= RTOL


# ----------------------------------------------------------- attention modes


def test_encoder_mode_is_not_causal(pair):
    """The encoder's attention sees every frame: position 0's output moves
    when the last frame does, in both packages, and the outputs agree."""
    rc, cfg, rp, tp = pair
    rat = _layer(rp, 0, "enc_blocks")["attn"]
    tat = _layer(tp, 0, "enc_blocks")["attn"]
    x = _frames(2, 9, cfg.d_model, 2)
    x2 = x.copy()
    x2[:, -1] += 1.0
    pos = np.arange(9)[None]
    outs = []
    for xi in (x, x2):
        ro, _ = rattn.attn_apply(rc, rat, jnp.asarray(xi),
                                 positions=jnp.asarray(pos), mode="encoder")
        to, _ = tattn.attn_apply(cfg, tat, torch.as_tensor(xi),
                                 positions=torch.as_tensor(pos),
                                 mode="encoder")
        assert _rel(to.numpy(), ro) <= RTOL
        outs.append((np.asarray(ro), to.numpy()))
    for k in (0, 1):
        assert np.abs(outs[0][k][:, 0] - outs[1][k][:, 0]).max() > 1e-3


@pytest.mark.parametrize("rope", ["none", "rope"])
def test_cross_mode_is_not_rotated_nor_causal(pair, rope):
    """'cross' attends the given k / v as they are: no rotation of q or k
    (even under ``rope == "rope"``, at positions 7..11) and no causal mask
    (5 queries over 11 keys); both packages equal a plain softmax(q k^T /
    sqrt d) v over all of the memory."""
    rc, cfg, rp, tp = pair
    rc = dataclasses.replace(rc, rope=rope)
    cfg = dataclasses.replace(cfg, rope=rope)
    rat = _layer(rp, 0, "blocks")["xattn"]
    tat = _layer(tp, 0, "blocks")["xattn"]
    b, t, s, h, d = 2, 5, 11, cfg.n_kv_heads, cfg.head_dim_
    x = _frames(b, t, cfg.d_model, 3)
    k, v = _frames(b, s, h * d, 4), _frames(b, s, h * d, 5)
    k, v = k.reshape(b, s, h, d), v.reshape(b, s, h, d)
    pos = np.arange(t)[None] + 7
    ro, _ = rattn.attn_apply(rc, rat, jnp.asarray(x),
                             positions=jnp.asarray(pos), mode="cross",
                             cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    to, _ = tattn.attn_apply(cfg, tat, torch.as_tensor(x),
                             positions=torch.as_tensor(pos), mode="cross",
                             cross_kv=(torch.as_tensor(k),
                                       torch.as_tensor(v)))
    q = (x @ tat["wq"]["w"].numpy() + tat["wq"]["b"].numpy()).reshape(
        b, t, cfg.n_heads, d)
    sc = np.einsum("bthd,bshd->bhts", q, k) / np.sqrt(d)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhts,bshd->bthd", p, v).reshape(b, t, -1)
    want = o @ tat["wo"]["w"].numpy() + tat["wo"]["b"].numpy()
    assert _rel(to.numpy(), want) <= RTOL
    assert _rel(np.asarray(ro), want) <= RTOL


def test_cross_attention_gets_no_window(pair, monkeypatch):
    """A cross-decoder block passes its window to the self-attention only:
    in both packages the 'cross' call gets none (a window of 2 given to
    the block), and the blocks agree."""
    rc, cfg, rp, tp = pair
    rblk, tblk = _layer(rp, 0, "blocks"), _layer(tp, 0, "blocks")
    x = _frames(2, 6, cfg.d_model, 20)
    mem = _frames(2, 9, cfg.d_model, 21)
    seen = {}
    for name, mod in (("ref", rattn), ("port", tattn)):
        real = mod.attn_apply

        def spy(*a, real=real, name=name, **kw):
            seen.setdefault(name, []).append((kw["mode"], kw.get("window")))
            return real(*a, **kw)

        monkeypatch.setattr(mod, "attn_apply", spy)
    pos = np.arange(6)[None]
    rx, _, _ = RM.dense_block_apply(
        rc, rblk, jnp.asarray(x), mode="train", positions=jnp.asarray(pos),
        cross_kv=tuple(rattn._split_heads(
            jnp.asarray(mem) @ rblk["xattn"][w]["w"] + rblk["xattn"][w]["b"],
            cfg.n_kv_heads) for w in ("wk", "wv")), window=2)
    tx, _, _ = M.dense_block_apply(
        cfg, tblk, torch.as_tensor(x), mode="train",
        positions=torch.as_tensor(pos),
        cross_kv=M._cross_kv(cfg, tblk, torch.as_tensor(mem)), window=2)
    assert seen["ref"] == seen["port"] == [("train", 2), ("cross", None)]
    assert _rel(tx.numpy(), rx) <= RTOL


# ------------------------------------------------------------------ model


def test_param_tree_matches_reference(pair):
    """``enc_blocks`` (encoder blocks), ``blocks`` (cross-decoder blocks
    with ``lnx`` and ``xattn``), ``enc_norm``: the reference's axes at the
    reduced config, and its leaves, shapes and dtypes at full width."""
    rc, cfg, _, tp = pair
    assert "xattn" in tp["blocks"] and "xattn" not in tp["enc_blocks"]
    assert tp["blocks"]["xattn"]["wk"]["b"].shape == (
        cfg.n_layers, cfg.n_kv_heads * cfg.head_dim_)
    _, raxes = RM.init_model(jax.random.key(0), rc)
    _, taxes = M.init_model(0, cfg, device="cpu")
    assert taxes == raxes
    full = M.param_skeleton(get_arch(NAME))
    want = jax.eval_shape(lambda: RM.init_model(jax.random.key(0),
                                                ref_arch(NAME))[0])
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in tree.leaves(full)] == \
        [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(want)]


def test_encode_matches_reference(pair):
    rc, cfg, rp, tp = pair
    f = _frames(2, 13, cfg.d_model, 6)
    r = RM._encode(rc, rp, jnp.asarray(f))
    t = M._encode(cfg, tp, torch.as_tensor(f))
    assert t.shape == (2, 13, cfg.d_model)
    assert _rel(t.detach().numpy(), r) <= RTOL


def test_loss_and_grads_match_reference(pair):
    rc, cfg, rp, tp = pair
    f = _frames(2, 12, cfg.d_model, 7)
    toks = _tokens(cfg.vocab, 2, 17, 8)
    rb = {"frames": jnp.asarray(f), "tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"frames": torch.as_tensor(f),
          "tokens": torch.as_tensor(toks[:, :-1]),
          "labels": torch.as_tensor(toks[:, 1:])}
    (rl, rm), rg = jax.value_and_grad(lambda p: RM.loss_fn(rc, p, rb),
                                      has_aux=True)(rp)
    (tl, tm), tg = M.value_and_grad(cfg, tp, tb)
    assert abs(float(tl) - float(rl)) <= RTOL * abs(float(rl))
    assert float(tm["tokens"]) == float(rm["tokens"]) == 32.0
    want = [np.asarray(x) for x in jax.tree.leaves(rg)]
    got = convert.params_to_numpy(tg)
    assert len(got) == len(want)
    # A key projection's bias shifts every score of a query by the same
    # q . b_k, which the softmax cancels: its gradient is zero in exact
    # arithmetic, and both packages give roundoff (1e-9 against a largest
    # gradient entry of 0.1). Those leaves are held under 1e-6 of the
    # largest entry; every other leaf to 1e-5 of its own.
    top = max(np.abs(w).max() for w in want)
    for i, (name, g, w) in enumerate(zip(_names(tg), got, want)):
        if name.endswith("wk.b"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top, name
        else:
            assert np.abs(g - w).max() <= RTOL * np.abs(w).max(), name


def _serve_pair(rc, cfg, rp, tp, f, toks, t, steps):
    """Prefill of ``toks[:, :t]`` with frames ``f``, then ``steps`` decode
    steps with ``enc_memory = _encode(f)``, in both packages; asserts the
    logits and caches equal after each call and returns both caches."""
    b = toks.shape[0]
    rcache = RM.make_caches(rc, b, t + steps, jnp.float32)
    tcache = M.make_caches(cfg, b, t + steps, torch.float32, device="cpu")
    rcache, rl = RM.prefill(rc, rp, {"frames": jnp.asarray(f),
                                     "tokens": jnp.asarray(toks[:, :t])},
                            rcache)
    _, tl = M.prefill(cfg, tp, {"frames": torch.as_tensor(f),
                                "tokens": torch.as_tensor(toks[:, :t])},
                      tcache)
    assert _rel(tl.numpy(), rl) <= RTOL
    _same_caches(tcache, rcache)
    rmem = RM._encode(rc, rp, jnp.asarray(f))
    tmem = M._encode(cfg, tp, torch.as_tensor(f))
    for step in range(steps):
        p = t + step
        rcache, rl = RM.decode_step(rc, rp, rcache, {
            "tokens": jnp.asarray(toks[:, p:p + 1]),
            "position": jnp.asarray([p], jnp.int32), "enc_memory": rmem})
        _, tl = M.decode_step(cfg, tp, tcache, {
            "tokens": torch.as_tensor(toks[:, p:p + 1]),
            "position": torch.tensor([p], dtype=torch.int32),
            "enc_memory": tmem})
        assert _rel(tl.numpy(), rl) <= RTOL, step
        _same_caches(tcache, rcache)
    return rcache, tcache


def test_prefill_decode_with_enc_memory(pair):
    """Prefill encodes the frames itself; each decode step takes the
    memory from ``_encode`` and its sinusoid at the step's position: the
    logits and the decoder's self-attention caches equal the reference's
    over 4 steps."""
    rc, cfg, rp, tp = pair
    f = _frames(2, 10, cfg.d_model, 9)
    toks = _tokens(cfg.vocab, 2, 11, 10)
    _, tcache = _serve_pair(rc, cfg, rp, tp, f, toks, 7, 4)
    assert tcache.length.tolist() == [11] * cfg.n_layers


def test_serve_steps_pass_the_batch_through(pair):
    """``build_prefill_step`` / ``build_decode_step`` take the family's
    batches as they are (frames; enc_memory)."""
    _, cfg, _, tp = pair
    f = torch.as_tensor(_frames(1, 6, cfg.d_model, 11))
    toks = torch.as_tensor(_tokens(cfg.vocab, 1, 5, 12))
    pre, dec = tsteps.build_prefill_step(cfg), tsteps.build_decode_step(cfg)
    c = M.make_caches(cfg, 1, 6, torch.float32, device="cpu")
    c, l1 = pre(tp, {"frames": f, "tokens": toks}, c)
    _, l2 = dec(tp, c, {"tokens": toks[:, -1:],
                        "position": torch.tensor([5], dtype=torch.int32),
                        "enc_memory": M._encode(cfg, tp, f)})
    want = M.prefill(cfg, tp, {"frames": f, "tokens": toks},
                     M.make_caches(cfg, 1, 6, torch.float32,
                                   device="cpu"))[1]
    assert torch.equal(l1, want)
    assert torch.isfinite(l2).all()
    with pytest.raises(ValueError, match="enc_memory"):
        dec(tp, c, {"tokens": toks[:, -1:],
                    "position": torch.tensor([5], dtype=torch.int32)})


@pytest.mark.parametrize("quantized", [False, True])
def test_cache_round_trip(pair, quantized):
    """The reference's prefill caches (the decoder's self-attention KV
    stack; int8 with scales too) carried over by ``caches_from_numpy``
    resume in the port's decode_step; ``caches_to_numpy`` gives the
    leaves back."""
    rc, cfg, rp, tp = pair
    f = _frames(2, 8, cfg.d_model, 13)
    toks = _tokens(cfg.vocab, 2, 7, 14)
    rcache = RM.make_caches(rc, 2, 9, jnp.float32, quantized_kv=quantized)
    rcache, _ = RM.prefill(rc, rp, {"frames": jnp.asarray(f),
                                    "tokens": jnp.asarray(toks[:, :6])},
                           rcache)
    leaves = [np.asarray(x) for x in jax.tree.leaves(rcache)]
    tcache = convert.caches_from_numpy(cfg, leaves, device="cpu")
    for a, w in zip(convert.caches_to_numpy(tcache), leaves):
        np.testing.assert_array_equal(a, w)
    rmem = RM._encode(rc, rp, jnp.asarray(f))
    rcache, rl = RM.decode_step(rc, rp, rcache, {
        "tokens": jnp.asarray(toks[:, 6:]),
        "position": jnp.asarray([6], jnp.int32), "enc_memory": rmem})
    _, tl = M.decode_step(cfg, tp, tcache, {
        "tokens": torch.as_tensor(toks[:, 6:]),
        "position": torch.tensor([6], dtype=torch.int32),
        "enc_memory": M._encode(cfg, tp, torch.as_tensor(f))})
    assert _rel(tl.numpy(), rl) <= RTOL
    _same_caches(tcache, rcache)
    with pytest.raises(ValueError, match="leaves"):
        convert.caches_from_numpy(cfg, leaves[:-1], device="cpu")


# ------------------------------------------- reference behaviours, pinned


def test_serving_encodes_twice(pair, monkeypatch):
    """Reference caveat: ``prefill`` encodes the frames and returns only
    (caches, logits); the memory a decode step needs comes from a second
    ``_encode`` by the caller. Both packages encode twice for one
    prefill + decode."""
    rc, cfg, rp, tp = pair
    f = _frames(1, 6, cfg.d_model, 15)
    toks = _tokens(cfg.vocab, 1, 5, 16)
    for mod, cf, p, arr, cache in (
            (RM, rc, rp, jnp.asarray,
             lambda: RM.make_caches(rc, 1, 6, jnp.float32)),
            (M, cfg, tp, torch.as_tensor,
             lambda: M.make_caches(cfg, 1, 6, torch.float32,
                                   device="cpu"))):
        calls = []
        real = mod._encode

        def counted(*a, real=real, calls=calls):
            calls.append(1)
            return real(*a)

        monkeypatch.setattr(mod, "_encode", counted)
        out = mod.prefill(cf, p, {"frames": arr(f),
                                  "tokens": arr(toks[:, :4])}, cache())
        assert len(out) == 2
        mem = mod._encode(cf, p, arr(f))
        mod.decode_step(cf, p, out[0], {
            "tokens": arr(toks[:, 4:]), "position": arr(np.array([4],
                                                                 np.int32)),
            "enc_memory": mem})
        assert len(calls) == 2, mod.__name__


def test_decode_reprojects_cross_kv_each_step(pair):
    """Reference caveat: a decode step projects every layer's cross k / v
    from the ``enc_memory`` it is given; the caches hold only the
    self-attention k / v. So the same caches with another memory give
    other logits, in both packages, by the same amount."""
    rc, cfg, rp, tp = pair
    f = _frames(2, 6, cfg.d_model, 17)
    toks = _tokens(cfg.vocab, 2, 5, 18)
    assert len(jax.tree.leaves(RM.make_caches(rc, 2, 6, jnp.float32))) == \
        len(tree.leaves(M.make_caches(cfg, 2, 6, device="meta"))) == 3
    moved = []
    for scale in (1.0, 1.5):
        rmem = RM._encode(rc, rp, jnp.asarray(f)) * scale
        tmem = M._encode(cfg, tp, torch.as_tensor(f)) * scale
        rcache = RM.make_caches(rc, 2, 6, jnp.float32)
        tcache = M.make_caches(cfg, 2, 6, torch.float32, device="cpu")
        pre = {"frames": f, "tokens": toks[:, :4]}
        rcache, _ = RM.prefill(rc, rp, {k: jnp.asarray(v) for k, v in
                                        pre.items()}, rcache)
        M.prefill(cfg, tp, {k: torch.as_tensor(v) for k, v in pre.items()},
                  tcache)
        _, rl = RM.decode_step(rc, rp, rcache, {
            "tokens": jnp.asarray(toks[:, 4:]),
            "position": jnp.asarray([4], jnp.int32), "enc_memory": rmem})
        _, tl = M.decode_step(cfg, tp, tcache, {
            "tokens": torch.as_tensor(toks[:, 4:]),
            "position": torch.tensor([4], dtype=torch.int32),
            "enc_memory": tmem})
        moved.append((np.asarray(rl), tl.numpy()))
    r_moved = _rel(moved[1][0], moved[0][0])
    assert r_moved > 1e-3
    assert abs(_rel(moved[1][1], moved[0][1]) - r_moved) <= 2 * RTOL


def test_whisper_decoder_gets_sinusoidal_positions(pair):
    """Reference caveat: whisper's decoder adds the fixed sinusoid to its
    token embeddings (``rope == "none"``), where the published model
    learns a position table; neither package has a position parameter."""
    rc, cfg, rp, tp = pair
    assert cfg.rope == rc.rope == "none"
    assert not any("pos" in k for k in tp)
    toks = _tokens(cfg.vocab, 2, 7, 19)
    rx, _, _ = RM._embed_inputs(rc, rp, {"tokens": jnp.asarray(toks)})
    tx, _, _ = M._embed_inputs(cfg, tp, {"tokens": torch.as_tensor(toks)})
    table = tp["embed"]["table"].numpy()[toks]
    want = np.broadcast_to(np.asarray(RM._sinusoid(7, cfg.d_model)),
                           table.shape)
    np.testing.assert_allclose(np.asarray(rx) - table, want, atol=1e-6)
    np.testing.assert_allclose(tx.numpy() - table, want, atol=1e-6)


def test_launch_serve_refuses_encdec():
    """As the reference's launcher does."""
    with pytest.raises(SystemExit, match="decoder-only"):
        launch_serve.main(["--arch", NAME, "--smoke", "--device", "cpu"])
