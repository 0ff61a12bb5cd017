"""Two witnesses behind the hybrid family's (zamba2) checks on the card,
each read in both packages from the reference's ``init_model(key(0))``
parameters, f32:

- how far its logits move under a perturbation of rounding's kind: the
  embedding table scaled entry by entry by ``1 + EPS * noise`` (numpy
  draws, the same in both packages), the largest move of the last-token
  prefill logits at their own scale, over EPS (the amplification). A
  summation order that changes (another GEMM shape on the card, another
  package) perturbs every product so; zamba2's Mamba2 stack amplifies it
  several times more than a dense stack or a Mamba1 one, in the
  reference as in the port. The (a) cut of the card's hybrid phase (one
  unit of 6 and the tail of 2, the published widths) is read at full
  width, the family contrast at width 256 and the same depth;
- that its windowed decode after a chunked prefill (the route
  ``Engine.generate`` takes at T >= 8192) agrees with full-route prefills
  of the same tokens, step by step, over more decode steps than the
  card's long request takes, with the window (8) crossed by the prompt
  and by every step.

Tolerances: the amplifications of the two packages within 10% of each
other and twice their distance unperturbed over EPS; the decode steps
and the prefills within 1e-5 relative, and the port within 1e-5 of the
reference; at the full-width cut the port within 1e-4 of the reference
(the hybrid's (a) limit on the card). Run with ``-s`` to print the
readings."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

HYBRID = "zamba2-1.2b"
EPS = 1e-5
SEEDS = (0, 1)
RTOL = 1e-5
# the (a) cut of the card's hybrid phase: one unit of 6 Mamba2 blocks with
# the shared block, and the tail of 2, at the published widths
HYBRID_CUT = dict(n_layers=8, dtype="float32")
# the family contrast: 8 layers at width 256 (zamba2 keeps its units of 6
# and its state of 64)
NARROW = dict(n_layers=8, d_model=256, n_heads=4, n_kv_heads=4,
              head_dim=64, d_ff=1024, vocab=512)
FAMILIES = {HYBRID: dict(NARROW, ssm_state=64, ssm_heads=8,
                         hybrid_attn_every=6),
            "falcon-mamba-7b": dict(NARROW, ssm_state=16),
            "olmo-1b": NARROW}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside other test workers torch's default of a
    thread a core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(name, changes, *, reduced=True):
    rc = ref_arch(name).reduced() if reduced else ref_arch(name)
    cfg = get_arch(name).reduced() if reduced else get_arch(name)
    rc = dataclasses.replace(rc, **changes)
    cfg = dataclasses.replace(cfg, **changes)
    rp, _ = RM.init_model(jax.random.key(0), rc)
    return rc, cfg, rp


@functools.lru_cache(maxsize=None)
def _amplification(name, changes, reduced=True):
    """``(reference's, port's amplification per seed, the port's distance
    from the reference unperturbed)`` for ``name`` with ``changes``."""
    rc, cfg, rp = _pair(name, dict(changes), reduced=reduced)
    flat, treedef = jax.tree_util.tree_flatten_with_path(rp)
    keys = [jax.tree_util.keystr(p) for p, _ in flat]
    leaves = [np.asarray(x) for _, x in flat]
    del rp, flat
    at = keys.index("['embed']['table']")
    tp = convert.params_from_numpy(cfg, leaves, device="cpu")
    b, t = 2, 32
    toks = np.random.default_rng(1).integers(
        1, cfg.vocab - 1, (b, t)).astype(np.int32)

    def ref_logits(table):
        lv = [jnp.asarray(x) for x in leaves]
        lv[at] = jnp.asarray(table)
        p = jax.tree_util.tree_unflatten(treedef, lv)
        _, lg = RM.prefill(rc, p, {"tokens": jnp.asarray(toks)},
                           RM.make_caches(rc, b, t, jnp.float32))
        return np.asarray(lg)[:, -1]

    def port_logits(table):
        p = dict(tp, embed={"table": torch.as_tensor(table)})
        _, lg = M.prefill(cfg, p, {"tokens": torch.as_tensor(toks)},
                          M.make_caches(cfg, b, t, torch.float32,
                                        device="cpu"))
        return lg[:, -1].numpy()

    table = leaves[at]
    ref0, port0 = ref_logits(table), port_logits(table)
    amps = []
    for seed in SEEDS:
        noise = np.random.default_rng(100 + seed).standard_normal(
            table.shape).astype(np.float32)
        moved = (table * (1 + EPS * noise)).astype(np.float32)
        amps.append((_rel(ref_logits(moved), ref0) / EPS,
                     _rel(port_logits(moved), port0) / EPS))
    spread = _rel(port0, ref0)
    print(f"\n{name} d_model={cfg.d_model} layers={cfg.n_layers}: "
          f"amplification (reference, port) "
          f"{[(round(a, 2), round(p, 2)) for a, p in amps]}; "
          f"port against reference {spread:.3e}")
    return amps, spread


def _allowed(ref: float, spread: float) -> float:
    """How far the port's amplification may lie from the reference's: 10%,
    and the two packages' own distance unperturbed, which both moves carry,
    over EPS (a Mamba1 stack's logits barely move, and there rounding
    is most of the move)."""
    return 0.1 * ref + 2 * spread / EPS


def _frozen(d) -> tuple:
    return tuple(sorted(d.items()))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_amplification_matches_reference(name):
    """Each family's logits move by the same multiple of the perturbation
    in both packages: the sensitivity is the model's."""
    amps, spread = _amplification(name, _frozen(FAMILIES[name]))
    for ref, port in amps:
        assert abs(port - ref) <= _allowed(ref, spread), (ref, port)
    assert spread <= RTOL


def test_the_hybrid_amplifies_most():
    """zamba2's Mamba2 stack amplifies rounding several times more than a
    dense stack and a Mamba1 stack of the same depth and width, in the
    reference."""
    ref = {name: min(a for a, _ in _amplification(
        name, _frozen(FAMILIES[name]))[0]) for name in FAMILIES}
    worst_other = max(ref["olmo-1b"], ref["falcon-mamba-7b"])
    assert ref[HYBRID] >= 3 * worst_other, ref


def test_hybrid_cut_at_full_width():
    """The card's (a) cut of zamba2 at its published widths: the two
    packages amplify alike, more than 10x, and lie within the hybrid's
    (a) limit (1e-4) of each other."""
    amps, spread = _amplification(HYBRID, _frozen(HYBRID_CUT),
                                  reduced=False)
    for ref, port in amps:
        assert abs(port - ref) <= _allowed(ref, spread), (ref, port)
        assert ref > 10, ref
    assert spread <= 1e-4


def test_windowed_decode_after_chunked_prefill_matches_prefills():
    """zamba2 reduced at ``n_layers=5`` (2 units and a tail of 1), window 8,
    ``attn_chunk`` 16: a chunked prefill of 32 tokens (two query tiles)
    then 20 decode steps, the logits against a full-route prefill of the
    same tokens (the reference's every tenth step, the port's every
    fourth), and every step of the port against the reference's."""
    changes = dict(n_layers=5, attn_window=8, attn_chunk=16)
    rc, cfg, rp = _pair(HYBRID, changes)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    rfull, tfull = (dataclasses.replace(c, attn_impl="full")
                    for c in (rc, cfg))
    rchunk, tchunk = (dataclasses.replace(c, attn_impl="chunked")
                      for c in (rc, cfg))
    b, t, steps = 2, 32, 20
    s_max = t + steps
    toks = np.random.default_rng(7).integers(
        1, cfg.vocab - 1, (b, s_max)).astype(np.int32)

    def ref_prefill(c, n):
        return RM.prefill(c, rp, {"tokens": jnp.asarray(toks[:, :n])},
                          RM.make_caches(c, b, s_max, jnp.float32))

    def port_prefill(c, n):
        return M.prefill(c, tp, {"tokens": torch.as_tensor(toks[:, :n])},
                         M.make_caches(c, b, s_max, torch.float32,
                                       device="cpu"))

    ref_decode = jax.jit(functools.partial(RM.decode_step, rc))
    rcache, rl = ref_prefill(rchunk, t)
    tcache, tl = port_prefill(tchunk, t)
    for step in range(steps + 1):
        n = t + step
        if step % 10 == 0:
            want = np.asarray(ref_prefill(rfull, n)[1])
            assert _rel(rl, want) <= RTOL, ("reference", step)
        if step % 4 == 0:
            want = port_prefill(tfull, n)[1].numpy()
            assert _rel(tl.numpy(), want) <= RTOL, ("port", step)
        assert _rel(tl.numpy(), rl) <= RTOL, ("port vs reference", step)
        if step == steps:
            break
        pos = np.array([n], np.int32)
        rcache, rl = ref_decode(rp, rcache, {
            "tokens": jnp.asarray(toks[:, n:n + 1]),
            "position": jnp.asarray(pos)})
        tcache, tl = M.decode_step(cfg, tp, tcache, {
            "tokens": torch.as_tensor(toks[:, n:n + 1]),
            "position": torch.as_tensor(pos)})
