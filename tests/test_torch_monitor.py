"""The port's GQL spectral monitor (train/monitor.py) against the JAX
package (f32).

The reference draws each leaf's projection from ``fold_in(key(seed), i)``;
the tests feed those draws to the port through ``projections=``. The
port's own draws are counter-based: an entry depends on (seed, leaf, row,
column) alone, so blocked and whole draws give the same bits.

Tolerances: sketches within 1e-5 relative; brackets within 1e-4 relative
of the reference's, with equal iteration counts (the logdet's total over
its 16 unit probes within 1: in f32 one probe may take one more step to
meet its rtol); every bracket holds its
dense f64 truth up to f32 rounding (1e-6 relative). ``kappa_lower``: the
port's divides the bare Ritz values and stays at or below the truth; the
reference's divides the 1%-widened interval and lands above it (pinned
here; ROADMAP Queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import monitor as rmon  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import monitor as tmon  # noqa: E402

LAM = 1e-3
F32 = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and beside other test
    workers torch's default of a thread a core oversubscribes the CPU
    (about 10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_projections(leaves, k, seed=0):
    key = jax.random.key(seed)
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                         (k, leaf.size), jnp.float32))
            for i, leaf in enumerate(leaves)]


@pytest.fixture(scope="module")
def model():
    rc, cfg = ref_arch("olmo-1b").reduced(), get_arch("olmo-1b").reduced()
    rp, _ = RM.init_model(jax.random.key(0), rc)
    tp = convert.params_from_numpy(
        cfg, [np.asarray(x) for x in jax.tree.leaves(rp)], device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 33)) \
        .astype(np.int32)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "labels": torch.as_tensor(toks[:, 1:])}
    return rc, cfg, rp, tp, rb, tb


def _truths(s: np.ndarray, probe: np.ndarray):
    f = s.T.astype(np.float64) @ s.astype(np.float64) / s.shape[0] \
        + LAM * np.eye(s.shape[1])
    w = np.linalg.eigvalsh(f)
    return {"nat": float(probe @ np.linalg.solve(f, probe)),
            "logdet": float(np.linalg.slogdet(f)[1]),
            "kappa": float(w[-1] / w[0])}


def _holds(lo, hi, truth, slack=F32):
    pad = slack * abs(truth)
    return lo - pad <= truth <= hi + pad


def test_gradient_sketch_with_reference_projections(model):
    rc, cfg, rp, tp, rb, tb = model
    rg = jax.grad(lambda p: RM.loss_fn(rc, p, rb)[0])(rp)
    _, tg = M.value_and_grad(cfg, tp, tb)
    projs = _ref_projections(jax.tree.leaves(rg), 16, seed=3)
    want = np.asarray(rmon.gradient_sketch(rg, num_probes=16, seed=3))
    got = tmon.gradient_sketch(tg, num_probes=16, projections=projs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_blocked_and_whole_draws_are_bit_equal():
    whole = tmon.projection(3, 2, 5, 0, 1000)
    cuts = (0, 7, 300, 301, 1000)
    blocked = torch.cat([tmon.projection(3, 2, 5, a, b)
                         for a, b in zip(cuts[:-1], cuts[1:])], dim=1)
    assert torch.equal(whole, blocked)
    assert torch.equal(tmon.projection(3, 2, 5, 0, 1000), whole)
    # columns past 2^32 (leaves larger than 4.3e9 entries) draw afresh
    hi = tmon.projection(3, 2, 5, 2 ** 32, 2 ** 32 + 1000)
    assert not torch.equal(hi, whole) and torch.isfinite(hi).all()
    assert torch.isfinite(whole).all()


def test_draws_are_standard_normal_and_independent():
    x = tmon.projection(0, 0, 4, 0, 200_000).double()
    assert abs(x.mean().item()) < 0.01
    assert abs(x.std().item() - 1.0) < 0.01
    kurt = ((x - x.mean()) ** 4).mean() / x.var() ** 2
    assert abs(kurt.item() - 3.0) < 0.05
    c = torch.corrcoef(torch.cat([x, tmon.projection(1, 0, 1, 0, 200_000),
                                  tmon.projection(0, 1, 1, 0, 200_000)
                                  ]).double())
    off = c - torch.diag(torch.diag(c))
    assert off.abs().max().item() < 0.01


def test_blocked_sketch_equals_whole_matrices(model, monkeypatch):
    _, cfg, _, tp, _, tb = model
    _, tg = M.value_and_grad(cfg, tp, tb)
    big = tmon.gradient_sketch(tg, num_probes=8, seed=5)
    monkeypatch.setattr(tmon, "_BLOCK_ELEMS", 8 * 37)
    small = tmon.gradient_sketch(tg, num_probes=8, seed=5)
    from repro_torch import tree
    leaves = tree.leaves(tg)
    whole = tmon.gradient_sketch(tg, num_probes=8, projections=[
        tmon.projection(5, i, 8, 0, x.numel()) for i, x in enumerate(leaves)])
    np.testing.assert_allclose(small.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(big.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)
    again = tmon.gradient_sketch(tg, num_probes=8, seed=5)
    assert torch.equal(small, again)
    assert not torch.allclose(big, tmon.gradient_sketch(tg, num_probes=8,
                                                        seed=6))


@pytest.fixture(scope="module")
def sketches():
    rng = np.random.default_rng(7)
    s = (rng.standard_normal((6, 16)) * np.logspace(-2, -1, 16)
         ).astype(np.float32)
    return s, s.mean(0)


def test_fisher_proxy_bounds(sketches):
    s, probe = sketches
    want = rmon.fisher_proxy_bounds(jnp.asarray(s), jnp.asarray(probe),
                                    lam=LAM)
    got = tmon.fisher_proxy_bounds(torch.as_tensor(s), torch.as_tensor(probe),
                                   lam=LAM)
    assert int(got.iterations) == int(want.iterations)
    for g, w in ((got.lower, want.lower), (got.upper, want.upper)):
        assert abs(float(g) - float(w)) <= 1e-4 * abs(float(w))
    assert _holds(float(got.lower), float(got.upper),
                  _truths(s, probe)["nat"])


def test_logdet_bounds(sketches):
    s, probe = sketches
    want = rmon.logdet_bounds(jnp.asarray(s), lam=LAM)
    got = tmon.logdet_bounds(torch.as_tensor(s), lam=LAM)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    for g, w in ((got.lower, want.lower), (got.upper, want.upper)):
        assert abs(float(g) - float(w)) <= 1e-4 * abs(float(w))
    assert _holds(float(got.lower), float(got.upper),
                  _truths(s, probe)["logdet"])


def test_condition_number_bounds(sketches):
    """The port's kappa_lower is at most the truth; the reference's lands
    above it (a fault of the reference: Queue 3); kappa_upper and
    lam_max_est equal the reference's and kappa_upper holds the truth."""
    s, probe = sketches
    truth = _truths(s, probe)["kappa"]
    want = rmon.condition_number_bounds(jnp.asarray(s), lam=LAM)
    got = tmon.condition_number_bounds(torch.as_tensor(s), lam=LAM)
    for k in ("kappa_upper", "lam_max_est"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k])
    assert got["kappa_lower"] <= truth * (1 + F32)
    assert got["kappa_lower"] >= 0.99 * truth     # Lanczos has converged
    assert want["kappa_lower"] > truth * (1 + 1e-3)
    assert got["kappa_upper"] >= truth


def test_make_monitor_matches_reference(model):
    rc, cfg, rp, tp, rb, tb = model
    projs = _ref_projections(jax.tree.leaves(rp), 16)
    want = rmon.make_monitor(RM.loss_fn, rc, per_example=2,
                             sketch_dim=16)(rp, rb)
    got = tmon.make_monitor(M.loss_fn, cfg, per_example=2, sketch_dim=16,
                            projections=projs, device="cpu")(tp, tb)
    assert set(got) == set(want)
    assert got["quad_iters"] == want["quad_iters"]
    for k in set(want) - {"quad_iters", "kappa_lower"}:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k
    s = tmon.example_sketches(M.loss_fn, cfg, tp, tb, n=2, sketch_dim=16,
                              projections=projs).numpy()
    t = _truths(s, s.mean(0))
    assert _holds(got["nat_norm_lower"], got["nat_norm_upper"], t["nat"])
    assert _holds(got["logdet_lower"], got["logdet_upper"], t["logdet"])
    assert got["kappa_lower"] <= t["kappa"] * (1 + F32) < want["kappa_lower"]
    assert got["kappa_upper"] >= t["kappa"]


def test_make_monitor_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the raise on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmon.make_monitor(M.loss_fn, get_arch("olmo-1b").reduced())
