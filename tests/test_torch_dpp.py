"""The port's chains, greedy MAP and log-likelihood (core/dpp.py) against
the JAX package on the same seeded numpy inputs (f64).

The reference draws inside its steps from a ``jax.random`` key; each
test replays those draws from the key (``_dpp_draws``, ``_kdpp_draws``)
and feeds them to the port. Discrete outcomes must be equal: masks,
accept counts, quadrature iteration counts, certification, greedy
orders. Greedy gains agree to 1e-12 relative; log-likelihood brackets
agree to 1e-12 and contain the ``slogdet`` truth."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import dpp as rdpp  # noqa: E402
from repro.core import update as rup  # noqa: E402
from repro.core.trace import _rademacher_probe  # noqa: E402
from repro.data import random_sparse_spd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dpp as tdpp  # noqa: E402
from repro_torch.core import update as tup  # noqa: E402
from conftest import make_spd  # noqa: E402

N = 40
STEPS = 60


def _t(x):
    return torch.as_tensor(np.array(x))


def _dpp_draws(key, n, steps):
    """The draws the reference's dpp_step takes from its key, in order."""
    ys, ps = [], []
    for _ in range(steps):
        key, k_y, k_p = jax.random.split(key, 3)
        ys.append(int(jax.random.randint(k_y, (), 0, n)))
        ps.append(np.float32(jax.random.uniform(k_p, (), jnp.float32)))
    return tdpp.DppDraws(y=torch.tensor(ys), p=torch.tensor(ps))


def _kdpp_draws(key, n, steps):
    """The draws the reference's kdpp_step takes from its key."""
    gv, gu, ps = [], [], []
    for _ in range(steps):
        key, k_v, k_u, k_p = jax.random.split(key, 4)
        gv.append(np.asarray(jax.random.gumbel(k_v, (n,), jnp.float32)))
        gu.append(np.asarray(jax.random.gumbel(k_u, (n,), jnp.float32)))
        ps.append(np.float32(jax.random.uniform(k_p, (), jnp.float32)))
    return tdpp.KdppDraws(g_v=_t(np.stack(gv)), g_u=_t(np.stack(gu)),
                          p=torch.tensor(ps))


@pytest.fixture(scope="module")
def setup():
    a = random_sparse_spd(N, density=0.15, lam_min=5e-2, seed=4)
    w = np.linalg.eigvalsh(a)
    return a, float(w[0] * 0.9), float(w[-1] * 1.1)


def _same_chain(got, want):
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.dtype == torch.float32
    for f in tdpp.ChainStats._fields:
        assert int(getattr(got.stats, f)) == int(getattr(want.stats, f)), f


def _init(seed, k=None):
    rng = np.random.default_rng(seed)
    if k is None:
        return (rng.random(N) < 0.3).astype(np.float64)
    m = np.zeros(N)
    m[rng.choice(N, k, replace=False)] = 1.0
    return m


@pytest.mark.parametrize("mode", ["quadrature", "exact", "incremental"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dpp_chain_matches_reference(setup, seed, mode):
    a, lmn, lmx = setup
    init = _init(seed)
    key = jax.random.key(seed)
    kw = dict(max_iters=N + 2, exact=mode == "exact",
              incremental=mode == "incremental")
    want = R.sample_dpp(R.Dense(jnp.asarray(a)), key, jnp.asarray(init),
                        STEPS, lmn, lmx, **kw)
    got = T.sample_dpp(T.Dense(_t(a)), _dpp_draws(key, N, STEPS), _t(init),
                       STEPS, lmn, lmx, **kw)
    _same_chain(got, want)
    assert int(got.stats.uncertified) == 0
    if mode == "incremental":
        assert int(got.stats.quad_iterations) == 0
        f = got.factor
        sel = f.idx[:int(f.count)].tolist()
        assert sorted(sel) == np.flatnonzero(got.mask.numpy() > 0.5).tolist()
        np.testing.assert_allclose(
            f.chol.numpy()[:len(sel), :len(sel)],
            np.linalg.cholesky(a[np.ix_(sel, sel)]), atol=1e-10)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_dpp_chain_on_kernel_backends_matches_reference(setup, backend):
    """The kernels' plain versions on the CPU: K1 per judge on 'pallas',
    K3 on 'fused'; the same moves as the reference backend's."""
    a, lmn, lmx = setup
    init = _init(2)
    key = jax.random.key(2)
    want = R.sample_dpp(R.Dense(jnp.asarray(a)), key, jnp.asarray(init),
                        STEPS, lmn, lmx, max_iters=N + 2)
    s = T.BIFSolver.create(max_iters=N + 2, backend=backend)
    got = T.sample_dpp(T.Dense(_t(a)), _dpp_draws(key, N, STEPS), _t(init),
                       STEPS, lmn, lmx, max_iters=N + 2, solver=s)
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert int(got.stats.accepts) == int(want.stats.accepts)
    assert int(got.stats.uncertified) == 0


@pytest.mark.parametrize("mode", ["batched", "pair", "exact", "incremental",
                                  "chunked"])
def test_kdpp_chain_matches_reference(setup, mode):
    a, lmn, lmx = setup
    k = 12
    init = _init(5, k)
    key = jax.random.key(105)
    op_r = R.Dense(jnp.asarray(a))
    draws = _kdpp_draws(key, N, STEPS)
    factor_r = factor_t = None
    if mode == "incremental":
        factor_r = rup.from_mask(op_r, jnp.asarray(init), capacity=k)
        factor_t = tup.from_mask(T.Dense(_t(a)), _t(init), capacity=k)
    if mode in ("batched", "exact", "incremental"):
        want = rdpp.run_chain(rdpp.kdpp_step, op_r, key, jnp.asarray(init),
                              STEPS, lmn, lmx, max_iters=N + 2,
                              exact=mode == "exact", factor=factor_r)
        got = tdpp.run_chain(tdpp.kdpp_step, T.Dense(_t(a)), draws,
                             _t(init), STEPS, lmn, lmx, max_iters=N + 2,
                             exact=mode == "exact", factor=factor_t)
    else:
        kw = dict(batched=False) if mode == "pair" else dict(chunk_iters=3)
        st_r = rdpp.init_chain(key, jnp.asarray(init))
        st_t = tdpp.init_chain(_t(init))
        step = jax.jit(lambda s: rdpp.kdpp_step(op_r, s, lmn, lmx,
                                                max_iters=N + 2, **kw))
        for i in range(STEPS):
            st_r = step(st_r)
            st_t = tdpp.kdpp_step(T.Dense(_t(a)), st_t, lmn, lmx,
                                  draws=tdpp.KdppDraws(*(x[i] for x in draws)),
                                  max_iters=N + 2, **kw)
        want, got = st_r, st_t
    _same_chain(got, want)
    assert int(got.mask.sum()) == k
    assert int(got.stats.uncertified) == 0


def test_chain_state_converts_and_resumes(setup):
    """A reference chain state (mask, stats, carried factor) converted to
    the port runs on exactly as the reference's."""
    a, lmn, lmx = setup
    init = _init(3)
    key = jax.random.key(9)
    op_r = R.Dense(jnp.asarray(a))
    st = rdpp.init_chain(key, jnp.asarray(init),
                         factor=rup.from_mask(op_r, jnp.asarray(init)))
    step = jax.jit(lambda s: rdpp.dpp_step(op_r, s, lmn, lmx,
                                           max_iters=N + 2))
    for _ in range(10):
        st = step(st)
    f = st.factor
    leaves = {"mask": np.asarray(st.mask), "key": None,
              "stats": {k: np.asarray(getattr(st.stats, k))
                        for k in st.stats._fields},
              "factor": {"idx": np.asarray(f.idx), "chol": np.asarray(f.chol),
                         "count": np.asarray(f.count),
                         "ok": np.asarray(f.ok), "n": f.n}}
    st_t = convert.state_from_numpy(leaves, device="cpu")
    assert isinstance(st_t, tdpp.ChainState)
    draws = _dpp_draws(st.key, N, 10)
    for i in range(10):
        st = step(st)
        st_t = tdpp.dpp_step(T.Dense(_t(a)), st_t, lmn, lmx,
                             draws=tdpp.DppDraws(*(x[i] for x in draws)),
                             max_iters=N + 2)
    _same_chain(st_t, st)
    np.testing.assert_allclose(st_t.factor.chol.numpy(),
                               np.asarray(st.factor.chol), atol=1e-12)


def test_generator_draws_equal_their_table(setup):
    a, lmn, lmx = setup
    init = _t(_init(4))
    op = T.Dense(_t(a))
    for step, draw, sample in ((tdpp.dpp_step, tdpp.dpp_draws,
                                T.sample_dpp),
                               (tdpp.kdpp_step, tdpp.kdpp_draws,
                                T.sample_kdpp)):
        by_gen = sample(op, torch.Generator().manual_seed(7), init, 20, lmn,
                        lmx, max_iters=N + 2, exact=True)
        table = draw(torch.Generator().manual_seed(7), N, 20)
        by_table = tdpp.run_chain(step, op, table, init, 20, lmn, lmx,
                                  max_iters=N + 2, exact=True)
        assert torch.equal(by_gen.mask, by_table.mask)
        assert int(by_gen.stats.accepts) == int(by_table.stats.accepts)
    with pytest.raises(ValueError, match="cannot drive"):
        tdpp.run_chain(tdpp.dpp_step, op, tdpp.dpp_draws(
            torch.Generator().manual_seed(0), N, 3), init, 4, lmn, lmx,
            max_iters=N + 2)


def test_chain_arguments_are_checked(setup):
    a, lmn, lmx = setup
    op = T.Dense(_t(a))
    init = _t(_init(0))
    st = tdpp.init_chain(init, factor=tup.from_mask(op, init))
    d1 = tdpp.DppDraws(torch.tensor(0), torch.tensor(0.5))
    with pytest.raises(ValueError, match="exact=True"):
        tdpp.dpp_step(op, st, lmn, lmx, draws=d1, max_iters=8, exact=True)
    with pytest.raises(ValueError, match="fn='inv'"):
        tdpp.dpp_step(op, tdpp.init_chain(init), lmn, lmx, draws=d1,
                      max_iters=8,
                      solver=T.BIFSolver.create(max_iters=8, fn="log"))
    dk = tdpp.KdppDraws(torch.zeros(N), torch.zeros(N), torch.tensor(0.5))
    with pytest.raises(NotImplementedError, match="mesh"):
        tdpp.kdpp_step(op, tdpp.init_chain(init), lmn, lmx, draws=dk,
                       max_iters=8, mesh=object())
    with pytest.raises(ValueError, match="chunk_iters"):
        tdpp.kdpp_step(op, tdpp.init_chain(init), lmn, lmx, draws=dk,
                       max_iters=8, batched=False, chunk_iters=2)
    with pytest.raises(NotImplementedError, match="mesh"):
        T.greedy_map(op, 2, lmn, lmx, max_iters=8, mesh=object())
    with pytest.raises(ValueError, match="incremental"):
        T.greedy_map(op, 2, lmn, lmx, max_iters=8, exact=True,
                     incremental=True)


def _greedy_case():
    a = make_spd(N, kappa=200.0, seed=5)
    w = np.linalg.eigvalsh(a)
    return a, float(w[0] * 0.99), float(w[-1] * 1.01)


@pytest.mark.parametrize("mode,backend", [
    (m, b) for m in ("cold", "warm_start", "incremental")
    for b in ("reference", "pallas", "fused")] + [("exact", "reference")])
def test_greedy_map_matches_reference(mode, backend):
    a, lo, hi = _greedy_case()
    k = 10
    kw = dict(max_iters=60, exact=mode == "exact",
              warm_start=mode == "warm_start",
              incremental=mode == "incremental")
    want = R.greedy_map(R.Dense(jnp.asarray(a)), k, lo, hi, **kw)
    got = T.greedy_map(T.Dense(_t(a)), k, lo, hi,
                       solver=T.BIFSolver.create(max_iters=60,
                                                 backend=backend), **kw)
    assert np.array_equal(got.order.numpy(), np.asarray(want.order))
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert np.array_equal(got.certified.numpy(), np.asarray(want.certified))
    assert int(got.uncertified) == int(want.uncertified) == 0
    np.testing.assert_allclose(got.gains.numpy(), np.asarray(want.gains),
                               rtol=1e-12)
    if backend == "reference":
        assert int(got.quad_iterations) == int(want.quad_iterations)
    if mode == "incremental":
        assert int(got.quad_iterations) == k * N


def test_greedy_map_on_a_masked_operator_matches_reference():
    a, _, _ = _greedy_case()
    m = (np.random.default_rng(6).random(N) < 0.8).astype(np.float64)
    ref = np.diag(m) @ a @ np.diag(m) + np.eye(N) - np.diag(m)
    w = np.linalg.eigvalsh(ref)
    lo, hi = float(w[0] * 0.99), float(w[-1] * 1.01)
    for kw in (dict(), dict(incremental=True)):
        want = R.greedy_map(R.Masked(R.Dense(jnp.asarray(a)), jnp.asarray(m)),
                            8, lo, hi, max_iters=60, **kw)
        got = T.greedy_map(T.Masked(T.Dense(_t(a)), _t(m)), 8, lo, hi,
                           max_iters=60, **kw)
        assert np.array_equal(got.order.numpy(), np.asarray(want.order))
        assert int(got.quad_iterations) == int(want.quad_iterations)


def _logdet_truth(a, mask):
    sel = np.flatnonzero(mask > 0.5)
    return (np.linalg.slogdet(a[np.ix_(sel, sel)])[1]
            - np.linalg.slogdet(a + np.eye(len(a)))[1])


def test_log_likelihood_exact_probes_match_reference_and_bracket_truth():
    n = 12
    a = make_spd(n, kappa=30.0, seed=3)
    w = np.linalg.eigvalsh(a)
    lmn, lmx = float(w[0] * 0.9), float(w[-1] * 1.1)
    mask = np.zeros(n)
    mask[[0, 3, 4, 9, 11]] = 1.0
    want = R.log_likelihood(R.Dense(jnp.asarray(a)), jnp.asarray(mask),
                            lmn, lmx, max_iters=n + 2)
    got = T.log_likelihood(T.Dense(_t(a)), _t(mask), lmn, lmx,
                           max_iters=n + 2)
    truth = _logdet_truth(a, mask)
    assert got.lower <= truth <= got.upper
    for f in ("lower", "upper", "estimate"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)
    assert got.iterations == want.iterations


def test_log_likelihood_with_replayed_probes_matches_reference():
    n, p = 16, 4
    a = make_spd(n, kappa=30.0, seed=8)
    w = np.linalg.eigvalsh(a)
    lmn, lmx = float(w[0] * 0.9), float(w[-1] * 1.1)
    mask = (np.random.default_rng(2).random(n) < 0.5).astype(np.float64)
    key = jax.random.key(5)
    want = R.log_likelihood(R.Dense(jnp.asarray(a)), jnp.asarray(mask),
                            lmn, lmx, num_probes=p, key=key, max_iters=n + 2)
    k_y, k_n = jax.random.split(key)
    zs = [np.stack([np.asarray(_rademacher_probe(k, i, n, np.float64))
                    for i in range(p)]) for k in (k_y, k_n)]
    got = T.log_likelihood(T.Dense(_t(a)), _t(mask), lmn, lmx,
                           num_probes=p, probes=zs, max_iters=n + 2)
    for f in ("lower", "upper", "estimate", "stat_lower", "stat_upper"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)
    assert got.iterations == want.iterations
    with pytest.raises(ValueError, match="pair"):
        T.log_likelihood(T.Dense(_t(a)), _t(mask), lmn, lmx, num_probes=p,
                         probes=zs[:1])
