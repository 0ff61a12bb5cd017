"""The port's incremental Cholesky factor (core/update.py) against the
JAX package on the same seeded numpy inputs (f64): ``extend`` /
``downdate`` / ``from_mask`` factors, exact BIFs and all-candidate gains
to 1e-12, the reference's slot layout (insertion order, identity and the
sentinel on empty slots), the overflow flag, and a reference factor
converted to the port and extended in both."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import update as rup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import update as tup  # noqa: E402
from conftest import make_spd  # noqa: E402

N = 12


def _t(x):
    return torch.as_tensor(np.array(x))


def _same_factor(got, want, tol=1e-12):
    """Port factor against a reference factor: equal slots, count and
    flag; Cholesky entries within ``tol`` of the largest."""
    assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert int(got.count) == int(want.count)
    assert bool(got.ok) == bool(want.ok)
    assert got.n == want.n
    w = np.asarray(want.chol)
    np.testing.assert_allclose(got.chol.numpy(), w, rtol=0,
                               atol=tol * np.abs(w).max())


def _dense_chol(a, sel):
    return np.linalg.cholesky(a[np.ix_(sel, sel)])


@pytest.fixture(scope="module")
def spd():
    return make_spd(N, kappa=80.0, seed=0)


def test_extend_and_downdate_match_reference_and_from_mask(spd):
    a = spd
    fr = rup.init_factor(N, 8, dtype=jnp.float64)
    ft = tup.init_factor(N, 8, dtype=torch.float64)
    sel = []
    for y in (3, 7, 1, 9, 5):
        fr = rup.extend(fr, jnp.asarray(a[:, y]), y)
        ft = tup.extend(ft, _t(a[:, y]), y)
        sel.append(y)
        _same_factor(ft, fr)
        np.testing.assert_allclose(ft.chol.numpy()[:len(sel), :len(sel)],
                                   _dense_chol(a, sel), atol=1e-12)

    # a middle, the first and the last item: the downdate equals the
    # reference's and the factor built from scratch of what is left
    for y in (1, 3, 5):
        got = tup.downdate(ft, y)
        _same_factor(got, rup.downdate(fr, y))
        rest = [s for s in sel if s != y]
        mask = np.zeros(N)
        mask[rest] = 1.0
        scratch = tup.from_mask(T.Dense(_t(a)), _t(mask), capacity=8)
        k = len(rest)
        assert sorted(got.idx[:k].tolist()) == sorted(rest)
        # from_mask inserts in index order, the downdate keeps insertion
        # order: compare the factored submatrices
        perm = [scratch.idx[:k].tolist().index(s)
                for s in got.idx[:k].tolist()]
        lg = got.chol.numpy()[:k, :k]
        ls = scratch.chol.numpy()[:k, :k]
        np.testing.assert_allclose(lg @ lg.T, (ls @ ls.T)[np.ix_(perm, perm)],
                                   atol=1e-12 * np.abs(a).max())
        np.testing.assert_allclose(lg, _dense_chol(a, list(
            got.idx[:k].tolist())), atol=1e-12)

    # downdate of an absent item is the identity
    assert tup.downdate(ft, 4) is ft

    # overflow: extending past capacity flips ok and keeps the rest
    fo_t, fo_r = ft, fr
    for y in (0, 2, 4, 6):
        fo_t = tup.extend(fo_t, _t(a[:, y]), y)
        fo_r = rup.extend(fo_r, jnp.asarray(a[:, y]), y)
    _same_factor(fo_t, fo_r)
    assert int(fo_t.count) == 8 and not bool(fo_t.ok)


def test_bif_solve_w_and_gains_match_reference(spd):
    a = spd
    sel = [3, 7, 1, 9, 5]
    mask = np.zeros(N)
    mask[sel] = 1.0
    fr = rup.from_mask(R.Dense(jnp.asarray(a)), jnp.asarray(mask))
    ft = tup.from_mask(T.Dense(_t(a)), _t(mask))
    _same_factor(ft, fr)
    assert ft.capacity == N
    u = np.random.default_rng(1).standard_normal(N)
    np.testing.assert_allclose(tup.solve_w(ft, _t(u)).numpy(),
                               np.asarray(rup.solve_w(fr, jnp.asarray(u))),
                               rtol=1e-12, atol=1e-14)
    truth = u[sel] @ np.linalg.solve(a[np.ix_(sel, sel)], u[sel])
    got = float(tup.bif(ft, _t(u)))
    assert got == pytest.approx(float(rup.bif(fr, jnp.asarray(u))),
                                rel=1e-12)
    assert got == pytest.approx(truth, rel=1e-10)
    g_t = tup.gains(ft, _t(np.diag(a)), _t(a)).numpy()
    g_r = np.asarray(rup.gains(fr, jnp.asarray(np.diag(a)), jnp.asarray(a)))
    np.testing.assert_allclose(g_t, g_r, rtol=0,
                               atol=1e-12 * np.abs(g_r).max())


@pytest.mark.parametrize("capacity", [None, 6])
def test_from_mask_matches_reference_on_a_masked_operator(spd, capacity):
    """from_mask reads columns through the operator's matvec (here a
    Masked one, whose unselected columns are identity columns)."""
    a = spd
    rng = np.random.default_rng(4)
    base = (rng.random(N) < 0.8).astype(np.float64)
    sel = np.zeros(N)
    sel[[0, 2, 5, 8, 11]] = 1.0
    fr = rup.from_mask(R.Masked(R.Dense(jnp.asarray(a)), jnp.asarray(base)),
                       jnp.asarray(sel), capacity)
    ft = tup.from_mask(T.Masked(T.Dense(_t(a)), _t(base)), _t(sel),
                       capacity)
    _same_factor(ft, fr)


def test_tree_select_picks_fieldwise(spd):
    a = spd
    f0 = tup.init_factor(N, 4, dtype=torch.float64)
    f1 = tup.extend(f0, _t(a[:, 2]), 2)
    for pred, want in ((True, f1), (False, f0)):
        got = tup.tree_select(torch.tensor(pred), f1, f0)
        assert torch.equal(got.chol, want.chol)
        assert torch.equal(got.idx, want.idx)
        assert int(got.count) == int(want.count)


def test_reference_factor_converts_and_extends_alike(spd):
    a = spd
    mask = np.zeros(N)
    mask[[2, 6, 10]] = 1.0
    fr = rup.from_mask(R.Dense(jnp.asarray(a)), jnp.asarray(mask),
                       capacity=7)
    leaves = {k: np.asarray(getattr(fr, k)) for k in ("idx", "chol",
                                                      "count", "ok")}
    ft = convert.state_from_numpy({**leaves, "n": fr.n}, device="cpu")
    assert isinstance(ft, tup.ChainFactor)
    _same_factor(ft, fr, tol=0.0)
    _same_factor(tup.extend(ft, _t(a[:, 4]), 4),
                 rup.extend(fr, jnp.asarray(a[:, 4]), 4))
    _same_factor(tup.downdate(ft, 6), rup.downdate(fr, 6))
