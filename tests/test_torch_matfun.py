"""The port's matrix-function quadrature (``repro_torch.core.matfun`` and
the solver's ``fn != 'inv'`` path) against the JAX package on the same
seeded numpy inputs, in f64.

Tolerances: discrete outcomes (iterations, certification, decisions)
exactly equal; brackets within 1e-12 relative on the f64 paths and 1e-5
where a blocked-ELL matvec runs the K2 kernel's f32 contract
(``backend='pallas'``); every bracket contains the dense-``eigh`` truth
(slack 1e-8 relative, 1e-5 on the f32 path). Resume invariants inside the
port are bit-exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import matfun as rmf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import matfun as tmf  # noqa: E402
from conftest import make_spd  # noqa: E402

N, K = 33, 4
FNS = list(tmf.REGISTRY)
OP_KINDS = ["dense", "bell", "coo"]
BACKENDS = ["reference", "pallas", "fused"]
_F = {"inv": lambda x: 1.0 / x, "log": np.log,
      "invsqrt": lambda x: x ** -0.5, "sqrt": np.sqrt}


def _t(x):
    return torch.as_tensor(np.array(x))


def _problem(seed=3, kappa=150.0):
    a = make_spd(N, kappa=kappa, seed=seed, density=0.4)
    w = np.linalg.eigvalsh(a)
    us = np.random.default_rng(seed + 1).standard_normal((K, N))
    return a, us, float(w[0] * 0.99), float(w[-1] * 1.01)


def _ops(kind, a):
    if kind == "dense":
        return R.Dense(jnp.asarray(a)), T.Dense(_t(a))
    if kind == "bell":
        return (R.bell_from_dense(a, bs=8),
                T.bell_from_dense(a, bs=8, device="cpu"))
    if kind == "coo":
        return R.sparse_from_dense(a), T.sparse_from_dense(a, device="cpu")
    raise AssertionError(kind)


def _truth(a, us, fn):
    w, v = np.linalg.eigh(a)
    c = us @ v
    return np.sum(c * c * _F[fn](w), axis=-1)


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _contains(lo, hi, truth, slack):
    tol = slack * np.maximum(np.abs(truth), 1.0)
    assert np.all(np.asarray(lo) <= truth + tol), (lo, truth)
    assert np.all(np.asarray(hi) >= truth - tol), (hi, truth)


def _np_fields(obj):
    """A state's fields as numpy (nested states as dicts), the form
    ``convert.state_from_numpy`` takes."""
    if hasattr(obj, "_fields"):
        names = obj._fields
    else:
        names = [f.name for f in dataclasses.fields(obj)]
    out = {}
    for name in names:
        v = getattr(obj, name)
        if v is None or isinstance(v, (int, float)):
            out[name] = v
        elif hasattr(v, "_fields") or dataclasses.is_dataclass(v):
            out[name] = _np_fields(v)
        else:
            out[name] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# every registry fn x operator x backend against the reference


_JAX = {}


def _jax_solve(fn, kind, jbackend, a, us, iv):
    """The JAX package's solve_batch, once per (fn, operator, backend).
    The JAX side runs its reference backend (its own tests pin 'pallas'
    and 'fused' to it) except BELL on 'pallas', whose f32 SpMV changes
    the arithmetic: that case runs the Pallas kernels in interpret mode."""
    key = (fn, kind, jbackend)
    if key not in _JAX:
        jop, _ = _ops(kind, a)
        js = R.BIFSolver.create(max_iters=30, rtol=1e-6, fn=fn,
                                backend=jbackend, pallas_interpret=True)
        _JAX[key] = js.solve_batch(jop, jnp.asarray(us), **iv)
    return _JAX[key]


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("kind", OP_KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_batch_matches_reference_and_contains_truth(fn, kind,
                                                          backend):
    a, us, lmn, lmx = _problem()
    iv = dict(lam_min=lmn, lam_max=lmx)
    f32 = (kind, backend) == ("bell", "pallas")
    jr = _jax_solve(fn, kind, "pallas" if f32 else "reference", a, us, iv)
    _, top = _ops(kind, a)
    ts = T.BIFSolver.create(max_iters=30, rtol=1e-6, fn=fn, backend=backend)
    tr = ts.solve_batch(top, _t(us), **iv)
    rtol = 1e-5 if f32 else 1e-12
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.certified.numpy(),
                                  np.asarray(jr.certified))
    for f in ("lower", "upper", "gauss_lower", "lobatto_upper"):
        _close(getattr(tr, f).numpy(), getattr(jr, f), rtol, f)
    truth = _truth(a, us, fn)
    _contains(tr.lower.numpy(), tr.upper.numpy(), truth,
              1e-5 if f32 else 1e-8)
    # the loose family sits outside the tight one (orientation table)
    assert np.all(tr.gauss_lower.numpy() <= tr.lower.numpy()
                  + 1e-8 * np.abs(truth))
    assert np.all(tr.lobatto_upper.numpy() >= tr.upper.numpy()
                  - 1e-8 * np.abs(truth))
    assert tr.state.coeffs is not None or fn == "inv"


@pytest.mark.parametrize("fn", ["log", "invsqrt"])
def test_trace_oriented_estimates_match_reference(fn):
    """``BIFSolver.trace`` on a matfun state: all four oriented sequences
    equal the reference's at every iteration and bracket the truth."""
    a, us, lmn, lmx = _problem(seed=7)
    iv = dict(lam_min=lmn, lam_max=lmx)
    jt = R.BIFSolver.create(max_iters=40, fn=fn, reorth=True).trace(
        R.Dense(jnp.asarray(a)), jnp.asarray(us[0]), 16, **iv)
    tt = T.BIFSolver.create(max_iters=40, fn=fn, reorth=True).trace(
        T.Dense(_t(a)), _t(us[0]), 16, **iv)
    for f in ("gauss", "radau_lower", "radau_upper", "lobatto"):
        _close(getattr(tt, f).numpy(), getattr(jt, f), 1e-12, f)
    truth = float(_truth(a, us[:1], fn)[0])
    _contains(tt.radau_lower.numpy(), tt.radau_upper.numpy(), truth, 1e-8)
    _contains(tt.gauss.numpy(), tt.lobatto.numpy(), truth, 1e-8)


def test_registry_orientation_table():
    """The port's registry is the reference's: names, indices, derivative
    signs, orientation, and the same errors for unknown tags."""
    assert tuple(tmf.REGISTRY) == tuple(rmf.REGISTRY)
    for name, f in tmf.REGISTRY.items():
        g = rmf.REGISTRY[name]
        assert (f.index, f.s_even, f.s_odd, f.guaranteed,
                f.gauss_is_lower) == (g.index, g.s_even, g.s_odd,
                                      g.guaranteed, g.gauss_is_lower)
        assert tmf.fn_name(f.index) == name
    assert tmf._GAUSS_IS_LOWER == rmf._GAUSS_IS_LOWER
    assert tmf.REGISTRY["inv"].gauss_is_lower
    assert not tmf.REGISTRY["log"].gauss_is_lower
    x = np.array([0.0, 1e-40, 0.5, 2.0])
    for name, f in tmf.REGISTRY.items():
        np.testing.assert_allclose(
            f.apply(_t(x)).numpy(),
            np.asarray(rmf.REGISTRY[name].apply(jnp.asarray(x))),
            rtol=1e-15, err_msg=name)
    with pytest.raises(ValueError, match="fn must be one of"):
        tmf.fn_index("exp")
    with pytest.raises(ValueError, match="fn must be one of"):
        T.BIFSolver.create(fn="nope")
    with pytest.raises(ValueError, match="precondition"):
        T.BIFSolver.create(fn="log", precondition="jacobi")
    # every registry fn is accepted now
    for name in FNS:
        T.SolverConfig(fn=name)


def test_log_gain_bounds_match_reference():
    t = np.array([2.0, 1.0, 3.0])
    lo = np.array([0.5, 0.9, 1.0])
    hi = np.array([1.5, 1.2, 2.0])
    got = tmf.log_gain_bounds(_t(t), _t(lo), _t(hi))
    want = rmf.log_gain_bounds(jnp.asarray(t), jnp.asarray(lo),
                               jnp.asarray(hi))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15)


# ---------------------------------------------------------------------------
# the resumable runtime on matfun states


@pytest.mark.parametrize("kind", OP_KINDS)
def test_interrupted_resume_matches_uninterrupted(kind):
    a, us, lmn, lmx = _problem(seed=5)
    iv = dict(lam_min=0.5 * lmn, lam_max=2.5 * lmx)
    _, top = _ops(kind, a)
    s = T.BIFSolver.create(max_iters=30, rtol=1e-6, fn="log")
    ref = s.solve(top, _t(us), **iv)
    state = s.init_state(top, _t(us), **iv)
    for k in (1, 2, 5):
        state = s.step_n(state, k)
    got = s.finalize(s.resume(state))
    for f in ("iterations", "certified", "lower", "upper", "gauss_lower",
              "lobatto_upper"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(got.state.coeffs.alphas, ref.state.coeffs.alphas)
    assert torch.equal(got.state.coeffs.fnidx, ref.state.coeffs.fnidx)
    # and the same run on the JAX package
    jop, _ = _ops(kind, a)
    jr = R.BIFSolver.create(max_iters=30, rtol=1e-6, fn="log").solve(
        jop, jnp.asarray(us), **iv)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(jr.iterations))
    _close(got.lower.numpy(), jr.lower, 1e-12, "lower")
    _close(got.state.coeffs.alphas.numpy(), jr.state.coeffs.alphas, 1e-12,
           "alphas")


def test_chunked_rounds_and_it_cap():
    a, us, lmn, lmx = _problem(seed=11, kappa=400.0)
    iv = dict(lam_min=lmn, lam_max=lmx)
    op = T.sparse_from_dense(a, device="cpu")
    s = T.BIFSolver.create(max_iters=30, rtol=1e-8, fn="invsqrt")
    ref = s.resume(s.init_state(op, _t(us), **iv))
    chk = s.resume_chunked(s.init_state(op, _t(us), **iv), chunk_iters=4)
    assert torch.equal(ref.lower, chk.lower)
    assert torch.equal(ref.it, chk.it)
    cap = torch.tensor([3, 5, 30, 1], dtype=torch.int32)
    part = s.resume(s.init_state(op, _t(us), **iv), it_cap=cap)
    assert bool(torch.all(part.it <= cap))
    assert torch.equal(s.resume(part).lower, ref.lower)
    # the cadence-3 drive reaches the same certification as the reference
    s3 = T.BIFSolver.create(max_iters=30, rtol=1e-8, fn="invsqrt",
                            decide_every=3)
    j3 = R.BIFSolver.create(max_iters=30, rtol=1e-8, fn="invsqrt",
                            decide_every=3).solve_batch(
        R.sparse_from_dense(a), jnp.asarray(us), **iv)
    t3 = s3.solve_batch(op, _t(us), **iv)
    np.testing.assert_array_equal(t3.iterations.numpy(),
                                  np.asarray(j3.iterations))
    _close(t3.upper.numpy(), j3.upper, 1e-12, "cadence 3 upper")


def test_undersized_coeff_rows_freezes_soundly():
    """A coefficient history smaller than max_iters acts as a budget: the
    lane freezes at the buffer's capacity with a sound bracket, and
    finalizes uncertified, as in the reference."""
    a, us, lmn, lmx = _problem(seed=17)
    iv = dict(lam_min=lmn, lam_max=lmx)
    truth = float(_truth(a, us[:1], "log")[0])
    s = T.BIFSolver.create(max_iters=40, rtol=1e-10, fn="log")
    st = s.resume(s.init_state(T.Dense(_t(a)), _t(us[0]), coeff_rows=4,
                               **iv))
    assert int(st.it) == 4
    res = s.finalize(st)
    assert float(res.lower) <= truth <= float(res.upper)
    assert not bool(res.certified)
    js = R.BIFSolver.create(max_iters=40, rtol=1e-10, fn="log")
    jst = js.resume(js.init_state(R.Dense(jnp.asarray(a)),
                                  jnp.asarray(us[0]), coeff_rows=4, **iv))
    _close(res.lower.numpy(), js.finalize(jst).lower, 1e-12, "lower")
    _close(res.upper.numpy(), js.finalize(jst).upper, 1e-12, "upper")


def test_fn_inv_is_unchanged_and_untracked():
    a, us, lmn, lmx = _problem(seed=9)
    iv = dict(lam_min=lmn, lam_max=lmx)
    op = T.sparse_from_dense(a, device="cpu")
    r0 = T.BIFSolver.create(max_iters=30, rtol=1e-8).solve(op, _t(us), **iv)
    r1 = T.BIFSolver.create(max_iters=30, rtol=1e-8, fn="inv").solve(
        op, _t(us), **iv)
    assert r1.state.coeffs is None
    assert isinstance(r1.state.st, T.gql.GQLState)
    for f in ("iterations", "certified", "lower", "upper", "gauss_lower",
              "lobatto_upper"):
        assert torch.equal(getattr(r0, f), getattr(r1, f)), f
    jr = R.BIFSolver.create(max_iters=30, rtol=1e-8, fn="inv").solve(
        R.sparse_from_dense(a), jnp.asarray(us), **iv)
    np.testing.assert_array_equal(r1.iterations.numpy(),
                                  np.asarray(jr.iterations))
    _close(r1.lower.numpy(), jr.lower, 1e-12, "lower")


def test_eigensolve_route_reproduces_inv_recurrence():
    """The registry's inv entry, evaluated through the eigensolve on a
    tracked history, reproduces the recurrence's Radau bracket."""
    a, us, lmn, lmx = _problem(seed=13)
    iv = dict(lam_min=lmn, lam_max=lmx)
    op = T.Dense(_t(a))
    tracked = T.BIFSolver.create(max_iters=12, fn="log")
    legacy = T.BIFSolver.create(max_iters=12)
    st_t = tracked.init_state(op, _t(us[:3]), **iv)
    st_l = legacy.init_state(op, _t(us[:3]), **iv)

    def never(lo, hi):
        return torch.zeros(lo.shape, dtype=torch.bool)

    for _ in range(8):
        st_t = tracked.step_n(st_t, 1, never)
        st_l = legacy.step_n(st_l, 1, never)
        as_inv = dataclasses.replace(
            st_t.coeffs, fnidx=torch.zeros_like(st_t.coeffs.fnidx))
        lo, hi, _, _ = tmf.bracket(as_inv, st_t.st, st_t.lam_min,
                                   st_t.lam_max)
        np.testing.assert_allclose(lo.numpy(), st_l.lower.numpy(),
                                   rtol=1e-9)
        np.testing.assert_allclose(hi.numpy(), st_l.upper.numpy(),
                                   rtol=1e-9)


def test_mixed_fn_lanes_match_single_fn_runs():
    """A per-lane fn index array: one stacked eigensolve, each lane's own
    f, equal to the reference's mixed-lane estimates."""
    a, us, lmn, lmx = _problem(seed=19)
    idx = np.array([1, 2, 3, 0])
    jst = R.gql.gql_init(R.Dense(jnp.asarray(a)), jnp.asarray(us), lmn, lmx)
    tst = T.gql.gql_init(T.Dense(_t(a)), _t(us), lmn, lmx)
    jc = rmf.init_coeffs(jst, jnp.asarray(idx), 8)
    tc = tmf.init_coeffs(tst, _t(idx), 8)
    for _ in range(5):
        jn = R.gql.gql_step(R.Dense(jnp.asarray(a)), jst, lmn, lmx)
        tn = T.gql.gql_step(T.Dense(_t(a)), tst, lmn, lmx)
        jc, tc = rmf.update_coeffs(jc, jst, jn), tmf.update_coeffs(tc, tst,
                                                                   tn)
        jst, tst = jn, tn
    _close(tc.alphas.numpy(), jc.alphas, 1e-12, "alphas")
    got = tmf.estimates(tc, tst, lmn, lmx).numpy()
    _close(got, rmf.estimates(jc, jst, lmn, lmx), 1e-12, "mixed estimates")
    for lane, f in enumerate(idx):
        one = dataclasses.replace(tc, fnidx=torch.full_like(tc.fnidx, f))
        np.testing.assert_array_equal(
            tmf.estimates(one, tst, lmn, lmx).numpy()[lane], got[lane])


def test_coeff_state_from_numpy_resumes_to_reference():
    """A JAX QuadState carrying a coefficient history, taken as numpy
    arrays, resumes in the port to the JAX result."""
    a, us, lmn, lmx = _problem(seed=23)
    iv = dict(lam_min=lmn, lam_max=lmx)
    js = R.BIFSolver.create(max_iters=30, rtol=1e-7, fn="log")
    jop = R.sparse_from_dense(a)
    mid = js.step_n(js.init_state(jop, jnp.asarray(us), **iv), 4)
    want = js.finalize(js.resume(mid))
    fields = _np_fields(mid)
    fields["op"] = ("coo", {k: np.asarray(getattr(jop, k)) for k in
                            ("rows", "cols", "vals", "diag_vals")}
                    | {"n_static": jop.n_static})
    state = convert.state_from_numpy(fields, device="cpu")
    assert isinstance(state.coeffs, tmf.CoeffHistory)
    ts = T.BIFSolver.create(max_iters=30, rtol=1e-7, fn="log")
    got = ts.finalize(ts.resume(state))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.certified.numpy(),
                                  np.asarray(want.certified))
    _close(got.lower.numpy(), want.lower, 1e-12, "lower")
    _close(got.upper.numpy(), want.upper, 1e-12, "upper")
