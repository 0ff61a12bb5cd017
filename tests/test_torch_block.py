"""The port's block-Krylov quadrature (``repro_torch.core.block``,
``operators.matvec_mrhs`` and the solver's ``block_size > 1`` path)
against the JAX package on the same seeded numpy inputs, in f64.

Tolerances: discrete outcomes (iterations, certification, ``live``,
``done``) exactly equal; states and brackets within 1e-12 relative on the
f64 paths, and brackets within 1e-5 where the blocked-ELL SpMM runs the
K5 kernel's f32 contract (``backend='pallas'``: the reference in Pallas
interpret mode, the port on the kernel's plain version); brackets
contain the dense-eigh truth ``tr B^T f(A) B`` (slack 1e-7 relative,
1e-5 on the f32 path), and the matrix-valued rules are Loewner-ordered
around it. Inside the port, b = 1 reproduces the scalar recurrence's
coefficients bit for bit and the resume invariant holds bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import block as rblk  # noqa: E402
from repro.core import operators as rops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import block as tblk  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from conftest import make_spd  # noqa: E402

OP_KINDS = ["dense", "bell", "coo", "masked", "shifted", "jacobi"]
FNS = {"inv": lambda w: 1.0 / w, "log": np.log}


def _t(x):
    return torch.as_tensor(np.array(x))


def _ops(kind, a, seed=5):
    """(jax op, port op, dense equivalent) for one operator kind."""
    n = a.shape[0]
    if kind == "dense":
        return R.Dense(jnp.asarray(a)), T.Dense(_t(a)), a
    if kind == "bell":
        return (R.bell_from_dense(a, bs=8),
                T.bell_from_dense(a, bs=8, device="cpu"), a)
    if kind == "coo":
        return R.sparse_from_dense(a), T.sparse_from_dense(a, device="cpu"), a
    if kind == "masked":
        m = (np.random.default_rng(seed).random(n) < 0.6).astype(np.float64)
        eq = a * np.outer(m, m) + np.diag(1.0 - m)
        return (R.Masked(R.Dense(jnp.asarray(a)), jnp.asarray(m)),
                T.Masked(T.Dense(_t(a)), _t(m)), eq)
    if kind == "shifted":
        return (R.Shifted(R.Dense(jnp.asarray(a)), jnp.asarray(0.75)),
                T.Shifted(T.Dense(_t(a)), _t(0.75)), a + 0.75 * np.eye(n))
    if kind == "jacobi":
        c = 1.0 / np.sqrt(np.diag(a))
        return (R.Jacobi.create(R.Dense(jnp.asarray(a))),
                T.Jacobi.create(T.Dense(_t(a))), a * np.outer(c, c))
    raise AssertionError(kind)


def _oracle(eq, u, fn):
    """B^T f(A) B by dense eigendecomposition (numpy)."""
    w, v = np.linalg.eigh(eq)
    g = np.asarray(u) @ v
    return (g * FNS[fn](w)) @ np.swapaxes(g, -1, -2), float(w[0]), \
        float(w[-1])


def _close(got, want, rtol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0),
                               err_msg=what)


def _fields(st):
    return [f.name for f in dataclasses.fields(st)]


def _compare_states(tst, jst, rtol, what):
    """Discrete fields exactly; float fields within ``rtol``, or not at
    all (None): on the f32 path the pivot blocks amplify the two
    SpMMs' different f32 rounding orders, so there only the brackets
    are held to 1e-5."""
    for name in _fields(tst):
        g, w = getattr(tst, name), np.asarray(getattr(jst, name))
        if np.issubdtype(w.dtype, np.floating):
            if rtol is not None:
                _close(g, w, rtol, f"{what}.{name}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, f"{what}.{name}")


# ---------------------------------------------------------------------------
# block_init / block_step histories and brackets against the reference


# 'pallas' changes only the blocked-ELL SpMM (K5)
CHAIN_CASES = [(k, "reference") for k in OP_KINDS] + [("bell", "pallas")]


@pytest.mark.parametrize("fn", ["inv", "log"])
@pytest.mark.parametrize("kind,backend", CHAIN_CASES)
def test_block_chain_matches_reference_and_brackets_truth(kind, fn,
                                                          backend):
    rng = np.random.default_rng(5)
    n, b, iters = 33, 3, 6
    a = make_spd(n, kappa=50.0, seed=5, density=0.4)
    jop, top, eq = _ops(kind, a)
    if backend == "pallas":
        jop, top = jop.configured("pallas", True), top.configured("pallas",
                                                                  None)
    u = rng.standard_normal((2, b, n))
    oracle, lmn, lmx = _oracle(eq, u, fn)
    lmn, lmx = lmn * 0.99, lmx * 1.01
    tr_true = np.trace(oracle, axis1=-2, axis2=-1)
    scale = np.maximum(np.abs(tr_true), 1.0)
    f32 = backend == "pallas"
    rtol, slack = (1e-5, 1e-5) if f32 else (1e-12, 1e-7)

    jst = rblk.block_init(jop, jnp.asarray(u), lmn, lmx, fn, iters)
    tst = tblk.block_init(top, _t(u), lmn, lmx, fn, iters)
    for i in range(iters):
        if i:
            jst = rblk.block_step(jop, jst, lmn, lmx)
            tst = tblk.block_step(top, tst, lmn, lmx)
        _compare_states(tst, jst, None if f32 else rtol,
                        f"iteration {i + 1}")
        got = [x.numpy() for x in tblk.bracket(tst, lmn, lmx)]
        want = rblk.bracket(jst, lmn, lmx)
        for g, w, name in zip(got, want, ("lo", "hi", "loose_lo",
                                          "loose_hi")):
            _close(g, w, rtol, f"iteration {i + 1} {name}")
        lo, hi, loose_lo, loose_hi = got
        assert np.all(loose_lo - slack * scale <= lo)
        assert np.all(lo <= tr_true + slack * scale)
        assert np.all(tr_true - slack * scale <= hi)
        assert np.all(hi <= loose_hi + slack * scale)
        mats = tblk.bracket_matrices(tst, lmn, lmx).numpy()
        # the reference's bracket_matrices takes one lane at a time (its
        # fn select does not broadcast over lanes, ROADMAP.md Queue 3)
        for lane in range(u.shape[0]):
            one = jax.tree.map(lambda x: x[lane], jst)
            _close(mats[lane], rblk.bracket_matrices(one, lmn, lmx), rtol,
                   f"iteration {i + 1} matrices, lane {lane}")
        # Loewner order of the oriented Radau rules around the oracle
        gl = fn == "inv"
        lower_m, upper_m = (mats[:, 2], mats[:, 1]) if gl else \
            (mats[:, 1], mats[:, 2])
        assert np.linalg.eigvalsh(oracle - lower_m).min() >= -1e-5 * \
            scale.max()
        assert np.linalg.eigvalsh(upper_m - oracle).min() >= -1e-5 * \
            scale.max()
    assert np.all(hi - lo <= 0.3 * scale)


@pytest.mark.parametrize("kind", ["bell_stacked", "bell_stacked_pallas",
                                  "coo_stacked", "masked_stacked",
                                  "shifted_stacked", "jacobi_stacked",
                                  "matvecfn"])
def test_matvec_mrhs_matches_rowwise_and_reference(kind):
    """``matvec_mrhs`` on lane-stacked operators equals the row-by-row
    matvec, and the reference where the reference runs."""
    rng = np.random.default_rng(2)
    n, lanes, b = 20, 3, 4
    mats = [make_spd(n, kappa=20.0, seed=s, density=0.5) for s in range(3)]
    x = rng.standard_normal((lanes, b, n))
    if kind.startswith("bell"):
        jop = R.stack_ops([R.bell_from_dense(m, bs=8) for m in mats])
        top = T.stack_ops([T.bell_from_dense(m, bs=8, device="cpu")
                           for m in mats])
        if kind.endswith("pallas"):
            jop, top = jop.configured("pallas", True), \
                top.configured("pallas", None)
    elif kind == "coo_stacked":
        jop = R.stack_ops([R.sparse_from_dense(m, nnz=n * n)
                           for m in mats])
        top = T.stack_ops([T.sparse_from_dense(m, nnz=n * n, device="cpu")
                           for m in mats])
    elif kind == "masked_stacked":
        m = (rng.random((lanes, n)) < 0.6).astype(np.float64)
        jop = R.stack_masks(R.Dense(jnp.asarray(mats[0])), jnp.asarray(m))
        top = T.stack_masks(T.Dense(_t(mats[0])), _t(m))
    elif kind == "shifted_stacked":
        sig = np.array([0.1, 0.5, 2.0])
        jop = R.Shifted(R.stack_ops([R.Dense(jnp.asarray(m)) for m in mats]),
                        jnp.asarray(sig))
        top = T.Shifted(T.stack_ops([T.Dense(_t(m)) for m in mats]),
                        _t(sig))
    elif kind == "jacobi_stacked":
        jop = R.Jacobi.create(R.stack_ops([R.Dense(jnp.asarray(m))
                                           for m in mats]))
        top = T.Jacobi.create(T.stack_ops([T.Dense(_t(m)) for m in mats]))
    else:
        a = _t(mats[0])
        top = T.MatvecFn(lambda v: v @ a.T, n, torch.diagonal(a))
        jop = None
    got = tops.matvec_mrhs(top, _t(x))
    rows = torch.stack([top.matvec(_t(x[:, j])) for j in range(b)], dim=1)
    f32 = kind.endswith("pallas")
    rtol = 1e-5 if f32 else 1e-12
    _close(got, rows.numpy(), rtol, "row by row")
    # the reference's lane-stacked BELL gather on its 'reference' mode
    # fails to reshape (ROADMAP.md Queue 3); its Pallas mode runs
    if jop is not None and kind != "bell_stacked":
        _close(got, rops.matvec_mrhs(jop, jnp.asarray(x)), rtol,
               "reference")


# ---------------------------------------------------------------------------
# b = 1 against the port's own scalar path


def test_b1_coefficients_bit_exact_with_scalar_recurrence():
    n, iters = 24, 10
    a = make_spd(n, kappa=80.0, seed=3)
    op = T.sparse_from_dense(a, device="cpu")
    w = np.linalg.eigvalsh(a)
    lmn, lmx = float(w[0] * 0.99), float(w[-1] * 1.01)
    u = _t(np.random.default_rng(3).standard_normal(n))
    sst = T.gql.gql_init(op, u, lmn, lmx)
    s_alpha, s_beta = [sst.lz.alpha], [sst.lz.beta]
    for _ in range(iters - 1):
        sst = T.gql.gql_step(op, sst, lmn, lmx)
        s_alpha.append(sst.lz.alpha)
        s_beta.append(sst.lz.beta)
    bst = tblk.block_init(op, u[None, :], lmn, lmx, "inv", iters)
    for _ in range(iters - 1):
        bst = tblk.block_step(op, bst, lmn, lmx)
    assert torch.equal(bst.a_hist[:iters, 0, 0], torch.stack(s_alpha))
    assert torch.equal(bst.b_hist[:iters, 0, 0], torch.stack(s_beta))


@pytest.mark.parametrize("fn", ["inv", "log"])
def test_b1_bracket_matches_scalar_driver(fn):
    n = 24
    a = make_spd(n, kappa=80.0, seed=4)
    op = T.sparse_from_dense(a, device="cpu")
    w = np.linalg.eigvalsh(a)
    lmn, lmx = float(w[0] * 0.99), float(w[-1] * 1.01)
    u = _t(np.random.default_rng(4).standard_normal(n))
    solver = T.BIFSolver(T.SolverConfig(max_iters=8, fn=fn, rtol=0.0,
                                        atol=0.0))
    state = solver.init_state(op, u, lam_min=lmn, lam_max=lmx)
    bst = tblk.block_init(op, u[None, :], lmn, lmx, fn, 8)
    for i in range(8):
        if i:
            bst = tblk.block_step(op, bst, lmn, lmx)
        lo_b, hi_b, _, _ = tblk.bracket(bst, lmn, lmx)
        lo_s, hi_s = state.bracket()
        np.testing.assert_allclose(float(lo_b), float(lo_s), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(float(hi_b), float(hi_s), rtol=1e-10,
                                   atol=1e-12)
        state = solver.step_n(state, 1)


def test_block_size_one_config_routes_to_scalar_path():
    n = 24
    a = make_spd(n, kappa=50.0, seed=6)
    w = np.linalg.eigvalsh(a)
    u = _t(np.random.default_rng(6).standard_normal((3, n)))
    kw = dict(lam_min=float(w[0]), lam_max=float(w[-1]))
    r1 = T.BIFSolver(T.SolverConfig(max_iters=12)).solve_batch(
        T.Dense(_t(a)), u, **kw)
    r2 = T.BIFSolver(T.SolverConfig(max_iters=12, block_size=1)).solve_batch(
        T.Dense(_t(a)), u, **kw)
    assert isinstance(r2.state.st, T.gql.GQLState)
    assert torch.equal(r1.lower, r2.lower) and torch.equal(r1.upper,
                                                           r2.upper)


# ---------------------------------------------------------------------------
# deflation


@pytest.mark.parametrize("fn", ["inv", "log"])
def test_rank_deficient_start_block_deflates_not_nans(fn):
    n, iters = 24, 8
    a = make_spd(n, kappa=50.0, seed=7)
    w, v = np.linalg.eigh(a)
    lmn, lmx = float(w[0] * 0.99), float(w[-1] * 1.01)
    z = np.random.default_rng(7).standard_normal(n)
    u = np.stack([z, z, np.zeros(n)])            # rank 1 of b = 3
    c = z @ v
    truth = float(np.sum(c * c * FNS[fn](w)))
    top, jop = T.Dense(_t(a)), R.Dense(jnp.asarray(a))
    tst = tblk.block_init(top, _t(u), lmn, lmx, fn, iters)
    jst = rblk.block_init(jop, jnp.asarray(u), lmn, lmx, fn, iters)
    assert int(tst.live.sum()) <= 1
    np.testing.assert_array_equal(tst.live.numpy(), np.asarray(jst.live))
    for _ in range(iters - 1):
        tst = tblk.block_step(top, tst, lmn, lmx)
        jst = rblk.block_step(jop, jst, lmn, lmx)
        assert np.all(np.isfinite(tblk.estimates(tst, lmn, lmx).numpy()))
        np.testing.assert_array_equal(tst.live.numpy(), np.asarray(jst.live))
        np.testing.assert_array_equal(tst.done.numpy(), np.asarray(jst.done))
    lo, hi, _, _ = (float(x) for x in tblk.bracket(tst, lmn, lmx))
    jlo, jhi, _, _ = rblk.bracket(jst, lmn, lmx)
    np.testing.assert_allclose([lo, hi], [float(jlo), float(jhi)],
                               rtol=1e-12)
    scale = max(abs(truth), 1.0)
    assert lo - 1e-6 * scale <= 2 * truth <= hi + 1e-6 * scale
    assert hi - lo <= 5e-2 * scale


def test_block_qr_matches_reference_on_deficient_input():
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2, 4, 12))
    z[0, 2] = z[0, 0] + 1e-15 * z[0, 1]   # (nearly) dependent slot
    z[1, 3] = 0.0                         # zero slot
    live = np.array([[True, True, True, True], [True, False, True, True]])
    tq, tr, tl = tblk.block_qr(_t(z), _t(live), 1e-10)
    jq, jr, jl = rblk.block_qr(jnp.asarray(z), jnp.asarray(live), 1e-10)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(tq, jq, 1e-12, "q")
    _close(tr, jr, 1e-12, "r")
    assert not bool(tl[0, 2]) and not bool(tl[1, 3]) and not bool(tl[1, 1])


def test_all_zero_block_is_done_at_init():
    n = 16
    op = T.Dense(_t(make_spd(n, kappa=10.0, seed=8)))
    st = tblk.block_init(op, torch.zeros(2, 4, n, dtype=torch.float64), 0.1,
                         2.0, "inv", 4)
    assert bool(torch.all(st.done)) and not bool(torch.any(st.live))
    lo, hi, _, _ = tblk.bracket(st, 0.1, 2.0)
    assert torch.equal(lo, torch.zeros(2, dtype=torch.float64))
    assert torch.equal(hi, torch.zeros(2, dtype=torch.float64))


# ---------------------------------------------------------------------------
# the solver on block states


def test_solver_block_resume_invariant_bit_exact():
    n, k, b = 32, 3, 4
    a = make_spd(n, kappa=50.0, seed=9)
    op = T.sparse_from_dense(a, device="cpu")
    w = np.linalg.eigvalsh(a)
    u = _t(np.random.default_rng(9).standard_normal((k, b, n)))
    solver = T.BIFSolver(T.SolverConfig(max_iters=10, block_size=b))
    kw = dict(lam_min=float(w[0]), lam_max=float(w[-1]))
    s0 = solver.init_state(op, u, **kw)
    full = solver.resume(solver.init_state(op, u, **kw))
    for steps in (1, 3):
        paused = solver.resume(solver.step_n(s0, steps))
        for name in _fields(full.st):
            assert torch.equal(getattr(full.st, name),
                               getattr(paused.st, name)), (steps, name)


@pytest.mark.parametrize("kind,backend,decide_every",
                         [("dense", "reference", 1), ("dense", "fused", 2),
                          ("bell", "pallas", 1), ("bell", "reference", 3),
                          ("coo", "pallas", 1)])
def test_solver_block_matches_reference(kind, backend, decide_every):
    n, k, b = 32, 3, 4
    a = make_spd(n, kappa=50.0, seed=10)
    jop, top, _ = _ops(kind, a)
    w, v = np.linalg.eigh(a)
    us = np.random.default_rng(10).standard_normal((k, b, n))
    truth = np.array([np.trace((us[i] @ v * (1.0 / w)) @ (us[i] @ v).T)
                      for i in range(k)])
    kw = dict(max_iters=16, block_size=b, backend=backend,
              decide_every=decide_every)
    # outer estimates, as the contract asks: a Radau node ON an
    # eigenvalue makes its pivot singular and amplifies rounding
    iv = dict(lam_min=float(w[0] * 0.99), lam_max=float(w[-1] * 1.01))
    tr = T.BIFSolver.create(**kw).solve_batch(top, _t(us), **iv)
    jr = R.BIFSolver.create(pallas_interpret=True, **kw).solve_batch(
        jop, jnp.asarray(us), **iv)
    f32 = (kind, backend) == ("bell", "pallas")
    rtol = 1e-5 if f32 else 1e-12
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.certified.numpy(),
                                  np.asarray(jr.certified))
    for f in ("lower", "upper", "gauss_lower", "lobatto_upper"):
        _close(getattr(tr, f), getattr(jr, f), rtol, f)
    scale = np.maximum(np.abs(truth), 1.0)
    slack = 1e-5 if f32 else 1e-7
    assert np.all(tr.lower.numpy() <= truth + slack * scale)
    assert np.all(tr.upper.numpy() >= truth - slack * scale)
    assert bool(torch.all(tr.certified))


def test_block_config_guards():
    with pytest.raises(ValueError):
        T.SolverConfig(block_size=0)
    with pytest.raises(NotImplementedError, match="reorth"):
        T.SolverConfig(block_size=2, reorth=True)
    with pytest.raises(NotImplementedError, match="precondition"):
        T.SolverConfig(block_size=2, precondition="jacobi")
    T.SolverConfig(block_size=4, fn="log")      # no longer raises
    solver = T.BIFSolver(T.SolverConfig(max_iters=4, block_size=4))
    op = T.Dense(_t(make_spd(16, seed=0)))
    with pytest.raises(ValueError, match="block_size=4 wants"):
        solver.init_state(op, torch.ones(2, 16, dtype=torch.float64),
                          lam_min=0.1, lam_max=2.0)
    with pytest.raises(ValueError, match="stacked probe blocks"):
        solver.solve_batch(op, torch.ones(4, 16, dtype=torch.float64),
                           lam_min=0.1, lam_max=2.0)


def test_block_union_interval_for_estimated_spectra():
    """An estimating spectrum mode gives per-probe bounds; the block lane
    takes their union, as the reference does."""
    n, b = 24, 3
    a = make_spd(n, kappa=30.0, seed=12)
    us = np.random.default_rng(12).standard_normal((2, b, n))
    kw = dict(max_iters=12, block_size=b, spectrum="lanczos",
              spectrum_iters=8)
    ts = T.BIFSolver.create(**kw).init_state(T.Dense(_t(a)), _t(us))
    js = R.BIFSolver.create(**kw).init_state(R.Dense(jnp.asarray(a)),
                                             jnp.asarray(us))
    assert tuple(ts.lam_min.shape) == (2,)
    _close(ts.lam_min, js.lam_min, 1e-12, "lam_min")
    _close(ts.lam_max, js.lam_max, 1e-12, "lam_max")


def test_block_state_from_numpy_resumes_to_reference():
    n, k, b = 28, 2, 3
    a = make_spd(n, kappa=40.0, seed=14)
    w = np.linalg.eigvalsh(a)
    us = np.random.default_rng(14).standard_normal((k, b, n))
    iv = dict(lam_min=float(w[0] * 0.99), lam_max=float(w[-1] * 1.01))
    js = R.BIFSolver.create(max_iters=14, rtol=1e-8, block_size=b, fn="log")
    mid = js.step_n(js.init_state(R.Dense(jnp.asarray(a)), jnp.asarray(us),
                                  **iv), 3)
    want = js.finalize(js.resume(mid))
    st = convert.state_from_numpy(
        {f: np.asarray(getattr(mid.st, f)) for f in _fields(mid.st)},
        device="cpu")
    assert isinstance(st, tblk.BlockState)
    state = convert.state_from_numpy(
        {"op": ("dense", {"a": a}), "st": st,
         "lam_min": np.asarray(mid.lam_min),
         "lam_max": np.asarray(mid.lam_max), "basis": None,
         "step": np.asarray(mid.step), "coeffs": None}, device="cpu")
    ts = T.BIFSolver.create(max_iters=14, rtol=1e-8, block_size=b, fn="log")
    got = ts.finalize(ts.resume(state))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.certified.numpy(),
                                  np.asarray(want.certified))
    _close(got.lower, want.lower, 1e-12, "lower")
    _close(got.upper, want.upper, 1e-12, "upper")
