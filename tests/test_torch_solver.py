"""The port's solver against the JAX package on the same seeded numpy
inputs (f64): per-step ``gql_step`` parity from identical states, and the
batched entry points for every backend x decision cadence x operator
kind. Discrete outcomes (iterations, certified flags, decisions, argmax
index) must match exactly; brackets to 1e-12 relative (1e-5 where a BELL
matvec runs the K2 kernel's f32 contract); every bracket must contain the
``np.linalg.solve`` truth."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from conftest import make_spd  # noqa: E402

N, K = 36, 4
OP_KINDS = ["dense", "masked", "bell", "coo"]
BACKENDS = ["reference", "pallas", "fused"]


def _t(x):
    return torch.as_tensor(np.array(x))


def _problem(seed=0):
    a = make_spd(N, kappa=120.0, seed=seed, density=0.35)
    w = np.linalg.eigvalsh(a)
    us = np.random.default_rng(seed + 1).standard_normal((K, N))
    return a, us, float(w[0] * 0.5), float(w[-1] * 2.5)


def _ops(kind, a, seed=0):
    """(jax op, port op, mask or None) for one operator kind."""
    if kind == "dense":
        return R.Dense(jnp.asarray(a)), T.Dense(_t(a)), None
    if kind == "masked":
        m = (np.random.default_rng(seed + 7).random((K, N)) < 0.7
             ).astype(np.float64)
        return (R.stack_masks(R.Dense(jnp.asarray(a)), jnp.asarray(m)),
                T.stack_masks(T.Dense(_t(a)), _t(m)), m)
    if kind == "bell":
        return (R.bell_from_dense(a, bs=8),
                T.bell_from_dense(a, bs=8, device="cpu"), None)
    if kind == "coo":
        return (R.sparse_from_dense(a),
                T.sparse_from_dense(a, device="cpu"), None)
    raise AssertionError(kind)


def _truth(a, us, mask=None):
    out = []
    for k, u in enumerate(us):
        if mask is None:
            out.append(u @ np.linalg.solve(a, u))
        else:
            idx = np.nonzero(mask[k])[0]
            uy = u[idx]
            out.append(uy @ np.linalg.solve(a[np.ix_(idx, idx)], uy))
    return np.asarray(out)


def _rtol(kind, backend):
    # BELL on backend='pallas' runs the K2 matvec: f32 accumulation
    return 1e-5 if (kind == "bell" and backend == "pallas") else 1e-12


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=what)


def _contains(lo, hi, truth, slack=1e-9):
    tol = slack * np.abs(truth)
    assert np.all(np.asarray(lo) <= truth + tol), (lo, truth)
    assert np.all(np.asarray(hi) >= truth - tol), (hi, truth)


# ---------------------------------------------------------------------------
# per-step parity from identical states


def _state_dict(st):
    return {f: (_state_dict(v) if hasattr(v, "_fields") else np.asarray(v))
            for f, v in zip(st._fields, st)}


def _leaves(st):
    for f, v in zip(st._fields, st):
        if hasattr(v, "_fields"):
            for g, w in _leaves(v):
                yield f"{f}.{g}", w
        else:
            yield f, v


@pytest.mark.parametrize("kind", OP_KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reorth", [False, True])
def test_gql_step_parity_from_identical_states(kind, backend, reorth):
    a, us, lmn, lmx = _problem(seed=3)
    jop, top, mask = _ops(kind, a, seed=3)
    if mask is not None:
        us = us * mask
    if kind == "bell" and backend == "pallas":
        jop = jop.configured("pallas", True)
        top = top.configured("pallas", None)
    jst = R.gql.gql_init(jop, jnp.asarray(us), lmn, lmx)
    basis = None
    if reorth:
        basis = jnp.stack([jst.lz.v_prev, jst.lz.v]
                          + [jnp.zeros_like(jst.lz.v)] * 6, axis=-2)
    tstep = T.BIFSolver.create(backend=backend)._stepper()
    rec = (None if backend != "pallas" else
           lambda *x: jops.gql_update(*x, interpret=True))
    rtol = _rtol(kind, backend)
    for i in range(5):
        tst = convert.state_from_numpy(_state_dict(jst), device="cpu")
        tb = None if basis is None else _t(basis)
        if backend == "fused":
            jnext = jops.gql_step_fused(jop, jst, lmn, lmx, basis=basis,
                                        interpret=True)
        else:
            jnext = R.gql.gql_step(jop, jst, lmn, lmx, basis=basis,
                                   recurrence=rec)
        tnext = tstep(top, tst, lmn, lmx, tb)
        for (name, g), (_, w) in zip(_leaves(tnext), _leaves(jnext)):
            g, w = g.numpy(), np.asarray(w)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol,
                                           err_msg=f"step {i} {name}")
            else:
                np.testing.assert_array_equal(g, w, f"step {i} {name}")
        jst = jnext
        if reorth:
            basis = basis.at[..., i + 2, :].set(jst.lz.v)


# ---------------------------------------------------------------------------
# the batched entry points, every backend x cadence x operator kind


_JAX_RUNS = {}


def _jax_runs(kind, jbackend, decide_every, jop, us, t, shift, iv):
    """The JAX package's solve_batch / judge_batch / judge_argmax for one
    (operator, backend, cadence), computed once per test module. The JAX
    side runs its jnp reference backend (its own tests pin 'pallas' and
    'fused' to it: identical discrete outcomes, brackets within 1e-12),
    except where the backend changes the arithmetic's contract: BELL on
    'pallas' runs the f32 SpMV, so that case runs the Pallas kernels in
    interpret mode."""
    key = (kind, jbackend, decide_every)
    if key not in _JAX_RUNS:
        js = R.BIFSolver.create(max_iters=30, rtol=1e-6, backend=jbackend,
                                decide_every=decide_every,
                                pallas_interpret=True)
        ju = jnp.asarray(us)
        _JAX_RUNS[key] = (
            js.solve_batch(jop, ju, **iv),
            js.judge_batch(jop, ju, jnp.asarray(t), **iv),
            js.judge_argmax(jop, ju, shift=jnp.asarray(shift), scale=-1.0,
                            **iv))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("kind", OP_KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("decide_every", [1, 4])
def test_entry_points_match_reference(kind, backend, decide_every):
    a, us, lmn, lmx = _problem(seed=11)
    jop, top, mask = _ops(kind, a, seed=11)
    if mask is not None:
        us = us * mask
    truth = _truth(a, us, mask)
    ts = T.BIFSolver.create(max_iters=30, rtol=1e-6, backend=backend,
                            decide_every=decide_every)
    iv = dict(lam_min=lmn, lam_max=lmx)
    rtol = _rtol(kind, backend)
    tu = _t(us)
    t = truth * np.array([0.9, 1.1, 0.97, 1.02])
    shift = np.diagonal(a)[:K] + truth.max()
    jbackend = "pallas" if (kind, backend) == ("bell", "pallas") \
        else "reference"
    jr, jj, ja = _jax_runs(kind, jbackend, decide_every, jop, us, t, shift,
                           iv)

    # solve_batch: the tolerance rule
    tr = ts.solve_batch(top, tu, **iv)
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))
    np.testing.assert_array_equal(tr.certified.numpy(),
                                  np.asarray(jr.certified))
    for f in ("lower", "upper", "gauss_lower", "lobatto_upper"):
        _close(getattr(tr, f).numpy(), getattr(jr, f), rtol, f)
    _contains(tr.lower.numpy(), tr.upper.numpy(), truth,
              slack=1e-9 if rtol < 1e-9 else 1e-5)

    # judge_batch: thresholds on both sides of the truth
    tj = ts.judge_batch(top, tu, _t(t), **iv)
    for f in ("decision", "certified", "iterations"):
        np.testing.assert_array_equal(getattr(tj, f).numpy(),
                                      np.asarray(getattr(jj, f)), f)
    cert = tj.certified.numpy()
    np.testing.assert_array_equal(tj.decision.numpy()[cert],
                                  (t < truth)[cert])

    # judge_argmax: scores shift - bif (greedy-MAP form)
    ta = ts.judge_argmax(top, tu, shift=_t(shift), scale=-1.0, **iv)
    assert int(ta.index) == int(ja.index)
    assert bool(ta.certified) == bool(ja.certified)
    np.testing.assert_array_equal(ta.iterations.numpy(),
                                  np.asarray(ja.iterations))
    _close(ta.lower.numpy(), ja.lower, rtol, "argmax lower")
    _close(ta.upper.numpy(), ja.upper, rtol, "argmax upper")
    if bool(ta.certified):
        assert int(ta.index) == int(np.argmax(shift - truth))


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_lane_solve_and_judge(backend):
    a, us, lmn, lmx = _problem(seed=13)
    truth = _truth(a, us[:1])[0]
    kw = dict(max_iters=30, rtol=1e-8, backend=backend)
    jr = R.BIFSolver.create(pallas_interpret=True, **kw).solve(
        R.Dense(jnp.asarray(a)), jnp.asarray(us[0]), lam_min=lmn,
        lam_max=lmx)
    tr = T.BIFSolver.create(**kw).solve(T.Dense(_t(a)), _t(us[0]),
                                        lam_min=lmn, lam_max=lmx)
    assert int(tr.iterations) == int(jr.iterations)
    _close(tr.lower.numpy(), jr.lower, 1e-12, "lower")
    _close(tr.upper.numpy(), jr.upper, 1e-12, "upper")
    _contains(tr.lower.numpy(), tr.upper.numpy(), np.asarray(truth))
    jt = T.BIFSolver.create(**kw).judge_threshold(
        T.Dense(_t(a)), _t(us[0]), truth * 0.95, lam_min=lmn, lam_max=lmx)
    assert bool(jt.decision) and bool(jt.certified)


# ---------------------------------------------------------------------------
# the resumable runtime


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("decide_every,reorth", [(1, True), (3, False)])
def test_resume_after_step_n_is_bit_exact(backend, decide_every, reorth):
    a, us, lmn, lmx = _problem(seed=17)
    s = T.BIFSolver.create(max_iters=30, rtol=1e-7, backend=backend,
                           decide_every=decide_every, reorth=reorth)
    st0 = s.init_state(T.Dense(_t(a)), _t(us), lam_min=lmn, lam_max=lmx)
    full = s.resume(st0)
    for k in (0, 2, 7):
        part = s.resume(s.step_n(st0, k))
        for (name, g), (_, w) in zip(_leaves(part.st), _leaves(full.st)):
            assert torch.equal(g, w), (k, name)
        assert torch.equal(part.step, full.step)
        if reorth:
            assert torch.equal(part.basis, full.basis)
    chunked = s.resume_chunked(st0, chunk_iters=5)
    for (name, g), (_, w) in zip(_leaves(chunked.st), _leaves(full.st)):
        assert torch.equal(g, w), name


def test_step_n_quantizes_to_rounds():
    a, us, lmn, lmx = _problem(seed=19)
    s = T.BIFSolver.create(max_iters=30, rtol=1e-12, decide_every=4)
    st0 = s.init_state(T.Dense(_t(a)), _t(us), lam_min=lmn, lam_max=lmx)
    assert s.step_n(st0, 3) is st0
    assert int(s.step_n(st0, 9).step) == 8


def test_trace_matches_reference():
    a, us, lmn, lmx = _problem(seed=21)
    jt = R.bounds.bif_bounds_trace(R.Dense(jnp.asarray(a)), jnp.asarray(us),
                                   lmn, lmx, 12, reorth=True)
    tt = T.bounds.bif_bounds_trace(T.Dense(_t(a)), _t(us), lmn, lmx, 12,
                                   reorth=True)
    for f in jt._fields:
        _close(getattr(tt, f).numpy(), getattr(jt, f), 1e-12, f)


@pytest.mark.parametrize("spectrum", ["gershgorin", "lanczos", "ridge"])
def test_estimated_spectrum_and_jacobi_match_reference(spectrum):
    a, us, _, _ = _problem(seed=23)
    # the reference's Gershgorin reads explicit rows, so it takes no
    # Jacobi wrapper
    kw = dict(max_iters=30, rtol=1e-6, spectrum=spectrum, ridge=1e-3,
              precondition="none" if spectrum == "gershgorin" else "jacobi")
    jr = R.BIFSolver.create(**kw).solve_batch(R.Dense(jnp.asarray(a)),
                                              jnp.asarray(us))
    tr = T.BIFSolver.create(**kw).solve_batch(T.Dense(_t(a)), _t(us))
    np.testing.assert_array_equal(tr.iterations.numpy(),
                                  np.asarray(jr.iterations))
    _close(tr.lower.numpy(), jr.lower, 1e-10, "lower")
    _close(tr.upper.numpy(), jr.upper, 1e-10, "upper")
    np.testing.assert_allclose(tr.state.lam_max.numpy(),
                               np.asarray(jr.state.lam_max), rtol=1e-10)


def test_config_validation_matches_reference():
    for bad in (dict(spectrum="x"), dict(precondition="x"),
                dict(backend="cuda"), dict(max_iters=0),
                dict(decide_every=0), dict(fn="nope"), dict(block_size=0),
                dict(fn="log", precondition="jacobi")):
        with pytest.raises(ValueError):
            R.SolverConfig(**bad)
        with pytest.raises(ValueError):
            T.SolverConfig(**bad)
    # matrix functions and block-Krylov mode are ported: both packages
    # take them, and refuse the same block combinations
    for later in (dict(fn="log"), dict(block_size=4),
                  dict(fn="sqrt", block_size=2, decide_every=3)):
        r, t = R.SolverConfig(**later), T.SolverConfig(**later)
        assert all(getattr(r, f) == getattr(t, f)
                   for f in R.SolverConfig.__dataclass_fields__)
    for bad in (dict(block_size=2, reorth=True),
                dict(block_size=2, precondition="jacobi")):
        with pytest.raises(NotImplementedError):
            R.SolverConfig(**bad)
        with pytest.raises(NotImplementedError):
            T.SolverConfig(**bad)
    assert T.SolverConfig() == T.SolverConfig(**{
        f: getattr(R.SolverConfig(), f)
        for f in R.SolverConfig.__dataclass_fields__})


def test_query_on_another_device_raises():
    a, us, lmn, lmx = _problem(seed=25)
    with pytest.raises(ValueError, match="device"):
        T.BIFSolver.create().solve_batch(
            T.Dense(_t(a)), _t(us).to("meta"), lam_min=lmn, lam_max=lmx)


def test_argmax_of_bool_picks_the_first_maximum():
    from repro_torch.core.solver import _first_argmax
    x = torch.tensor([[False, True, True, False], [False] * 4])
    np.testing.assert_array_equal(_first_argmax(x).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(
                                      x.numpy()), axis=-1)))
    assert _first_argmax(x).tolist() == [1, 0]


def test_kernel_backends_launch_nothing_on_cpu():
    """CPU tensors reach the plain versions; the launch counters count
    kernel launches only."""
    a, us, lmn, lmx = _problem(seed=27)
    before = dict(tops.LAUNCHES)
    for backend in ("pallas", "fused"):
        T.BIFSolver.create(max_iters=10, backend=backend).solve_batch(
            T.Dense(_t(a)), _t(us), lam_min=lmn, lam_max=lmx)
    assert tops.LAUNCHES == before


def test_pallas_bell_bracket_within_f32_slack_of_truth():
    """With backend='pallas' a SparseBELL matvec accumulates in f32 (K2's
    contract), so a converged bracket belongs to an f32-perturbed operator
    and can sit outside the f64 truth on an ill-conditioned one (the
    ring-lattice Laplacian with ridge 1e-3). It stays within
    kappa * 2^-24 of it, the slack chip_smoke.py's sparse phase allows;
    the f64 reference backend's bracket holds the truth."""
    from repro_torch.data import graph_laplacian
    n = 512
    lap = graph_laplacian(n, mean_degree=12, rewire=0.0, seed=0)
    bell = T.bell_from_dense(lap, bs=16, dtype=np.float32, device="cpu")
    a32 = lap.astype(np.float32).astype(np.float64)
    w = np.linalg.eigvalsh(a32)
    lmn, lmx = 0.9 * w[0], 1.1 * w[-1]
    us = np.random.default_rng(2).standard_normal((16, n))
    truth = torch.as_tensor(np.einsum("kn,kn->k", us,
                                      np.linalg.solve(a32, us.T).T))
    slack = lmx / lmn * 2.0 ** -24
    for backend, tol in (("reference", 1e-9), ("pallas", slack)):
        res = T.BIFSolver.create(max_iters=400, rtol=1e-3,
                                 backend=backend).solve_batch(
            bell, _t(us), lam_min=lmn, lam_max=lmx)
        assert bool(res.certified.all()), backend
        miss = torch.maximum(res.lower - truth, truth - res.upper) / truth
        assert float(miss.max()) <= tol, (backend, float(miss.max()))


# ---------------------------------------------------------------------------
# the two-system judges (k-DPP swap, double greedy) and their guards


def _pair_problem(seed, n=30):
    a = make_spd(n, kappa=100.0, seed=seed)
    w = np.linalg.eigvalsh(a)
    rng = np.random.default_rng(seed + 7)
    mask = (rng.random(n) < 0.5).astype(np.float64)
    mask[:2] = [1.0, 0.0]
    u = rng.standard_normal(n) * mask
    v = rng.standard_normal(n) * mask
    p = float(rng.uniform(0.05, 0.95))
    t = float(rng.standard_normal() * 0.1)
    x_mask = np.zeros(n)
    x_mask[rng.choice(n, 5, replace=False)] = 1.0
    y_mask = np.ones(n)
    i = int(np.argmax(x_mask == 0))
    x_mask[i], y_mask[i] = 0.0, 0.0
    return a, mask, u, v, p, t, x_mask, y_mask, i, \
        dict(lam_min=float(w[0] * 0.99), lam_max=float(w[-1] * 1.01))


def _same_judge(got, want, what):
    for f in ("decision", "certified", "iterations"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      f"{what}.{f}")


@pytest.mark.parametrize("seed", [0, 4, 9])
@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_two_system_judges_match_reference(seed, backend):
    n = 30
    a, mask, u, v, p, t, x_mask, y_mask, i, iv = _pair_problem(seed, n)
    kw = dict(max_iters=n + 2, backend=backend)
    js = R.BIFSolver.create(pallas_interpret=True, **kw)
    ts = T.BIFSolver.create(**kw)
    jop = R.Masked(R.Dense(jnp.asarray(a)), jnp.asarray(mask))
    top = T.Masked(T.Dense(_t(a)), _t(mask))
    ju, jv, tu, tv = jnp.asarray(u), jnp.asarray(v), _t(u), _t(v)
    _same_judge(ts.judge_kdpp_swap(top, tu, top, tv, t, p, **iv),
                js.judge_kdpp_swap(jop, ju, jop, jv, t, p, **iv), "swap")
    _same_judge(ts.judge_kdpp_swap_batch(top, tu, tv, t, p, **iv),
                js.judge_kdpp_swap_batch(jop, ju, jv, t, p, **iv),
                "swap batch")
    _same_judge(ts.judge_kdpp_swap_batch(top, tu, tv, t, p, chunk_iters=3,
                                         **iv),
                js.judge_kdpp_swap_batch(jop, ju, jv, t, p, chunk_iters=3,
                                         **iv), "swap chunked")
    col = a[:, i]
    jb, tb = R.Dense(jnp.asarray(a)), T.Dense(_t(a))
    _same_judge(
        ts.judge_double_greedy(T.Masked(tb, _t(x_mask)), _t(col * x_mask),
                               T.Masked(tb, _t(y_mask)), _t(col * y_mask),
                               a[i, i], p, **iv),
        js.judge_double_greedy(R.Masked(jb, jnp.asarray(x_mask)),
                               jnp.asarray(col * x_mask),
                               R.Masked(jb, jnp.asarray(y_mask)),
                               jnp.asarray(col * y_mask), a[i, i], p, **iv),
        "double greedy")
    xy = np.stack([x_mask, y_mask])
    uv = np.stack([col * x_mask, col * y_mask])
    _same_judge(
        ts.judge_double_greedy_batch(T.stack_masks(tb, _t(xy)), _t(uv),
                                     a[i, i], p, **iv),
        js.judge_double_greedy_batch(R.stack_masks(jb, jnp.asarray(xy)),
                                     jnp.asarray(uv), a[i, i], p, **iv),
        "double greedy batch")


def test_two_system_judges_refuse_what_the_reference_refuses():
    a, mask, u, v, p, t, _, _, _, iv = _pair_problem(0, 16)
    op = T.Dense(_t(a))
    tu, tv = _t(u), _t(v)
    for kw, match in ((dict(fn="log"), "pair driver"),
                      (dict(decide_every=2), "decide_every=1"),
                      (dict(reorth=True), "reorth"),
                      (dict(block_size=2), "block_size=1")):
        with pytest.raises(NotImplementedError, match=match):
            T.BIFSolver.create(max_iters=10, **kw).judge_kdpp_swap(
                op, tu, op, tv, t, p, **iv)
        with pytest.raises(NotImplementedError, match=match):
            R.BIFSolver.create(max_iters=10, **kw).judge_kdpp_swap(
                R.Dense(jnp.asarray(a)), jnp.asarray(u),
                R.Dense(jnp.asarray(a)), jnp.asarray(v), t, p, **iv)
    blk = T.BIFSolver.create(max_iters=10, block_size=2)
    with pytest.raises(NotImplementedError, match="swap-judge"):
        blk.judge_kdpp_swap_batch(op, tu, tv, t, p, **iv)
    with pytest.raises(NotImplementedError, match="gain-judge"):
        blk.judge_double_greedy_batch(op, torch.stack([tu, tv]), 1.0, p,
                                      **iv)
    # the batched judges take matrix functions, as in the reference
    res = T.BIFSolver.create(max_iters=18, fn="log").judge_kdpp_swap_batch(
        op, tu, tv, t, p, **iv)
    want = R.BIFSolver.create(max_iters=18, fn="log").judge_kdpp_swap_batch(
        R.Dense(jnp.asarray(a)), jnp.asarray(u), jnp.asarray(v), t, p, **iv)
    _same_judge(res, want, "matfun swap batch")


# ---------------------------------------------------------------------------
# the live basis rows: before step s only rows 0 .. min(s + 2, M) - 1 can be
# non-zero, so the fused stepper hands K3 that count and the kernel skips
# the rest


def _record_live_rows(monkeypatch):
    """Wrap the K3 entry point: each call with a basis records the live-row
    count it was given and checks that every lane's basis rows from that
    count on are exactly zero."""
    counts = []
    real = tops.fused_step_dense

    def spy(*args, rows=None, **kw):
        basis = args[7] if len(args) > 7 else kw.get("basis")
        if basis is not None:
            assert rows is not None and rows.dtype == torch.int32
            c = int(rows)
            assert 2 <= c <= basis.shape[-2]
            assert not bool(torch.any(basis[..., c:, :])), \
                f"a basis row at or past {c} is set"
            counts.append(c)
        return real(*args, rows=rows, **kw)

    monkeypatch.setattr(tops, "fused_step_dense", spy)
    return counts


def _live(steps, m, first=0):
    return [min(s + 2, m) for s in range(first, first + steps)]


def _basis_zero_past_live(state):
    m = state.basis.shape[-2]
    c = min(int(state.step) + 2, m)
    assert not bool(torch.any(state.basis[..., c:, :])), (int(state.step), c)


def test_live_rows_through_a_fused_solve_to_its_cap(monkeypatch):
    """solve_batch to its cap: every step's count is min(step + 2, M), the
    rows past it are zero, and the result is the reference backend's;
    then a state with fewer basis rows than steps, whose clamped last row
    is written again and again."""
    a, us, lmn, lmx = _problem(seed=29)
    counts = _record_live_rows(monkeypatch)
    cap = 7
    kw = dict(max_iters=cap, rtol=1e-14, reorth=True)
    iv = dict(lam_min=lmn, lam_max=lmx)
    got = T.BIFSolver.create(backend="fused", **kw).solve_batch(
        T.Dense(_t(a)), _t(us), **iv)
    want = T.BIFSolver.create(backend="reference", **kw).solve_batch(
        T.Dense(_t(a)), _t(us), **iv)
    assert int(got.iterations.max()) == cap
    assert counts == _live(cap - 1, cap + 1)
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.certified, want.certified)
    assert torch.equal(got.converged, want.converged)
    _close(got.lower.numpy(), want.lower.numpy(), 1e-12, "lower")
    _close(got.upper.numpy(), want.upper.numpy(), 1e-12, "upper")
    _contains(got.lower.numpy(), got.upper.numpy(), _truth(a, us))

    counts.clear()
    s = T.BIFSolver.create(backend="fused", **kw)
    st = s.resume(s.init_state(T.Dense(_t(a)), _t(us), basis_rows=4, **iv))
    assert counts == _live(cap - 1, 4) and counts[-3:] == [4, 4, 4]
    _basis_zero_past_live(st)


@pytest.mark.parametrize("decide_every", [1, 3])
def test_live_rows_across_step_n_resume_and_chunks(monkeypatch,
                                                    decide_every):
    """step_n then resume, and resume_chunked: the counts follow the
    global step across every call, and both end where resume does."""
    a, us, lmn, lmx = _problem(seed=31)
    counts = _record_live_rows(monkeypatch)
    s = T.BIFSolver.create(max_iters=30, rtol=1e-8, backend="fused",
                           decide_every=decide_every, reorth=True)
    st0 = s.init_state(T.Dense(_t(a)), _t(us), lam_min=lmn, lam_max=lmx)
    m = st0.basis.shape[-2]
    full = s.resume(st0)
    steps = int(full.step)
    assert counts == _live(steps, m)
    for part in (s.resume(s.step_n(st0, 6)),
                 s.resume_chunked(st0, chunk_iters=4)):
        counts.clear()
        _basis_zero_past_live(part)
        assert torch.equal(part.basis, full.basis)
        assert torch.equal(part.step, full.step)
    mid = s.step_n(st0, 6)
    _basis_zero_past_live(mid)
    counts.clear()
    s.resume(mid)
    assert counts == _live(steps - int(mid.step), m, first=int(mid.step))


def test_live_rows_in_a_fused_trace(monkeypatch):
    """trace() sizes the basis at num_iters + 1 rows: the counts run
    2 .. num_iters, and the four sequences are the reference backend's."""
    a, us, lmn, lmx = _problem(seed=37)
    counts = _record_live_rows(monkeypatch)
    kw = dict(max_iters=30, reorth=True)
    iters = 12
    got = T.BIFSolver.create(backend="fused", **kw).trace(
        T.Dense(_t(a)), _t(us), iters, lam_min=lmn, lam_max=lmx)
    want = T.BIFSolver.create(backend="reference", **kw).trace(
        T.Dense(_t(a)), _t(us), iters, lam_min=lmn, lam_max=lmx)
    assert counts == _live(iters - 1, iters + 1)
    for f in got._fields:
        _close(getattr(got, f).numpy(), getattr(want, f).numpy(), 1e-12, f)


def test_live_rows_of_a_state_from_the_reference(monkeypatch):
    """A reorth state of the JAX package, brought over by
    convert.state_from_numpy, keeps the layout: rows past min(step + 2,
    M) are zero, and the fused resume continues the counts from its step
    to the JAX result."""
    a, us, lmn, lmx = _problem(seed=41)
    iv = dict(lam_min=lmn, lam_max=lmx)
    kw = dict(max_iters=30, rtol=1e-8, reorth=True)
    js = R.BIFSolver.create(**kw)
    mid = js.step_n(js.init_state(R.Dense(jnp.asarray(a)), jnp.asarray(us),
                                  **iv), 5)
    want = js.finalize(js.resume(mid))
    fields = {f: getattr(mid, f) for f in mid._fields}
    fields["op"] = ("dense", {"a": a})
    fields["st"] = _state_dict(mid.st)
    for f in ("lam_min", "lam_max", "basis", "step"):
        fields[f] = np.asarray(fields[f])
    if fields.get("coeffs") is None:
        fields.pop("coeffs", None)
    state = convert.state_from_numpy(fields, device="cpu")
    _basis_zero_past_live(state)
    counts = _record_live_rows(monkeypatch)
    ts = T.BIFSolver.create(backend="fused", **kw)
    got = ts.finalize(ts.resume(state))
    m = state.basis.shape[-2]
    assert counts == _live(len(counts), m, first=int(state.step))
    assert len(counts) > 0
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.certified.numpy(),
                                  np.asarray(want.certified))
    _close(got.lower.numpy(), want.lower, 1e-12, "lower")
    _close(got.upper.numpy(), want.upper, 1e-12, "upper")


# ---------------------------------------------------------------------------
# the reference's public names that the port once lacked: the QuadState
# threading registry and the two kernel-layer exports


@pytest.mark.parametrize("name", ["QUADSTATE_PER_LANE", "QUADSTATE_CARRIED",
                                  "QUADSTATE_PREPARED"])
def test_quadstate_registry_equals_reference(name):
    from repro.core import solver as jsolver
    from repro_torch.core import solver as tsolver
    assert getattr(tsolver, name) == getattr(jsolver, name)


def test_quadstate_registries_partition_the_fields():
    from repro_torch.core import solver as tsolver
    claimed = (tsolver.QUADSTATE_PER_LANE + tsolver.QUADSTATE_CARRIED
               + tsolver.QUADSTATE_PREPARED)
    assert sorted(claimed) == sorted(tsolver.QuadState._fields)
    assert len(set(claimed)) == len(claimed)


@pytest.mark.parametrize("bs,k_max", [(8, None), (16, None), (8, 9)])
def test_dense_to_bell_export_matches_reference(bs, k_max):
    a, _, _, _ = _problem(seed=5)
    want = jops.dense_to_bell(a, bs=bs, k_max=k_max)
    got = tops.dense_to_bell(a, bs=bs, k_max=k_max)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_gql_step_fused_export_matches_reference_step():
    """``tops.gql_step_fused`` on one dense lane (the plain K3 on the CPU)
    against ``jops.gql_step_fused`` in interpret mode, three steps from
    one state."""
    a, us, lmn, lmx = _problem(seed=6)
    jop, top, _ = _ops("dense", a)
    jst = R.gql.gql_init(jop, jnp.asarray(us[:1]), lmn, lmx)
    tst = convert.state_from_numpy(_state_dict(jst), device="cpu")
    for i in range(3):
        jst = jops.gql_step_fused(jop, jst, lmn, lmx, interpret=True)
        tst = tops.gql_step_fused(top, tst, lmn, lmx)
        for (name, g), (_, w) in zip(_leaves(tst), _leaves(jst)):
            g, w = g.numpy(), np.asarray(w)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                           err_msg=f"step {i} {name}")
            else:
                np.testing.assert_array_equal(g, w, f"step {i} {name}")
