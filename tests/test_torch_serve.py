"""The port's quadrature-serving engine (serve/engine.py: ``BIFRequest``,
``BIFEngine``) against the JAX package's on the same seeded numpy inputs
(f64, the plain kernels on the CPU).

These twin the reference's ``BIFEngine`` tests (tests/test_batched.py,
tests/test_matfun.py::test_engine_serves_mixed_fn_pool): each runs the
reference's assertions on the port and, where both packages serve the
same traffic, pins the discrete outcomes as equal (decisions, resolved
and certified flags, iterations, submission order) and the brackets to
1e-12 relative. They also hold the port's own rules: banked states share
no storage with the pool, a reference-banked partial resumes in a port
engine through ``convert``, and ``mesh=`` refuses anything but a lane
mesh (tests/test_torch_sharded.py serves on one)."""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.serve as RS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from conftest import make_spd  # noqa: E402


def _ops(a, kind="dense"):
    """The same matrix as a reference and a port operator."""
    if kind == "coo":
        return R.sparse_from_dense(a), T.sparse_from_dense(a, device="cpu")
    return R.Dense(jnp.asarray(a)), T.Dense(torch.tensor(a))


def _interval(a):
    w = np.linalg.eigvalsh(a)
    return dict(lam_min=float(w[0] * 0.99), lam_max=float(w[-1] * 1.01))


def _truths(a, us):
    return np.einsum("ki,ki->k", us, np.linalg.solve(a, us.T).T)


def _solvers(**kw):
    return R.BIFSolver.create(**kw), T.BIFSolver.create(**kw)


def _same(got, want, rtol=1e-12):
    """Pin two request lists: equal discrete outcomes, brackets to
    ``rtol``."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.decision == w.decision, i
        assert g.certified == w.certified, i
        assert g.resolved == w.resolved, i
        assert g.iterations == w.iterations, i
        assert (g.lower is None) == (w.lower is None), i
        if w.lower is not None:
            np.testing.assert_allclose([g.lower, g.upper],
                                       [w.lower, w.upper], rtol=rtol,
                                       err_msg=str(i))
        assert (g.state is None) == (w.state is None), i


def _serve(engine_cls, request_cls, op, reqs, *, mode="continuous",
           **kw):
    """Submit ``reqs`` (dicts of BIFRequest fields) to a new engine and
    flush it; returns (engine, submitted requests, flushed list)."""
    eng = engine_cls(op, **kw)
    sub = [eng.submit(request_cls(**r)) for r in reqs]
    return eng, sub, eng.flush(mode=mode)


def _both(a, reqs, kind="dense", mode="continuous", solver_kw=None, **kw):
    """Serve the same traffic through both packages' engines."""
    rop, top = _ops(a, kind)
    rs, ts = _solvers(**solver_kw) if solver_kw else (None, None)
    ref = _serve(RS.BIFEngine, RS.BIFRequest, rop, reqs, mode=mode,
                 solver=rs, **kw)
    got = _serve(TS.BIFEngine, TS.BIFRequest, top, reqs, mode=mode,
                 solver=ts, **kw)
    return got, ref


def _mixed(us, true, lo=0.9, hi=1.1):
    return [dict(u=u, t=float(true[i] * (lo if i % 2 else hi))
                 if i % 3 else None) for i, u in enumerate(us)]


def test_bif_engine_flushes_mixed_traffic_in_chunks():
    n = 36
    a = make_spd(n, kappa=90.0, seed=1)
    rng = np.random.default_rng(2)
    us = rng.standard_normal((11, n))
    true = _truths(a, us)
    skw = dict(max_iters=n + 2, rtol=1e-4)
    # the engine's own Gershgorin interval, as the reference test runs it
    (eng, reqs, out), (_, _, rout) = _both(a, _mixed(us, true),
                                           solver_kw=skw, max_batch=4)
    assert eng.pending() == 0 and out == reqs and len(out) == 11
    # That interval floors lam_min at 1e-9 lam_max, so the upper Radau end
    # amplifies the two packages' matvec roundoff by about 1e9: the
    # tolerance lanes may stop an iteration apart there. The judges'
    # outcomes are equal; the whole parity runs on the tight interval.
    for g, w in zip(out, rout):
        if w.t is not None:
            assert (g.decision, g.certified) == (w.decision, w.certified)
    (_, _, tout), (_, _, trout) = _both(a, _mixed(us, true), solver_kw=skw,
                                        max_batch=4, **_interval(a))
    _same(tout, trout)
    for i, r in enumerate(out):
        assert r.lower <= true[i] * 1.0001
        assert r.upper >= true[i] * 0.9999
        if r.t is None:
            assert r.decision is None
        else:
            assert r.decision == (r.t < true[i])
            assert r.certified
    # masked request against a principal submatrix; the engine restricts
    # the query to the mask itself
    mask = (rng.random(n) < 0.5).astype(float)
    req = eng.submit(TS.BIFRequest(u=us[0], mask=mask))
    eng.flush()
    um = us[0] * mask
    mm = np.diag(mask)
    am = mm @ a @ mm + np.eye(n) - mm
    tv = um @ np.linalg.solve(am, um)
    assert req.lower <= tv * 1.0001 and req.upper >= tv * 0.9999


def test_bif_engine_rejects_malformed_requests_at_submit():
    n = 12
    a = make_spd(n, kappa=10.0, seed=5)
    engine = TS.BIFEngine(T.Dense(torch.tensor(a)), max_batch=4)
    with pytest.raises(ValueError, match="u must have shape"):
        engine.submit(TS.BIFRequest(u=np.ones(n + 1)))
    with pytest.raises(ValueError, match="mask must have shape"):
        engine.submit(TS.BIFRequest(u=np.ones(n), mask=np.ones(n - 1)))
    with pytest.raises(ValueError, match="t must be a scalar"):
        engine.submit(TS.BIFRequest(u=np.ones(n), t=np.array([1.0, 2.0])))
    with pytest.raises(ValueError, match="legacy f=1/x"):
        engine.submit(TS.BIFRequest(u=np.ones(n), fn="log"))
    # a rejected request never enters the queue, so it can't wedge a flush
    assert engine.pending() == 0
    good = engine.submit(TS.BIFRequest(u=np.ones(n)))
    engine.flush()
    assert good.lower is not None and good.lower <= good.upper


def test_bif_engine_failed_round_marks_inflight_and_keeps_tail_order():
    """A driver failure mid-flush drops ONLY the in-flight requests (error
    set), keeps the unadmitted tail queued in submission order, and keeps
    the results of requests that already retired."""
    n = 12
    a = make_spd(n, kappa=10.0, seed=6)
    engine = TS.BIFEngine(T.Dense(torch.tensor(a)), max_batch=2,
                          chunk_iters=64)
    rng = np.random.default_rng(7)
    reqs = [engine.submit(TS.BIFRequest(u=rng.standard_normal(n)))
            for _ in range(5)]
    orig, calls = engine._step, [0]

    def flaky(*args):
        calls[0] += 1
        if calls[0] == 2:  # second scheduler round fails
            raise RuntimeError("transient driver failure")
        return orig(*args)

    engine._step = flaky
    with pytest.raises(RuntimeError, match="transient"):
        engine.flush()
    assert engine.pending() == 1
    assert [r.error is not None for r in reqs] == [False] * 2 + [True] * 2 \
        + [False]
    assert reqs[0].lower is not None and reqs[1].lower is not None
    engine._step = orig
    out = engine.flush()
    assert [r is reqs[4] for r in out] == [True]  # surviving tail, in order
    assert reqs[4].lower is not None
    engine.submit(reqs[2])
    engine.flush()
    assert reqs[2].error is None and reqs[2].lower is not None


@pytest.mark.parametrize("mode", ["continuous", "lockstep"])
def test_bif_engine_continuous_matches_lockstep_and_preserves_fifo(mode):
    """Continuous batching retires/backfills mid-flight but returns the
    lockstep flush's per-request outcomes in submission order; each mode
    equals the reference's same mode."""
    n = 36
    a = make_spd(n, kappa=90.0, seed=3)
    lam = _interval(a)
    rng = np.random.default_rng(8)
    us = rng.standard_normal((13, n))
    reqs = _mixed(us, _truths(a, us), 0.8, 1.2)
    skw = dict(max_iters=n + 2, rtol=1e-4)
    chunk = dict(chunk_iters=3) if mode == "continuous" else {}
    (_, sub, out), (_, _, rout) = _both(a, reqs, mode=mode, solver_kw=skw,
                                        max_batch=4, **chunk, **lam)
    assert out == sub  # FIFO-preserving completion
    _same(out, rout)
    if mode == "continuous":
        (_, lsub, lout), _ = _both(a, reqs, mode="lockstep", solver_kw=skw,
                                   max_batch=4, **lam)
        for i, (c, l) in enumerate(zip(out, lout)):
            assert c.decision == l.decision, i
            assert c.certified == l.certified, i
            assert c.iterations == l.iterations, i
            np.testing.assert_allclose([c.lower, c.upper],
                                       [l.lower, l.upper], rtol=1e-12)
            assert c.resolved and c.state is None


def test_bif_engine_budget_partials_resume_bit_exact():
    """A request whose iteration budget expires comes back partial with a
    banked QuadState; resubmitting it resumes the solve and lands on the
    SAME bracket and iteration count as an uninterrupted run, in the
    engine and outside it, and on the reference's numbers."""
    n = 40
    a = make_spd(n, kappa=50.0, seed=9)
    lam = _interval(a)
    rop, op = _ops(a, "coo")
    rsv, sv = _solvers(max_iters=n + 2, rtol=1e-6)
    u = np.random.default_rng(10).standard_normal(n)

    full = TS.BIFEngine(op, solver=sv, max_batch=4, **lam)
    ref = full.submit(TS.BIFRequest(u=u))
    full.flush()
    assert ref.resolved and ref.iterations > 6

    eng = TS.BIFEngine(op, solver=sv, max_batch=4, chunk_iters=2, **lam)
    part = eng.submit(TS.BIFRequest(u=u, max_iters=5))
    eng.flush()
    assert part.resolved is False and part.certified is False
    assert part.iterations == 5 and part.state is not None
    assert part.lower is not None and part.lower <= part.upper
    assert part.lower <= ref.lower and part.upper >= ref.upper
    # the reference banks the same partial
    reng = RS.BIFEngine(rop, solver=rsv, max_batch=4, chunk_iters=2, **lam)
    rpart = reng.submit(RS.BIFRequest(u=u, max_iters=5))
    reng.flush()
    _same([part], [rpart])
    part.max_iters = None
    eng.submit(part)
    eng.flush()
    assert part.resolved and part.state is None
    assert part.iterations == ref.iterations
    assert part.lower == ref.lower and part.upper == ref.upper
    rpart.max_iters = None
    reng.submit(rpart)
    reng.flush()
    _same([part], [rpart])
    # the banked state also resumes OUTSIDE the engine, same answer
    part2 = eng.submit(TS.BIFRequest(u=u, max_iters=5))
    eng.flush()
    res = sv.finalize(sv.resume(part2.state))
    assert float(res.lower) == ref.lower and float(res.upper) == ref.upper


def test_bif_engine_banked_state_shares_no_storage_with_the_pool():
    """A banked partial holds clones: the pool steps on (other lanes keep
    solving in the same flush, then a second flush reuses the engine)
    without touching it, and it still resumes bit-exactly."""
    n = 40
    a = make_spd(n, kappa=50.0, seed=9)
    lam = _interval(a)
    _, op = _ops(a, "coo")
    sv = T.BIFSolver.create(max_iters=n + 2, rtol=1e-6)
    rng = np.random.default_rng(31)
    u = rng.standard_normal(n)
    eng = TS.BIFEngine(op, solver=sv, max_batch=4, chunk_iters=2, **lam)
    part = eng.submit(TS.BIFRequest(u=u, max_iters=3))
    others = [eng.submit(TS.BIFRequest(u=rng.standard_normal(n)))
              for _ in range(5)]
    eng.flush()
    assert part.state is not None and all(r.resolved for r in others)
    leaves = []
    teng._tree_map(lambda x: leaves.append(x) or x,
                   (part.state.st, part.state.op.mask))
    saved = [x.clone() for x in leaves]
    for _ in range(2):
        for _ in range(5):
            eng.submit(TS.BIFRequest(u=rng.standard_normal(n)))
        eng.flush()
    for x, y in zip(leaves, saved):
        assert torch.equal(x, y)
    full = TS.BIFEngine(op, solver=sv, max_batch=4, **lam)
    want = full.submit(TS.BIFRequest(u=u))
    full.flush()
    part.max_iters = None
    eng.submit(part)
    eng.flush()
    assert (part.lower, part.upper, part.iterations) == \
        (want.lower, want.upper, want.iterations)


def test_bif_engine_rejects_mutated_partial_resubmission():
    n = 40
    a = make_spd(n, kappa=50.0, seed=9)
    eng = TS.BIFEngine(T.sparse_from_dense(a, device="cpu"),
                       solver=T.BIFSolver.create(max_iters=n + 2, rtol=1e-6),
                       max_batch=4, chunk_iters=2, **_interval(a))
    rng = np.random.default_rng(15)
    r = eng.submit(TS.BIFRequest(u=rng.standard_normal(n), max_iters=4))
    eng.flush()
    assert r.resolved is False and r.state is not None
    r.u = rng.standard_normal(n)  # different query, stale state
    with pytest.raises(ValueError, match="banks the solve"):
        eng.submit(r)
    r.state = None                # explicit re-solve is fine
    r.max_iters = None
    eng.submit(r)
    eng.flush()
    assert r.resolved


def _counting_engine(n=24):
    a = make_spd(n, kappa=200.0, seed=11)
    eng = TS.BIFEngine(T.Dense(torch.tensor(a)),
                       solver=T.BIFSolver.create(max_iters=n + 2,
                                                 rtol=1e-12),
                       max_batch=2, chunk_iters=1, **_interval(a))
    steps = [0]
    orig_step = eng._step

    def counting_step(*args, **kwargs):
        steps[0] += 1
        return orig_step(*args, **kwargs)

    eng._step = counting_step
    return eng, steps


def test_bif_engine_deadline_retires_partial():
    """A deadline that expires mid-solve retires the request at the next
    chunk boundary as a PARTIAL result with its banked state. Each round
    here waits 50 ms, so the 0.2 s deadline lands after admission and
    before the solve can reach its cap (the plain CPU rounds would
    otherwise outrun it)."""
    eng, steps = _counting_engine()
    orig = eng._step

    def slow(*args, **kwargs):
        time.sleep(0.05)
        return orig(*args, **kwargs)

    eng._step = slow
    rng = np.random.default_rng(12)
    req = eng.submit(TS.BIFRequest(u=rng.standard_normal(24),
                                   deadline=time.monotonic() + 0.2))
    eng.flush()
    assert steps[0] >= 1
    assert req.iterations >= 1 and req.lower is not None
    assert req.state is not None and not req.resolved
    assert eng.stats()["counters"]["requests.expired"] == 1


def test_bif_engine_expired_deadline_retires_at_admission():
    eng, steps = _counting_engine()
    rng = np.random.default_rng(12)
    dead = [eng.submit(TS.BIFRequest(u=rng.standard_normal(24),
                                     deadline=0.0)) for _ in range(3)]
    out = eng.flush()
    assert steps[0] == 0
    assert out == dead  # submission order preserved
    for r in dead:
        assert r.iterations == 0 and r.resolved is False
        assert r.state is None and r.lower is None and r.upper is None
        assert r.certified is False
    live = TS.BIFRequest(u=rng.standard_normal(24))
    expired = TS.BIFRequest(u=rng.standard_normal(24), deadline=0.0)
    r1 = eng.submit(expired)
    r2 = eng.submit(live)
    out = eng.flush()
    assert out == [r1, r2]
    assert r1.iterations == 0 and r1.state is None
    assert steps[0] >= 1 and r2.iterations >= 1


def test_bif_engine_submit_clears_stale_results():
    n = 32
    a = make_spd(n, kappa=300.0, seed=21)
    eng = TS.BIFEngine(T.Dense(torch.tensor(a)),
                       solver=T.BIFSolver.create(max_iters=n + 2, rtol=1e-6),
                       max_batch=2, chunk_iters=2, **_interval(a))
    rng = np.random.default_rng(22)
    r = eng.submit(TS.BIFRequest(u=rng.standard_normal(n), max_iters=2))
    eng.flush()
    assert r.resolved is False and r.lower is not None
    it_coarse = r.iterations
    r.max_iters = None
    eng.submit(r)
    assert r.lower is None and r.upper is None
    assert r.decision is None and r.certified is None
    assert r.iterations is None and r.resolved is None
    assert r.state is not None  # the banked resume state survives
    eng.flush()
    assert r.resolved and r.lower is not None
    assert r.iterations > it_coarse


@pytest.mark.parametrize("cfg", [dict(reorth=True),
                                 dict(precondition="jacobi")],
                         ids=["reorth", "jacobi"])
def test_bif_engine_legacy_configs_fall_back_to_lockstep(cfg):
    """reorth / preconditioned solvers keep flushing through the lockstep
    path, as in the reference, with the reference's outcomes."""
    n = 16
    a = make_spd(n, kappa=20.0, seed=13)
    u = np.random.default_rng(14).standard_normal(n)
    (_, (r,), _), (_, (rr,), _) = _both(
        a, [dict(u=u)], solver_kw=dict(max_iters=n + 2, rtol=1e-4, **cfg))
    true = float(u @ np.linalg.solve(a, u))
    assert r.lower <= true * 1.0001 and r.upper >= true * 0.9999
    assert r.resolved
    _same([r], [rr])


_F = {"log": np.log, "invsqrt": lambda x: x ** -0.5, "inv": lambda x: 1 / x,
      "sqrt": np.sqrt}


def test_engine_serves_mixed_fn_pool():
    a = make_spd(28, kappa=60.0, seed=2)
    w, v = np.linalg.eigh(a)
    lam = _interval(a)
    rop, op = _ops(a)
    us = np.random.default_rng(4).standard_normal((6, 28))
    skw = dict(max_iters=40, rtol=1e-6, atol=1e-10, fn="log")
    rsv, sv = _solvers(**skw)
    fns = ["log", "invsqrt", None, "inv", "sqrt", "log"]
    reqs = [dict(u=u, fn=f) for u, f in zip(us, fns)]
    eng, sub, out = _serve(TS.BIFEngine, TS.BIFRequest, op, reqs,
                           solver=sv, max_batch=4, **lam)
    _, _, rout = _serve(RS.BIFEngine, RS.BIFRequest, rop, reqs, solver=rsv,
                        max_batch=4, **lam)
    assert out == sub
    _same(out, rout)
    for r, f, u in zip(out, fns, us):
        c = v.T @ u
        true = float(np.sum(c * c * _F[f or "log"](w)))
        assert r.resolved
        assert r.lower <= true + 1e-8 * abs(true)
        assert r.upper >= true - 1e-8 * abs(true)

    r = eng.submit(TS.BIFRequest(u=us[0], fn="log", max_iters=3))
    eng.flush()
    assert not r.resolved and r.iterations == 3
    assert r.state is not None and r.state.coeffs is not None
    eng.submit(r)
    eng.flush()
    assert r.iterations > 3
    c = v.T @ us[0]
    true = float(np.sum(c * c * np.log(w)))
    assert r.lower <= true <= r.upper

    r2 = eng.submit(TS.BIFRequest(u=us[1], fn="invsqrt", max_iters=2))
    eng.flush()
    assert r2.state is not None
    r2.fn = "log"
    with pytest.raises(ValueError, match="banks a fn='invsqrt'"):
        eng.submit(r2)

    legacy_eng = TS.BIFEngine(op, max_batch=4, **lam)
    with pytest.raises(ValueError, match="legacy f=1/x"):
        legacy_eng.submit(TS.BIFRequest(u=us[0], fn="log"))
    r3 = eng.submit(TS.BIFRequest(u=us[2], fn="inv", max_iters=1))
    eng.flush()
    assert r3.state is not None and r3.state.coeffs is not None
    with pytest.raises(ValueError, match="cannot resume on this one"):
        legacy_eng.submit(r3)
    r4 = legacy_eng.submit(TS.BIFRequest(u=us[3], max_iters=1))
    legacy_eng.flush()
    assert r4.state is not None and r4.state.coeffs is None
    r4.fn = "inv"
    with pytest.raises(ValueError, match="cannot resume on this one"):
        eng.submit(r4)


def _leaves_numpy(x):
    if hasattr(x, "_fields"):
        return {f: _leaves_numpy(v) for f, v in zip(x._fields, x)}
    if dataclasses.is_dataclass(x):
        return {f.name: _leaves_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("fn", ["inv", "log"])
def test_reference_banked_partial_resumes_in_port_engine(fn):
    """A partial banked by the JAX engine, brought over as numpy leaves by
    ``convert.request_from_numpy`` (a QuadState over a 1-D Masked mask,
    basis None), resumes in a port engine to the reference's own resumed
    result; a mutated query is still refused."""
    n = 32
    a = make_spd(n, kappa=80.0, seed=23)
    lam = _interval(a)
    rop, op = _ops(a)
    skw = dict(max_iters=n + 2, rtol=1e-8) if fn == "inv" else \
        dict(max_iters=n + 2, rtol=1e-8, fn="log")
    rsv, sv = _solvers(**skw)
    rng = np.random.default_rng(24)
    u = rng.standard_normal(n)
    mask = (rng.random(n) < 0.7).astype(float)
    reng = RS.BIFEngine(rop, solver=rsv, max_batch=4, chunk_iters=2, **lam)
    rr = reng.submit(RS.BIFRequest(u=u, mask=mask, t=None, max_iters=4))
    reng.flush()
    assert rr.resolved is False and rr.state is not None
    st = rr.state
    fields = dict(u=u, mask=mask, max_iters=None, state={
        "op": ("masked", {"base": ("dense", {"a": a}),
                          "mask": np.asarray(st.op.mask)}),
        "st": _leaves_numpy(st.st), "lam_min": np.asarray(st.lam_min),
        "lam_max": np.asarray(st.lam_max), "basis": None,
        "step": np.asarray(st.step), "coeffs": _leaves_numpy(st.coeffs)})
    req = convert.request_from_numpy(fields, device="cpu")
    assert req.state.op.mask.shape == (n,) and req.state.basis is None
    eng = TS.BIFEngine(op, solver=sv, max_batch=4, chunk_iters=2, **lam)
    eng.submit(req)
    eng.flush()
    rr.max_iters = None
    reng.submit(rr)
    reng.flush()
    assert req.resolved and req.state is None
    _same([req], [rr])
    # converted requests keep the mutated-query guard
    again = convert.request_from_numpy(fields, device="cpu")
    again.mask = np.ones(n)
    with pytest.raises(ValueError, match="banks the solve"):
        eng.submit(again)


def test_engine_stats_equal_the_reference():
    """The counters and histogram populations of one scripted mixed flush
    (judges, brackets, a partial, an expired request) equal the
    reference's."""
    n = 32
    a = make_spd(n, kappa=60.0, seed=2)
    lam = _interval(a)
    us = np.random.default_rng(3).standard_normal((9, n))
    reqs = _mixed(us, _truths(a, us), 0.8, 1.2)
    reqs[4]["max_iters"] = 2
    reqs.append(dict(u=us[0], deadline=0.0))
    (eng, _, out), (reng, _, rout) = _both(
        a, reqs, solver_kw=dict(max_iters=n + 2, rtol=1e-4), max_batch=4,
        chunk_iters=3, **lam)
    _same(out, rout)
    got, want = eng.stats(), reng.stats()
    assert got["counters"] == want["counters"]
    assert {k: h["count"] for k, h in got["histograms"].items()} == \
        {k: h["count"] for k, h in want["histograms"].items()}
    assert got["histograms"]["request.iterations"]["sum"] == \
        want["histograms"]["request.iterations"]["sum"]


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_engine_on_kernel_backends_matches_reference(backend):
    """'pallas' (K1's plain version) and 'fused' (K3's) pools serve the
    reference engine's outcomes, continuous and lockstep."""
    n = 40
    a = make_spd(n, kappa=50.0, seed=17)
    lam = _interval(a)
    rng = np.random.default_rng(18)
    us = rng.standard_normal((10, n))
    reqs = _mixed(us, _truths(a, us), 0.7, 1.3)
    reqs[2]["mask"] = (rng.random(n) < 0.5).astype(float)
    rop, op = _ops(a)
    rsv = R.BIFSolver.create(max_iters=n + 2, rtol=1e-4)
    sv = T.BIFSolver.create(max_iters=n + 2, rtol=1e-4, backend=backend)
    for mode in ("continuous", "lockstep"):
        _, sub, out = _serve(TS.BIFEngine, TS.BIFRequest, op, reqs,
                             mode=mode, solver=sv, max_batch=4,
                             chunk_iters=4, **lam)
        _, _, rout = _serve(RS.BIFEngine, RS.BIFRequest, rop, reqs,
                            mode=mode, solver=rsv, max_batch=4,
                            chunk_iters=4, **lam)
        assert out == sub
        _same(out, rout)


def test_engine_signatures_count_once_per_new_driver_signature():
    """flush_trace_count rises once per new driver signature (solver
    config, operator shapes, pool shape, dtype, device) and never when an
    engine repeats one."""
    n = 20
    a = make_spd(n, kappa=30.0, seed=19)
    lam = _interval(a)
    us = np.random.default_rng(20).standard_normal((3, n))
    sv = T.BIFSolver.create(max_iters=n + 2, rtol=1e-5, atol=1e-300)

    def flush(op, mode="continuous", batch=3):
        eng = TS.BIFEngine(op, solver=sv, max_batch=batch, **lam)
        for u in us:
            eng.submit(TS.BIFRequest(u=u))
        eng.flush(mode=mode)

    op = T.Dense(torch.tensor(a))
    before = TS.flush_trace_count()
    flush(op)
    first = TS.flush_trace_count()
    assert first > before
    flush(T.Dense(torch.tensor(a)))          # same signature: no count
    flush(op, mode="lockstep")
    second = TS.flush_trace_count()
    assert second == first + 1                # the lockstep driver
    flush(op, mode="lockstep")
    assert TS.flush_trace_count() == second
    flush(op, batch=5)                        # a new pool shape counts
    assert TS.flush_trace_count() > second


def test_engine_mesh_raises_until_ported():
    """``mesh=`` takes a lane mesh (tests/test_torch_sharded.py serves on
    one) and refuses anything else; block lanes have no requests."""
    a = make_spd(8, kappa=5.0, seed=1)
    with pytest.raises(TypeError, match="DeviceMesh"):
        TS.BIFEngine(T.Dense(torch.tensor(a)), mesh=object())
    with pytest.raises(NotImplementedError, match="block_size"):
        TS.BIFEngine(T.Dense(torch.tensor(a)),
                     solver=T.BIFSolver.create(block_size=2))


def test_engine_reads_a_round_back_once(monkeypatch):
    """Each continuous round moves its six per-lane results to the host
    in one read-back, and each lockstep chunk likewise."""
    n = 20
    a = make_spd(n, kappa=30.0, seed=21)
    calls = []
    orig = teng._read_back

    def counting(*values):
        calls.append(len(values))
        return orig(*values)

    monkeypatch.setattr(teng, "_read_back", counting)
    eng = TS.BIFEngine(T.Dense(torch.tensor(a)),
                       solver=T.BIFSolver.create(max_iters=n + 2,
                                                 rtol=1e-6),
                       max_batch=2, chunk_iters=2, **_interval(a))
    rng = np.random.default_rng(22)
    for _ in range(3):
        eng.submit(TS.BIFRequest(u=rng.standard_normal(n)))
    eng.flush()
    rounds = eng.stats()["counters"]["flush.rounds"]
    assert calls == [6] * rounds
    calls.clear()
    for _ in range(3):
        eng.submit(TS.BIFRequest(u=rng.standard_normal(n)))
    eng.flush(mode="lockstep")
    assert calls == [6, 6]


def test_resubmitted_partial_returns_to_its_banked_slot(monkeypatch):
    """A resubmitted partial is scattered back into the slot it was banked
    from when that slot is free, whatever its place in the queue;
    admission stays FIFO."""
    n = 21
    a = make_spd(n, kappa=30.0, seed=41)
    lam = _interval(a)
    sv = T.BIFSolver.create(max_iters=n + 2, rtol=1e-10)
    eng = TS.BIFEngine(T.Dense(torch.tensor(a)), solver=sv, max_batch=8,
                       chunk_iters=2, **lam)
    rng = np.random.default_rng(42)
    for _ in range(3):
        eng.submit(TS.BIFRequest(u=rng.standard_normal(n)))
    part = eng.submit(TS.BIFRequest(u=rng.standard_normal(n), max_iters=2))
    eng.flush()
    assert part.state is not None and part._banked_slot == 3
    scattered = []
    orig = teng._pool_scatter_run

    def spy(st, lane, idx):
        scattered.append(idx)
        return orig(st, lane, idx)

    monkeypatch.setattr(teng, "_pool_scatter_run", spy)
    ahead = [eng.submit(TS.BIFRequest(u=rng.standard_normal(n)))
             for _ in range(5)]
    part.max_iters = None
    eng.submit(part)
    # the slots: the queue's FIFO order over the free slots, the partial
    # at home
    placed = TS.BIFEngine._place(ahead + [part], list(range(8)))
    assert [i for i, _ in placed] == list(range(6))
    assert dict(placed)[3] is part
    assert [r for i, r in placed if i != 3] == ahead
    # a home slot that is taken, or out of range, falls back to FIFO
    placed = TS.BIFEngine._place(ahead[:2] + [part], [0, 1, 2])
    assert [r for _, r in placed] == ahead[:2] + [part]
    out = eng.flush()
    assert scattered == [3] and part.resolved
    assert out == ahead + [part]
