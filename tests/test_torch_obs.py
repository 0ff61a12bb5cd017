"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``) on the same inputs.

Twins of tests/test_obs.py: metric primitives and exact nearest-rank
percentiles (the same snapshots as the reference's on the same
observations), the global gate, span nesting and schema, the error
annotation, engine stats over a scripted mixed workload, errored
requests, the signature registry feeding ``flush_trace_count``,
convergence logs bit-exact against ``trace`` and ``step_n``, the health
checks (with the reference's verdicts on the same logs), engine results
bit-identical with metrics and spans on and off, and the obs smoke on
the CPU."""
import json
import math
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro import obs as robs  # noqa: E402
from repro.obs import schema as robs_schema  # noqa: E402
from repro_torch import obs  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.obs import schema as obs_schema  # noqa: E402
from repro_torch.obs.health import check_contraction  # noqa: E402
from repro_torch.obs.metrics import Histogram, MetricsRegistry  # noqa: E402
from repro_torch.serve import BIFEngine, BIFRequest  # noqa: E402
from conftest import make_spd  # noqa: E402


@pytest.fixture(autouse=True)
def _obs_defaults():
    """Every test starts from (and restores) the shipped defaults:
    metrics on, spans off, clean span buffer."""
    obs.metrics.set_enabled(True)
    obs.spans.set_enabled(False)
    obs.spans.reset()
    yield
    obs.metrics.set_enabled(True)
    obs.spans.set_enabled(False)
    obs.spans.reset()


def _nan_equal(a, b) -> bool:
    """Snapshots equal, NaN matching NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_nan_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_nan_equal, a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


# -- 1. metric primitives ---------------------------------------------------

def test_counter_gauge_and_snapshot_shape():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(2.5)
    reg.histogram("h").observe(0.125)
    snap = reg.snapshot()
    assert snap["counters"] == {"c": 5}
    assert snap["gauges"] == {"g": 2.5}
    assert snap["histograms"]["h"]["count"] == 1
    assert reg.counter("c") is reg.counter("c")
    with pytest.raises(TypeError):
        reg.gauge("c")
    reg.reset()
    assert reg.snapshot()["counters"] == {"c": 0}


def test_histogram_percentiles_are_exact_and_equal_the_reference():
    rng = np.random.default_rng(0)
    samples = np.concatenate([
        rng.lognormal(mean=-3.0, sigma=2.0, size=257),
        [0.0, -1.0, 5e-12, 3e7],  # under/overflow buckets
    ])
    h = Histogram("lat")
    href = robs.metrics.Histogram("lat")
    for v in samples:
        h.observe(float(v))
        href.observe(float(v))
    for q in (50.0, 90.0, 99.0, 1.0, 100.0):
        assert h.percentile(q) == float(
            np.percentile(samples, q, method="inverted_cdf")), q
        assert h.percentile(q) == href.percentile(q)
    snap = h.snapshot()
    assert _nan_equal(snap, href.snapshot())
    assert snap["count"] == len(samples)
    assert snap["min"] == samples.min() and snap["max"] == samples.max()
    np.testing.assert_allclose(snap["mean"], samples.mean(), rtol=1e-12)
    assert sum(c for _, c in snap["buckets"]) == len(samples)
    with pytest.raises(ValueError):
        h.percentile(0.0)


def test_histogram_empty_snapshot_is_nan_not_crash():
    snap = Histogram("e").snapshot()
    assert snap["count"] == 0 and snap["buckets"] == []
    assert math.isnan(snap["p50"]) and math.isnan(snap["mean"])
    assert math.isnan(Histogram("e2").percentile(99.0))
    assert _nan_equal(snap, robs.metrics.Histogram("e").snapshot())


def test_metrics_global_gate_stops_writes_not_reads():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    obs.metrics.set_enabled(False)
    reg.counter("c").inc(100)
    reg.gauge("g").set(9.0)
    reg.histogram("h").observe(1.0)
    snap = reg.snapshot()  # reads still work
    assert snap["counters"]["c"] == 1
    assert snap["gauges"]["g"] == 0.0
    assert snap["histograms"]["h"]["count"] == 0
    obs.metrics.set_enabled(True)
    reg.counter("c").inc()
    assert reg.counter("c").value == 2


# -- 2. spans ---------------------------------------------------------------

def test_spans_off_by_default_nest_and_validate_schema(tmp_path):
    with obs.span("dead"):
        pass
    assert obs.trace_events() == []  # collection is opt-in

    obs.spans.set_enabled(True)
    with obs.span("outer", mode="test"):
        with obs.span("inner") as sp:
            x = torch.ones(3)
            assert sp.block_until_ready((x, {"y": x})) is not None
            time.sleep(0.002)
    events = obs.trace_events()
    assert [e["name"] for e in events] == ["inner", "outer"]  # close order
    inner, outer = events
    assert inner["args"]["depth"] == 1 and outer["args"]["depth"] == 0
    assert outer["args"]["mode"] == "test"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert inner["dur"] >= 1e3  # the 2ms sleep, in microseconds

    doc = obs.dump_trace(tmp_path / "trace.json")
    schema = json.loads(
        (Path(obs.spans.__file__).parent / "trace_schema.json").read_text())
    obs_schema.validate(doc, schema)
    # the port's schema is the reference's, but for its $comment
    ref_schema = json.loads((Path(robs.spans.__file__).parent
                             / "trace_schema.json").read_text())
    schema.pop("$comment"), ref_schema.pop("$comment")
    assert schema == ref_schema
    on_disk = json.loads((tmp_path / "trace.json").read_text())
    assert on_disk["traceEvents"] == json.loads(json.dumps(
        doc["traceEvents"]))
    obs.spans.reset()
    assert obs.trace_events() == []


def test_span_records_error_annotation():
    obs.spans.set_enabled(True)
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    (ev,) = obs.trace_events()
    assert ev["args"]["error"] == "RuntimeError"


def test_schema_validator_rejects_what_the_reference_rejects():
    schema = json.loads(
        (Path(obs.spans.__file__).parent / "trace_schema.json").read_text())
    bad = [{"traceEvents": [{"name": "x", "ph": "B", "ts": 0.0, "dur": 1.0,
                             "pid": 1, "tid": 1}]},
           {"traceEvents": [{"name": "x", "ph": "X", "ts": True, "dur": 1.0,
                             "pid": 1, "tid": 1}]},
           {"displayTimeUnit": "ms"}]
    for doc in bad:
        with pytest.raises(ValueError) as got:
            obs_schema.validate(doc, schema)
        with pytest.raises(ValueError) as want:
            robs_schema.validate(doc, schema)
        assert str(got.value) == str(want.value)


# -- 3. engine request metrics ---------------------------------------------

def _engine_problem(n=32, kappa=60.0, seed=2, k=9):
    a = make_spd(n, kappa=kappa, seed=seed)
    w = np.linalg.eigvalsh(a)
    lam = dict(lam_min=float(w[0] * 0.99), lam_max=float(w[-1] * 1.01))
    us = np.random.default_rng(seed + 1).standard_normal((k, n))
    true = np.einsum("ki,ki->k", us, np.linalg.solve(a, us.T).T)
    return a, us, true, lam


def test_engine_stats_scripted_mixed_workload():
    a, us, true, lam = _engine_problem()
    n, k = a.shape[0], len(us)
    engine = BIFEngine(T.Dense(torch.tensor(a)),
                       solver=T.BIFSolver.create(max_iters=n + 2,
                                                 rtol=1e-4),
                       max_batch=4, chunk_iters=3, **lam)
    for i, u in enumerate(us):
        t = float(true[i] * (0.8 if i % 2 else 1.2)) if i % 3 else None
        engine.submit(BIFRequest(u=u, t=t, deadline=time.monotonic() + 60.0))
    dead = engine.submit(BIFRequest(u=us[0],
                                    deadline=time.monotonic() - 1.0))
    out = engine.flush()
    assert len(out) == k + 1
    assert dead.resolved is False and dead.iterations == 0

    s = engine.stats()
    c = s["counters"]
    assert c["requests.submitted"] == k + 1
    assert c["requests.retired"] == k + 1
    assert c["requests.resolved"] == k
    assert c["requests.partial"] == 1
    assert c["requests.expired"] == 1
    assert c["flush.count"] == 1
    assert c["flush.rounds"] >= math.ceil(k / 4)
    assert "requests.errored" not in c

    h = s["histograms"]
    assert h["request.queue_wait_s"]["count"] == k + 1
    assert h["request.latency_s"]["count"] == k
    for field in ("p50", "p90", "p99", "mean", "min", "max"):
        assert field in h["request.latency_s"]
    assert h["request.latency_s"]["p99"] >= h["request.latency_s"]["p50"]
    assert h["request.deadline_slack_s"]["count"] == k + 1
    assert h["request.deadline_slack_s"]["min"] < 0.0
    assert h["request.iterations"]["count"] == k + 1
    assert h["request.iterations"]["min"] == 0.0  # the expired request
    occ = h["pool.occupancy"]
    assert occ["count"] == c["flush.rounds"] and occ["max"] <= 1.0

    engine.reset_stats()
    assert engine.stats()["counters"]["requests.submitted"] == 0


def test_engine_stats_count_errored_requests():
    a, us, _, lam = _engine_problem(k=3)
    engine = BIFEngine(T.Dense(torch.tensor(a)), max_batch=2, **lam)
    for u in us:
        engine.submit(BIFRequest(u=u))

    class _Boom(Exception):
        pass

    def boom(*a_, **k_):
        raise _Boom()

    engine._step = boom
    with pytest.raises(_Boom):
        engine.flush()
    assert engine.stats()["counters"]["requests.errored"] >= 1


def test_retrace_registry_feeds_flush_trace_count():
    from repro_torch.serve.engine import flush_trace_count
    a, us, _, lam = _engine_problem(n=30, k=3)
    before_total = flush_trace_count()
    before = dict(obs.retrace_counts())
    engine = BIFEngine(T.Dense(torch.tensor(a)), max_batch=4, chunk_iters=4,
                       **lam)
    for u in us:
        engine.submit(BIFRequest(u=u))
    engine.flush()
    after = obs.retrace_counts()
    grown = {k_: v - before.get(k_, 0) for k_, v in after.items()
             if v != before.get(k_, 0)}
    assert grown, "an engine flush must register at least one signature"
    assert all(k_.startswith("serve.engine.") for k_ in grown)
    assert flush_trace_count() - before_total == sum(
        v for k_, v in grown.items()
        if k_.split(".")[-1] in ("pool_admit", "pool_scatter", "pool_step",
                                 "flush"))
    # the same flush again meets no new signature
    for u in us:
        engine.submit(BIFRequest(u=u))
    engine.flush()
    assert obs.retrace_counts() == after


# -- 4. convergence logs mirror returned brackets bit-exactly ---------------

def test_convergence_log_matches_trace_bit_exact():
    n, kappa = 48, 100.0
    a = make_spd(n, kappa=kappa, seed=0)
    u = np.random.default_rng(1).standard_normal(n)
    solver = T.BIFSolver.create(max_iters=n, reorth=True)
    kw = dict(lam_min=1.0 / kappa * 0.999, lam_max=1.001)
    op = T.Dense(torch.tensor(a))

    log = obs.ConvergenceLog()
    tr = solver.trace(op, torch.tensor(u), n - 2, convergence_log=log, **kw)
    assert log.rounds == n - 2
    np.testing.assert_array_equal(log.lowers()[:, 0], tr.radau_lower.numpy())
    np.testing.assert_array_equal(log.uppers()[:, 0], tr.radau_upper.numpy())
    np.testing.assert_array_equal(log.its()[:, 0], np.arange(1, n - 1))
    tr2 = solver.trace(op, torch.tensor(u), n - 2, **kw)
    assert torch.equal(tr.radau_lower, tr2.radau_lower)
    assert torch.equal(tr.radau_upper, tr2.radau_upper)
    # the reference's log of the same trace, to the gemm tolerance
    rlog = robs.ConvergenceLog()
    R.BIFSolver.create(max_iters=n, reorth=True).trace(
        R.Dense(jnp.asarray(a)), jnp.asarray(u), n - 2, convergence_log=rlog,
        **kw)
    np.testing.assert_array_equal(log.its(), rlog.its())
    np.testing.assert_allclose(log.lowers(), rlog.lowers(), rtol=1e-10)
    np.testing.assert_allclose(log.uppers(), rlog.uppers(), rtol=1e-10)


def test_convergence_log_matches_step_n_states_bit_exact():
    n = 40
    a = make_spd(n, kappa=50.0, seed=3)
    u = torch.tensor(np.random.default_rng(4).standard_normal(n))
    solver = T.BIFSolver.create(max_iters=n, rtol=1e-10)
    log = obs.ConvergenceLog()
    op = T.Dense(torch.tensor(a))
    state = solver.init_state(op, u, lam_min=0.01, lam_max=1.1)
    ref = solver.init_state(op, u, lam_min=0.01, lam_max=1.1)
    for _ in range(4):
        state = solver.step_n(state, 5, convergence_log=log)
        ref = solver.step_n(ref, 5)
        lo, hi = state.bracket()
        np.testing.assert_array_equal(log.lowers()[-1],
                                      np.atleast_1d(lo.numpy()))
        np.testing.assert_array_equal(log.uppers()[-1],
                                      np.atleast_1d(hi.numpy()))
        rlo, rhi = ref.bracket()
        assert torch.equal(lo, rlo) and torch.equal(hi, rhi)
    assert log.rounds == 4
    assert int(log.its()[-1, 0]) == int(state.it)
    # a no-op step_n (fewer steps than one round) records nothing
    solver.replace(decide_every=8).step_n(state, 5, convergence_log=log)
    assert log.rounds == 4


def test_convergence_log_rejects_shape_drift():
    log = obs.ConvergenceLog()
    log.record([1.0, 1.0], [2.0, 2.0], 1)
    with pytest.raises(ValueError):
        log.record([1.0], [2.0], 2)
    with pytest.raises(ValueError):
        log.record([1.0, 1.0], [2.0], 2)
    # tensors are read through the host
    log.record(torch.ones(2), torch.full((2,), 3.0), torch.tensor(2))
    assert log.rounds == 2 and log.its()[-1].tolist() == [2, 2]


# -- 5. convergence health -------------------------------------------------

def _health_report(kappa, *, reorth, n=64, seed=0):
    """The canonical convergence-pin setup (tests/test_convergence.py),
    through the port's solver."""
    a = make_spd(n, kappa=kappa, seed=seed)
    u = np.random.default_rng(seed + 1).standard_normal(n)
    solver = T.BIFSolver.create(max_iters=n, reorth=reorth)
    mon = obs.ContractionMonitor(1.0 / kappa * 0.999, 1.001, dim=n)
    solver.trace(T.Dense(torch.tensor(a)), torch.tensor(u), n - 2,
                 lam_min=1.0 / kappa * 0.999, lam_max=1.001,
                 convergence_log=mon.log)
    return mon.report()


def test_health_flags_reorth_off_instability_kappa_1000():
    rep = _health_report(1000.0, reorth=False)
    assert not rep.ok
    assert bool(rep.unresolved[0])
    assert rep.last_rel_gap[0] > 1e-8
    assert rep.max_window_rate[0] <= rep.bound * 1.15


def test_health_silent_on_healthy_reorth_runs():
    for kappa in (10.0, 100.0, 1000.0):
        rep = _health_report(kappa, reorth=True)
        assert rep.ok, (kappa, rep)
        assert not rep.slow.any() and not rep.stalled.any() \
            and not rep.unresolved.any()
        assert rep.last_rel_gap[0] <= 1e-8, kappa


def test_health_rate_bound_and_edge_cases():
    assert obs.rate_bound(1.0, 1.0) == 0.0
    k = 100.0
    assert np.isclose(obs.rate_bound(1.0 / k, 1.0),
                      ((np.sqrt(k) - 1) / (np.sqrt(k) + 1)) ** 2)
    assert obs.rate_bound(0.3, 7.0) == robs.rate_bound(0.3, 7.0)
    with pytest.raises(ValueError):
        obs.rate_bound(-1.0, 2.0)
    with pytest.raises(ValueError):
        obs.rate_bound(2.0, 1.0)
    log = obs.ConvergenceLog()
    rep = check_contraction(log, 0.1, 1.0)
    assert rep.ok and rep.fitted_rate.shape == (0,)
    log.record(1.0, 2.0, 1)
    rep = check_contraction(log, 0.1, 1.0, dim=4)
    assert rep.ok


def test_health_resolved_mask_and_stall_flag_equal_the_reference():
    log, rlog = obs.ConvergenceLog(), robs.ConvergenceLog()
    # lane 0 plateaus while live; lane 1 converges geometrically
    for t in range(12):
        args = ([1e-3 * 0.999 ** t, 4.0 * 0.25 ** t],
                [2e-3 * 0.999 ** t, 8.0 * 0.25 ** t], t + 1)
        log.record(*args)
        rlog.record(*args)
    rep = check_contraction(log, 1.0 / 100.0, 1.0, window=4)
    assert bool(rep.stalled[0]) and not bool(rep.stalled[1])
    assert bool(rep.flagged[0]) and not bool(rep.flagged[1])
    want = robs.health.check_contraction(rlog, 1.0 / 100.0, 1.0, window=4)
    for f in ("fitted_rate", "max_window_rate", "last_rel_gap", "slow",
              "stalled", "unresolved", "flagged"):
        np.testing.assert_array_equal(getattr(rep, f), getattr(want, f))
    rep2 = check_contraction(log, 1.0 / 100.0, 1.0, window=4,
                             resolved=[True, False])
    assert rep2.ok


# -- 6. telemetry is bit-invariant -----------------------------------------

@pytest.mark.parametrize("op_kind", ["dense", "coo"])
def test_engine_results_bit_identical_metrics_on_vs_off(op_kind):
    a, us, true, lam = _engine_problem(n=28, kappa=40.0, seed=5, k=7)
    n = a.shape[0]
    op = T.Dense(torch.tensor(a)) if op_kind == "dense" \
        else T.sparse_from_dense(a, device="cpu")
    sv = T.BIFSolver.create(max_iters=n + 2, rtol=1e-4)
    mask = (np.random.default_rng(6).random(n) < 0.5).astype(float)

    def run(metrics_on, mode):
        if metrics_on:
            obs.enable()
            clog = obs.ConvergenceLog()
        else:
            obs.disable()
            clog = None
        try:
            eng = BIFEngine(op, solver=sv, max_batch=4, chunk_iters=3,
                            metrics=metrics_on, convergence_log=clog,
                            **lam)
            for i, u in enumerate(us):
                t = float(true[i] * (0.9 if i % 2 else 1.1)) \
                    if i % 3 else None
                eng.submit(BIFRequest(u=u, t=t,
                                      mask=mask if i == len(us) - 1
                                      else None))
            out = eng.flush(mode=mode)
        finally:
            obs.metrics.set_enabled(True)
            obs.spans.set_enabled(False)
        return eng, out

    for mode in ("continuous", "lockstep"):
        eng_on, on = run(True, mode)
        eng_off, off = run(False, mode)
        for i, (x, y) in enumerate(zip(on, off)):
            assert x.decision == y.decision, (mode, i)
            assert x.certified == y.certified, (mode, i)
            assert x.iterations == y.iterations, (mode, i)
            assert x.resolved == y.resolved, (mode, i)
            assert (x.lower, x.upper) == (y.lower, y.upper), (mode, i)
        assert eng_on.stats()["counters"]["requests.submitted"] == len(us)
        assert eng_off.stats() == {"counters": {}, "gauges": {},
                                   "histograms": {}}
        if mode == "continuous":
            assert eng_on.convergence_log.rounds > 0


def test_solver_paths_bit_identical_with_and_without_log():
    n, kappa = 32, 80.0
    a = make_spd(n, kappa=kappa, seed=7)
    u = torch.tensor(np.random.default_rng(8).standard_normal(n))
    kw = dict(lam_min=1.0 / kappa * 0.999, lam_max=1.001)
    op = T.Dense(torch.tensor(a))
    for reorth in (False, True):
        solver = T.BIFSolver.create(max_iters=n, reorth=reorth)
        t1 = solver.trace(op, u, 12, convergence_log=obs.ConvergenceLog(),
                          **kw)
        t2 = solver.trace(op, u, 12, **kw)
        for f in ("gauss", "radau_lower", "radau_upper", "lobatto"):
            assert torch.equal(getattr(t1, f), getattr(t2, f)), (reorth, f)


# -- 7. the smoke ------------------------------------------------------------

def test_obs_smoke_runs_on_the_cpu(tmp_path):
    """``python -m repro_torch.obs.smoke OUT --device cpu`` in a process of
    its own (its registry check wants drivers that no earlier flush of the
    process met), and its argument check."""
    import os
    import subprocess
    import sys
    from repro_torch.obs import smoke
    src = str(Path(smoke.__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.smoke", str(tmp_path),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("obs smoke OK")
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["traceEvents"]
    stats = json.loads((tmp_path / "metrics.json").read_text())
    assert stats["counters"]["requests.retired"] == 6
    assert smoke.main([str(tmp_path), "--device", "tpu"]) == 2
