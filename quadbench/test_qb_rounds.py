"""The decision-round readers (``metrics/rounds_per_call.py``,
``metrics/lane_util_pct.py``, ``rounds.round_host_ms``) on fabricated
counters, answers and spans, with None where the program recorded
nothing; and ``solver_trace.py``'s segments at a small size on the
CPU."""
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from quadbench import harness, rounds, solver_trace

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 4321


@pytest.fixture
def registry(monkeypatch):
    """A fresh global metrics registry, as a process that has run no
    solver holds."""
    from repro_torch.obs import metrics
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "REGISTRY", reg)
    return reg


def _ctx(window, profiled=()):
    def call(its):
        return {"out": {"iterations": torch.tensor(its, dtype=torch.int32)}}
    return SimpleNamespace(window=[call(i) for i in window],
                           profiled=[call(i) for i in profiled])


def _count(reg, rounds_, reads, lane_steps):
    reg.counter("solver.rounds").inc(rounds_)
    reg.counter("solver.reads").inc(reads)
    reg.counter("solver.lane_steps").inc(lane_steps)


def test_rounds_and_lane_util_readers_hand_computed(registry):
    # three host loops (one a call) of 10 rounds, 4 lanes decided every 2
    _count(registry, 30, 33, 3 * 10 * 2 * 4)
    ctx = _ctx([[21, 11, 5, 1], [17, 17, 9, 3]], profiled=[[21, 21, 21, 21]])
    assert harness.reader("rounds_per_call.dense")(ctx) == 10.0
    # used a call: (20 + 10 + 4 + 0 + 16 + 16 + 8 + 2 + 80) / 3 calls = 52;
    # computed a call: 240 / 3 = 80
    assert harness.reader("lane_util_pct.sparse")(ctx) == \
        pytest.approx(100.0 * 52 / 80)


@pytest.mark.parametrize("name", ["rounds_per_call.dense",
                                  "rounds_per_call.sparse",
                                  "lane_util_pct.dense",
                                  "lane_util_pct.sparse"])
def test_round_readers_give_none_where_nothing_was_counted(registry, name):
    ctx = _ctx([[3, 2]])
    assert harness.reader(name)(ctx) is None
    # registered but never counted (metrics off), or no window
    _count(registry, 0, 0, 0)
    assert harness.reader(name)(ctx) is None
    if name.startswith("lane_util"):
        _count(registry, 2, 3, 4)
        assert harness.reader(name)(_ctx([])) is None


def test_round_host_ms_hand_computed():
    def ev(name, dur, parent, tid=1):
        return {"name": name, "dur": dur, "tid": tid,
                "args": {"parent": parent}}
    events = [ev("solver.init", 50.0, "solver.solve"),
              ev("solver.read", 40.0, "solver.solve"),
              ev("solver.read", 300.0, "solver.round"),
              ev("solver.round", 1300.0, "solver.solve"),
              ev("solver.read", 7.0, "solver.round", tid=2),
              ev("solver.round", 500.0, "solver.solve"),   # no read
              ev("solver.round", 10.0, "solver.solve", tid=2),
              ev("solver.solve", 9000.0, None)]
    # (1300 - 300), 500 and (10 - 7) microseconds
    assert rounds.round_host_ms(events) == pytest.approx(1503.0 / 3 / 1e3)
    assert rounds.round_host_ms(events[:3]) is None
    assert rounds.round_host_ms([]) is None


def test_span_twins_leave_busy_and_idle_gaps_unchanged():
    from quadbench import devtrace
    ops = [(10, 20, "fused_tail_kernel"), (40, 55, "dmma_matvec_kernel")]
    host = [(0, 100, "solver.solve"), (20, 40, "solver.round"),
            (30, 40, "solver.read"), (55, 90, "aten::where")]
    plain = devtrace.DeviceTrace(ops, host, (0, 100))
    # each span's device-side twin: a whole call and a round
    twinned = devtrace.DeviceTrace(
        ops + [(0, 100, "solver.solve"), (20, 40, "solver.round")], host,
        (0, 100))
    assert twinned.busy_s == pytest.approx(1e-7)   # the twin fills it all
    got = solver_trace.without_twins(twinned)
    assert got.busy_s == plain.busy_s == pytest.approx(25e-9)
    assert got.idle_gaps() == plain.idle_gaps() == pytest.approx(
        {"solver.solve": 10e-9, "solver.read": 20e-9, "aten::where": 45e-9})


def test_solver_trace_segments_on_the_cpu():
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = solver_trace.measure(
        ROOT, "rbf-gp-variance", SEED, 2, torch.device("cpu"),
        overrides={"config": {"n": 300}, "traffic": {"lanes": 8}})
    assert out["correct"], out["checks"]
    segs = out["segments"]
    assert list(segs) == list(solver_trace.SEGMENTS)
    # made in turns on the same inputs: the same rounds and lane use
    for k in ("counters", "lane_util_pct"):
        assert segs["untraced"][k] == segs["spans_only"][k]
    assert out["spans_cost_pct"] > -100
    for name, s in segs.items():
        # decided every step: a call's rounds are its slowest lane's steps
        assert 1 <= s["rounds_per_call"] <= 159, name
        assert 0 < s["lane_util_pct"] <= 100, name
        assert rounds.loops(s["counters"]) == 2, name   # one a call
        assert ("round_host_ms" in s) == ("spans" in name)
    assert segs["spans_only"]["round_host_ms"] > 0
    assert segs["host_spans"]["idle_gaps"]
    assert segs["host_spans"]["unnamed_s"] >= 0
    assert time.perf_counter() - t0 < 120
