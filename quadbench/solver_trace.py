"""The solver's decision rounds seen from inside, on the card: the
segments with the program's spans on, which a traced run of ``run.py``
does not make.

    python3 quadbench/solver_trace.py --workload <name> --seed <n> \
        --calls <k>

One process: the cell's set-up and warm call, as ``run.py`` makes them,
then four segments of ``--calls`` calls each:

  untraced    spans off, no profiler
  spans_only  spans on, no profiler: each round's host time
              (``round_host_ms``); made in turns with ``untraced``, a
              call of each on the same inputs, the one first and then the
              other, so that a drift of the host's speed falls on both
              alike (``spans_cost_pct``: 100 x their ratio of ms a call,
              less 100)
  host        the host's operators recorded, spans off: ``run.py``'s
              second traced segment
  host_spans  the same with spans on: the profiler stamps each span on
              its own clock, so the idle gaps are put under the solver's
              spans (``unnamed_s``: idle seconds with no host event open,
              which then lie outside ``solver.solve``)

Each segment gives its rounds a call and lane use from the ``solver.*``
counters read around its calls. Every call is judged against the plain
reference. Prints one JSON line (``correct``, ``checks``, the device,
and each segment's numbers). Not part of a benchmark run.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEGMENTS = ("untraced", "spans_only", "host", "host_spans")


def _numbers(calls: list, c: dict) -> dict:
    """A segment's numbers from its calls and its counters' deltas."""
    from quadbench import rounds
    used, _ = rounds.used_steps(calls)
    return {"rounds_per_call": rounds.rounds_per_call(c, len(calls)),
            "lane_util_pct": rounds.lane_util_pct(used, c["lane_steps"]),
            "counters": c}


def _spans_numbers(out: dict) -> None:
    """Add the recorded spans' count and ``round_host_ms`` to ``out``, and
    clear them."""
    from repro_torch import obs

    from quadbench import rounds
    events = obs.trace_events()
    out.update(round_host_ms=rounds.round_host_ms(events),
               spans=len(events))
    obs.spans.reset()


def _turns(kind, dev, first: int, count: int) -> dict:
    """The untraced and spans-only segments, a call of each in turn on
    the same inputs; each one's ms a call is the mean of its calls'."""
    from repro_torch import obs

    from quadbench import harness, rounds
    calls = {"untraced": [], "spans_only": []}
    counts = {k: dict.fromkeys(rounds.COUNTERS, 0) for k in calls}
    obs.spans.reset()
    try:
        for i in range(count):
            for name in list(calls)[::1 if i % 2 == 0 else -1]:
                obs.spans.set_enabled(name == "spans_only")
                before = rounds.counters()
                calls[name] += harness.run_calls(kind, dev, first + i,
                                                 count=1)
                obs.spans.set_enabled(False)
                for k, v in rounds.delta(before, rounds.counters()).items():
                    counts[name][k] += v
    finally:
        obs.spans.set_enabled(False)
    out = {}
    for name, cs in calls.items():
        ms = 1e3 * sum(c["t1"] - c["t0"] for c in cs) / len(cs)
        out[name] = dict(calls=cs, ms_per_call=ms,
                         **_numbers(cs, counts[name]))
    _spans_numbers(out["spans_only"])
    return out


def _profiled(kind, dev, first: int, count: int, spans: bool) -> dict:
    """A segment under the host profiler, with the program's spans on or
    off."""
    from repro_torch import obs

    from quadbench import devtrace, harness, rounds
    obs.spans.reset()
    obs.spans.set_enabled(spans)
    before = rounds.counters()
    try:
        with devtrace.profiled(host=True) as prof:
            calls = harness.run_calls(kind, dev, first, count=count)
    finally:
        obs.spans.set_enabled(False)
    out = dict(calls=calls, **_numbers(
        calls, rounds.delta(before, rounds.counters())))
    if spans:
        _spans_numbers(out)
    t = without_twins(prof["trace"])
    # inside the profiler's window, as run.py's traced segments: the
    # profiler's start and its reading of the events lie outside it
    out.update(ms_per_call=1e3 * t.window_s / len(calls),
               idle_pct=100.0 * (1.0 - t.busy_s / t.window_s),
               idle_gaps=t.breakdown()["idle_gaps"],
               unnamed_s=t.idle_gaps().get("host, no event", 0.0))
    obs.spans.reset()
    return out


SPANS = ("solver.solve", "solver.init", "solver.round", "solver.read",
         "solver.finalize")


def without_twins(t):
    """``t`` less the device-side twins of the solver's spans: the
    profiler keeps each ``record_function`` range on the device's
    timeline too (a user annotation), and a ``solver.solve`` twin would
    count a whole call as busy."""
    from quadbench import devtrace
    return devtrace.DeviceTrace([o for o in t.ops if o[2] not in SPANS],
                                t.host, t.window)


def measure(root: Path, workload: str, seed: int, count: int, dev, *,
            overrides=None) -> dict:
    """The cell's set-up, its warm call and the four segments; every
    call judged."""
    import torch

    from quadbench import harness, problems, traffic as traffic_mod
    man = harness.manifest(root)
    cell, cfg, mix = harness.cell_files(root, man, workload)
    for part, over in (overrides or {}).items():
        {"config": cfg, "traffic": mix}[part].update(over)
    problem = problems.build(cfg, dev)
    kind = traffic_mod.make(cfg, mix, problem, seed, dev)
    harness.run_calls(kind, dev, -1, count=1)
    segs = _turns(kind, dev, 0, count)
    segs["host"] = _profiled(kind, dev, 10 ** 6, count, spans=False)
    segs["host_spans"] = _profiled(kind, dev, 2 * 10 ** 6, count, spans=True)
    calls = [c for s in segs.values() for c in s.pop("calls")]
    correct, checks, _ = harness.judge(kind, calls, mix["limits"])
    out = {"workload": workload, "seed": seed, "correct": bool(correct),
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else dev.type,
           "segments": segs, "spans_cost_pct": 100.0 * (
               segs["spans_only"]["ms_per_call"]
               / segs["untraced"]["ms_per_call"] - 1.0),
           "checks": checks}
    if dev.type == "cuda":
        out["card"] = harness.power_limit()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from quadbench import harness
    if not torch.cuda.is_available():
        print("quadbench: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    out = measure(ROOT, args.workload, args.seed, args.calls,
                  torch.device("cuda", 0))
    print(json.dumps(harness.finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
