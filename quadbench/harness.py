"""One run of one cell: set-up, the measured window, the traced segment,
the judgement against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own under this folder, found by the name that
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``workloads/<traffic>.json`` and ``metrics/<metric>.py``. A measure split
by the cells it is read in (``idle_pct.dense``, ``idle_pct.sparse``) has
one reader, ``metrics/<measure>.py``, named by the part before the first
dot.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import devtrace, problems, traffic as traffic_mod

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def entry(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell_files(root: Path, man: dict, workload: str) -> tuple:
    """The cell's entry, its configuration and its traffic mix."""
    cell = entry(man["workloads"], workload, "workload")
    conf = entry(man["configs"], cell["config"], "config")
    cfg = load_json(root / conf["file"])
    mix = load_json(HERE / "workloads" / f"{cell['traffic']}.json")
    return cell, cfg, mix


def metrics_for(man: dict, workload: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``. A metric
    without ``workloads`` belongs to every cell that reports the metric
    it moves (end-to-end: to every cell)."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if workload in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or else the measure's ``metrics/<measure>.py``
    (``<measure>`` the part of ``name`` before its first dot)."""
    path = HERE / "metrics" / f"{name}.py"
    return path if path.exists() else \
        HERE / "metrics" / f"{name.split('.')[0]}.py"


def reader(name: str):
    """The reader of metric ``name``: its file's ``read``."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        f"quadbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``repro_torch``, the port, is not ``repro``)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_calls(kind, dev, first: int, *, deadline=None, count=None) -> list:
    """Closed loop, one caller: draw a call's inputs, wait for them, then
    time the call to its answers on the host. Calls started before the
    deadline run to their end."""
    calls, i = [], first
    while (count is None or len(calls) < count) and (
            deadline is None or time.perf_counter() < deadline):
        inputs = kind.draw(i)
        sync(dev)
        t0 = time.perf_counter()
        out = kind.call(inputs)
        t1 = time.perf_counter()
        calls.append(dict(index=i, t0=t0, t1=t1, out=out))
        i += 1
    return calls


def judge(kind, calls, limits: dict, *, control: bool = False) -> tuple:
    """The numbers compared, each beside its limit, over ``calls``.
    Returns (correct, checks, control checks or None): with ``control``,
    the same calls made again on the program's own float32 path, one
    precision below the configuration's, and judged alike."""
    def draws():   # drawn again, one call's inputs at a time
        return (kind.draw(c["index"]) for c in calls)

    truths = kind.truths(draws(), torch.float64)
    numbers = kind.numbers([c["out"] for c in calls], truths)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    ctl = None
    if control:
        low = traffic_mod.make(kind.cfg, kind.traffic, kind.problem,
                               kind.seed, kind.dev, torch.float32)
        outs = [low.call(x) for x in draws()]
        ctl = {k: {"value": v, "limit": limits[k]}
               for k, v in kind.numbers(outs, truths).items()}
    return correct, checks, ctl


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, dev, *, t_start: float, overrides=None,
             max_calls=None, control: bool = False) -> dict:
    """One run of ``workload``; returns the result line's object (and,
    under ``"control"``, the control's numbers where asked)."""
    man = manifest(root)
    cell, cfg, mix = cell_files(root, man, workload)
    for part, over in (overrides or {}).items():
        {"config": cfg, "traffic": mix}[part].update(over)
    parts = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.empty(1, device=dev)
    parts["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    problem = problems.build(cfg, dev)
    sync(dev)
    parts["problem"] = time.perf_counter() - t
    parts["interval"] = problem["interval_s"]
    kind = traffic_mod.make(cfg, mix, problem, seed, dev)
    t = time.perf_counter()
    # the warm-up: one call of the cell's own shapes, on its own inputs
    run_calls(kind, dev, -1, count=1)
    parts["warm_call"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    from repro_torch.kernels import LAUNCHES
    profiled, hosted, dtrace, htrace, launches = [], [], None, None, {}
    if trace:
        # the device alone: busy and idle shares, kernel times
        before = dict(LAUNCHES)
        with devtrace.profiled(host=False) as prof:
            profiled = run_calls(kind, dev, 10 ** 6,
                                 count=mix["profile_calls"])
        dtrace = prof["trace"]
        launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        # the host's operators too: what the host did in each idle gap
        with devtrace.profiled(host=True) as prof:
            hosted = run_calls(kind, dev, 2 * 10 ** 6,
                               count=mix["profile_calls"])
        htrace = prof["trace"]
    w0 = time.perf_counter()
    window = run_calls(kind, dev, 0, deadline=w0 + seconds,
                       count=max_calls)
    w1 = window[-1]["t1"] if window else w0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0

    calls = profiled + hosted + window
    correct, checks, ctl = judge(kind, calls, mix["limits"],
                                 control=control)
    # what the metric readers read
    ctx = SimpleNamespace(cell=cell, cfg=cfg, traffic=mix, kind=kind,
                          problem=problem, window=window, window_start=w0,
                          window_end=w1, setup_s=setup_s, profiled=profiled,
                          trace=dtrace, launches=launches)
    metrics = {}
    for m in metrics_for(man, workload, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = failed = 0
    for c in calls:
        a, ok = kind.units(c["out"])
        attempted, failed = attempted + a, failed + a - ok
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else dev.type,
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device}
    if dtrace is not None:
        device.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        out["breakdown"] = {"device_ops": dtrace.breakdown()["device_ops"],
                            "idle_gaps": htrace.breakdown()["idle_gaps"]}
        # what recording the host's operators costs a host-paced loop
        out["traced"] = {
            name: {"idle_pct": 100.0 * (1.0 - t.busy_s / t.window_s),
                   "ms_per_call": 1e3 * t.window_s / len(c)}
            for name, t, c in (("device_only", dtrace, profiled),
                               ("with_host", htrace, hosted))}
        out["traced"]["untraced_ms_per_call"] = 1e3 * (w1 - w0) / max(
            len(window), 1)
    out["setup_parts"] = parts
    out["calls"] = len(window)
    if dev.type == "cuda":
        out["card"] = power_limit()
    if ctl is not None:
        out["control"] = ctl
    out["checks"] = checks
    return out


def finite(x):
    """JSON has no infinity: an unbounded reading prints as 1e308."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308 if x > 0 else -1e308
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def report(out: dict) -> None:
    """The numbers compared, beside their limits, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr, flush=True)
    print(json.dumps(finite(out)), flush=True)
