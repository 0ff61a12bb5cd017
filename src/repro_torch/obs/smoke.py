"""Smoke test of the observability layer (counterpart of
``repro.obs.smoke``): run a tiny engine workload with metrics + spans on,
dump the Chrome trace and metrics snapshot, and validate both against
the contracts CI relies on.

Run as ``PYTHONPATH=src python -m repro_torch.obs.smoke [outdir]
[--device cuda|cpu]`` (the card by default). Exits non-zero (with a
message on stderr) on any violated contract:

* the dumped trace document must validate against
  ``obs/trace_schema.json`` (via the stdlib validator in
  ``obs.schema``);
* ``obs.registry.retrace_counts()`` must be non-empty after a flush:
  the engine's drivers met at least one signature;
* the engine ``stats()`` snapshot must carry the request counters and
  the percentile fields of the latency histogram.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def run(outdir: Path, device="cuda") -> dict:
    import numpy as np
    import torch

    from .. import obs
    from . import schema as obs_schema
    from ..core import Dense
    from ..core.operators import resolve_device
    from ..serve import BIFEngine, BIFRequest

    dev = resolve_device(device)
    obs.spans.reset()
    obs.spans.set_enabled(True)
    obs.registry.reset()

    n = 16
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.geomspace(1.0, 50.0, n)
    a = (q * lam) @ q.T
    a = 0.5 * (a + a.T)

    log = obs.ConvergenceLog()
    engine = BIFEngine(Dense(torch.tensor(a, device=dev)), max_batch=4,
                       chunk_iters=4, lam_min=0.99, lam_max=50.5,
                       convergence_log=log)
    us = rng.standard_normal((6, n))
    true = np.einsum("ki,ki->k", us, np.linalg.solve(a, us.T).T)
    for i, u in enumerate(us):
        t = float(true[i] * (0.8 if i % 2 else 1.2)) if i % 3 else None
        engine.submit(BIFRequest(u=u, t=t))
    done = engine.flush()

    outdir.mkdir(parents=True, exist_ok=True)
    trace_path = outdir / "trace.json"
    doc = obs.dump_trace(trace_path)
    stats = engine.stats()
    (outdir / "metrics.json").write_text(
        json.dumps(stats, indent=2, sort_keys=True), encoding="utf-8")

    schema = json.loads(
        (Path(__file__).parent / "trace_schema.json").read_text(
            encoding="utf-8"))
    obs_schema.validate(doc, schema)
    if not doc["traceEvents"]:
        raise AssertionError("trace has no events despite enabled spans")

    retraces = obs.retrace_counts()
    if not retraces:
        raise AssertionError("retrace_counts() empty after an engine flush")

    counters = stats["counters"]
    if counters.get("requests.submitted") != len(us):
        raise AssertionError(f"submitted counter wrong: {counters}")
    if counters.get("requests.retired") != len(us):
        raise AssertionError(f"retired counter wrong: {counters}")
    lat = stats["histograms"]["request.latency_s"]
    for field in ("count", "p50", "p90", "p99"):
        if field not in lat:
            raise AssertionError(f"latency histogram missing {field!r}")
    if not all(r.resolved for r in done):
        raise AssertionError("smoke workload should fully resolve")
    if log.rounds == 0:
        raise AssertionError("convergence log recorded no rounds")

    return {"events": len(doc["traceEvents"]), "retraces": retraces,
            "counters": counters, "rounds": log.rounds,
            "device": str(dev), "out": str(outdir)}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        if i + 1 >= len(args) or args[i + 1] not in ("cuda", "cpu"):
            print("obs smoke: --device takes cuda or cpu", file=sys.stderr)
            return 2
        device = args[i + 1]
        del args[i:i + 2]
    outdir = Path(args[0]) if args else Path("obs_smoke_out")
    try:
        summary = run(outdir, device)
    except Exception as e:  # noqa: BLE001 - CI wants one-line verdicts
        print(f"obs smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print("obs smoke OK: "
          f"{summary['events']} span events, retraces={summary['retraces']}, "
          f"counters={summary['counters']}, "
          f"convergence rounds={summary['rounds']} on {summary['device']} "
          f"-> {summary['out']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
