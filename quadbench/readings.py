"""The readings that the limits of ``correct`` are set from, on the card.

    python3 quadbench/readings.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds <s>

For each seed, in one process: the cell's set-up, a window of ``--seconds``
at the cell's own load, and the judgement of its calls against the plain
reference, printing each number compared (the program's reading); for
each control seed also the same calls made again on the program's own
float32 path and judged alike (the control's reading). One JSON line a
seed, then a summary line: the largest reading of the program and the
smallest of the control for each number. Not part of a benchmark run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from quadbench import harness
    if not torch.cuda.is_available():
        print("quadbench: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    worst, least = {}, {}
    for s in [int(x) for x in args.seeds.split(",")]:
        t0 = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, s, args.seconds, False,
                               torch.device("cuda", 0), t_start=t0,
                               control=s in ctl_seeds)
        line = {"seed": s, "correct": out["correct"],
                "calls": out["calls"], "failed": out["failed"],
                "attempted": out["attempted"], "checks": out["checks"],
                "control": out.get("control"),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(harness.finite(line)), flush=True)
        for k, c in out["checks"].items():
            worst[k] = max(worst.get(k, 0.0), c["value"])
        for k, c in (out.get("control") or {}).items():
            least[k] = min(least.get(k, float("inf")), c["value"])
    print(json.dumps(harness.finite({"workload": args.workload,
                                     "program_largest": worst,
                                     "control_smallest": least})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
