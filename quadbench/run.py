"""Run one cell of the benchmark once, on the card, and print its result.

    python3 quadbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``quadbench/``
and the program, ``src/repro_torch``. The last line of standard output is
the result (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with the plain reference beside its limit); the
last lines of standard error repeat the checks. Without a CUDA card, or
with fewer cards than the cell asks for, it exits non-zero and prints no
result. Build and kernel caches stay inside the checkout, under
``build/``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches of the program and its libraries at fixed paths in the
    # checkout, so that only a checkout's first run builds
    cache = ROOT / "build" / "quadbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from quadbench import harness

    man = harness.manifest(ROOT)
    cell = harness.entry(man["workloads"], args.workload, "workload")
    if not torch.cuda.is_available():
        print("quadbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"quadbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    import repro_torch  # noqa: F401  (the program's import is set-up)
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           t_start=T_START)
    # the window has closed: the process must hold no JAX
    bad = harness.forbidden_modules()
    if bad:
        print(f"quadbench: the run loaded {bad}; the port must not load "
              f"JAX or the JAX package", file=sys.stderr)
        return 4
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
