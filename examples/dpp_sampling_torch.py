"""DPP / k-DPP sampling with retrospective quadrature (paper Sec. 5.1),
on the PyTorch/CUDA port: the twin of examples/dpp_sampling.py.

Builds an RBF kernel over a point cloud, runs both chains with the
GQL-accelerated judge (backend 'pallas': the recurrence in kernel K1 on
the card) and with exact dense solves, from the same draws, and shows:
identical trajectories, far less work.

    PYTHONPATH=src python examples/dpp_sampling_torch.py               # GPU
    PYTHONPATH=src python examples/dpp_sampling_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import BIFSolver, Dense, sample_dpp, sample_kdpp
from repro_torch.core.dpp import dpp_draws, kdpp_draws
from repro_torch.data import density, rbf_kernel

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
device = torch.device(parser.parse_args().device)
if device.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

N = 500
# hard-truncated RBF kernels can lose PSD-ness; the paper adds a ridge to
# "ensure positive definiteness" (Table 1): size it to cover truncation
K = rbf_kernel(N, sigma=0.5, seed=0, ridge=0.05)
w = np.linalg.eigvalsh(K)
assert w[0] > 0, "kernel must be positive definite"
print(f"kernel: N={N}, density={density(K):.3f}, "
      f"kappa={w[-1]/w[0]:.1f}, device={device}")

op = Dense(torch.as_tensor(K, device=device))
lmn, lmx = float(w[0] * 0.9), float(w[-1] * 1.1)
init = torch.as_tensor(np.random.default_rng(0).random(N) < 1 / 3,
                       dtype=torch.float32, device=device)
steps = 300

# The chains thread one quadrature policy through every MH decision.
solver = BIFSolver.create(max_iters=N + 2, backend="pallas")


def timed(fn):
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


for name, fn, draw in (("DPP", sample_dpp, dpp_draws),
                       ("k-DPP", sample_kdpp, kdpp_draws)):
    # one table of draws (host generator, seed 0) drives both chains
    draws = draw(torch.Generator().manual_seed(0), N, steps)
    fn(op, draws, init, 4, lmn, lmx, max_iters=N + 2, solver=solver)  # warm
    st_q, t_q = timed(lambda: fn(op, draws, init, steps, lmn, lmx,
                                 max_iters=N + 2, solver=solver))
    st_e, t_e = timed(lambda: fn(op, draws, init, steps, lmn, lmx,
                                 max_iters=N + 2, exact=True))
    same = bool(torch.equal(st_q.mask, st_e.mask))
    print(f"{name}: {steps} steps | quadrature {t_q:.2f}s vs exact "
          f"{t_e:.2f}s -> {t_e/t_q:.1f}x speedup | identical chains: "
          f"{same} | avg GQL iters/step: "
          f"{int(st_q.stats.quad_iterations)/steps:.1f} (N={N}) | "
          f"uncertified: {int(st_q.stats.uncertified)}")
