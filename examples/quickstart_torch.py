"""Quickstart on the PyTorch/CUDA port: certified brackets on a bilinear
inverse form in 30 lines (the twin of examples/quickstart.py).

    PYTHONPATH=src python examples/quickstart_torch.py               # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import BIFSolver, Dense, SolverConfig
from repro_torch.data import random_sparse_spd

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
device = torch.device(parser.parse_args().device)
if device.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

# The paper's Sec. 4.4 setup: 100x100, 10% dense, lambda_min = 1e-2.
N = 100
A = random_sparse_spd(N, density=0.1, lam_min=1e-2, seed=0)
w = np.linalg.eigvalsh(A)
u = np.random.default_rng(0).standard_normal(N)
true = u @ np.linalg.solve(A, u)

op = Dense(torch.as_tensor(A, device=device))
uu = torch.as_tensor(u, device=device)
lmn, lmx = float(w[0] * 0.999), float(w[-1] * 1.001)

# One solver object carries the whole policy: stopping rule, spectrum
# source, preconditioning, and kernel backend.
solver = BIFSolver(SolverConfig(max_iters=N, rtol=1e-3))

# Fig. 1: all four Gauss-type estimates, iteration by iteration.
tr = solver.trace(op, uu, num_iters=30, lam_min=lmn, lam_max=lmx)
print(f"true BIF = {true:.6f}  (device={device})\n")
print("iter   gauss(lo)    radau(lo)    radau(hi)    lobatto(hi)")
for i in [0, 1, 4, 9, 14, 19, 24, 29]:
    print(f"{i+1:4d} {float(tr.gauss[i]):12.4f} "
          f"{float(tr.radau_lower[i]):12.4f} "
          f"{float(tr.radau_upper[i]):12.4f} "
          f"{float(tr.lobatto[i]):12.4f}")

# Adaptive: stop as soon as the bracket is tight enough.
res = solver.solve(op, uu, lam_min=lmn, lam_max=lmx)
print(f"\nadaptive: [{float(res.lower):.5f}, {float(res.upper):.5f}] "
      f"in {int(res.iterations)} iterations (N={N})")

# No eigendecomposition at hand? Let the solver estimate the interval.
auto = solver.replace(spectrum="lanczos").solve(op, uu)
print(f"auto-spectrum: [{float(auto.lower):.5f}, {float(auto.upper):.5f}] "
      f"in {int(auto.iterations)} iterations")

# Retrospective judge: decide `t < u^T A^-1 u` without the exact value.
for t in (true * 0.5, true * 2.0):
    j = solver.judge_threshold(op, uu, t, lam_min=lmn, lam_max=lmx)
    print(f"judge(t={t:9.3f} < BIF) -> {bool(j.decision)} "
          f"(certified={bool(j.certified)}, "
          f"iterations={int(j.iterations)})")
