"""Sensor placement by log-det maximization (paper Sec. 2 'Submodular
optimization, Sensing' + Sec. 5.2) on the PyTorch/CUDA port: retrospective
double greedy on a Gaussian-process covariance over a spatial grid (the
twin of examples/sensor_placement.py).

    PYTHONPATH=src python examples/sensor_placement_torch.py         # GPU
    PYTHONPATH=src python examples/sensor_placement_torch.py --device cpu

The per-item uniforms come from a seeded torch.Generator (the reference
draws them from jax.random.key(0)), so the placement can differ from the
reference's; the same checks hold: every decision certified, and a log
det well above random placements'.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Dense, run_double_greedy

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
device = torch.device(parser.parse_args().device)
if device.type == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

# GP covariance on a 2-D grid of candidate sensor sites
G = 18
xs, ys = np.meshgrid(np.linspace(0, 1, G), np.linspace(0, 1, G))
pts = np.stack([xs.ravel(), ys.ravel()], 1)
N = len(pts)
d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
# Joint-entropy objective H(X_S) = log det(K_S) + const*|S| (Sec. 2):
# the per-sensor noise floor enters as the kernel scale, so each
# informative (non-redundant) site contributes ~log(scale) > 0.
K = 1.5 * (np.exp(-d2 / (2 * 0.08 ** 2)) + 1e-2 * np.eye(N))
w = np.linalg.eigvalsh(K)

op = Dense(torch.as_tensor(K, device=device))
res = run_double_greedy(op, torch.Generator().manual_seed(0),
                        float(w[0] * 0.9), float(w[-1] * 1.1),
                        max_iters=N + 2)
sel = res.selected.cpu().numpy() > 0.5
print(f"candidates: {N} grid sites | selected: {sel.sum()} sensors "
      f"(device={device})")
print(f"joint entropy (log det): {float(res.log_det):.2f}")
print(f"quadrature iterations total: {int(res.quad_iterations)} "
      f"(avg {int(res.quad_iterations)/N:.1f}/site vs N={N} for exact)")
print(f"uncertified decisions: {int(res.uncertified)}")

rng = np.random.default_rng(0)
rand_vals = []
for _ in range(20):
    idx = rng.choice(N, int(sel.sum()), replace=False)
    rand_vals.append(np.linalg.slogdet(K[np.ix_(idx, idx)])[1])
print(f"random-placement log det (mean of 20): {np.mean(rand_vals):.2f} "
      f"(double greedy is +{float(res.log_det)-np.mean(rand_vals):.1f})")

# ASCII map of the placement
grid = sel.reshape(G, G)
print("\nplacement (#=sensor):")
for r in range(G):
    print("".join("#" if grid[r, c] else "." for c in range(G)))
