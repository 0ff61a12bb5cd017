"""Kernel-matrix builders mirroring the paper's Table 1 data regimes.

A numpy-only copy of ``repro.data.kernel_matrices`` (``rbf_kernel``,
``graph_laplacian``, ``random_sparse_spd``), seeded exactly as there, so
that the port builds the same matrices without importing the JAX
package. They return numpy arrays: the caller puts them on a device.

  * ``rbf_kernel``      -- RBF with a hard cutoff at 3*sigma (Abalone/Wine
                           regime: geometric point clouds)
  * ``graph_laplacian`` -- Watts-Strogatz-style sparse graphs (GR/HEP/
                           Epinions/Slashdot regime)

All kernels get ``+ ridge * I`` as the paper does.
"""
from __future__ import annotations

import numpy as np


def rbf_kernel(n: int, dim: int = 4, sigma: float = 0.5, cutoff: float = 3.0,
               ridge: float = 1e-3, seed: int = 0) -> np.ndarray:
    """Point cloud scaled so the 3-sigma cutoff keeps only local
    neighborhoods (matching the ~1-10% densities of paper Table 1)."""
    rng = np.random.default_rng(seed)
    box = (n ** (1.0 / dim)) * sigma * 1.2
    pts = rng.random((n, dim)).astype(np.float64) * box
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    k = np.exp(-d2 / (2 * sigma ** 2))
    k[np.sqrt(d2) > cutoff * sigma] = 0.0
    np.fill_diagonal(k, 1.0)
    return k + ridge * np.eye(n)


def graph_laplacian(n: int, mean_degree: int = 12, rewire: float = 0.1,
                    ridge: float = 1e-3, seed: int = 0) -> np.ndarray:
    """Watts-Strogatz ring lattice + rewiring; returns L + ridge*I."""
    rng = np.random.default_rng(seed)
    half = max(mean_degree // 2, 1)
    a = np.zeros((n, n), np.float64)
    for k in range(1, half + 1):
        idx = np.arange(n)
        a[idx, (idx + k) % n] = 1.0
    mask = rng.random(a.shape) < rewire
    rw = np.argwhere((a > 0) & mask)
    for i, j in rw:
        a[i, j] = 0.0
        t = rng.integers(0, n)
        if t != i:
            a[i, t] = 1.0
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    lap = np.diag(a.sum(1)) - a
    return lap + ridge * np.eye(n)


def random_sparse_spd(n: int, density: float, lam_min: float = 1e-2,
                      seed: int = 0) -> np.ndarray:
    """Paper Sec. 4.4 generator: sparse symmetric + diagonal shift."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) * (rng.random((n, n)) < density)
    a = (m + m.T) / 2
    w = np.linalg.eigvalsh(a)
    return a + np.eye(n) * (lam_min - w[0])


def density(a: np.ndarray) -> float:
    return float((a != 0).sum()) / a.size
