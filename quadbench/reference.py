"""The plain reference: what each call's answers should be, worked out from
the inputs the benchmark handed the program, with dense factorisations in
PyTorch. It imports nothing of the program and takes nothing the program
made; it rebuilds every operator from the raw inputs (the points, the
graph's adjacency, the quality vector).

Every function takes the type to compute in; the truths are float64.
"""
from __future__ import annotations

import torch


def rbf_kernel(x, y, cfg, dtype) -> torch.Tensor:
    """The truncated Gaussian kernel between two point sets, row block by
    row block."""
    x, y = x.to(dtype), y.to(dtype)
    rows = []
    for s in range(0, x.shape[0], 512):
        diff = x[s:s + 512, None, :] - y[None, :, :]
        d = torch.sqrt((diff * diff).sum(-1))
        k = torch.exp(-(d * d) / (2.0 * cfg["sigma"] ** 2))
        rows.append(torch.where(d > cfg["cutoff"] * cfg["sigma"],
                                torch.zeros_like(k), k))
    return torch.cat(rows)


def rbf_operator(points, cfg, dtype) -> torch.Tensor:
    """K(X, X) with its unit diagonal, plus the ridge."""
    k = rbf_kernel(points, points, cfg, dtype)
    idx = torch.arange(k.shape[0], device=k.device)
    k[idx, idx] = 1.0 + cfg["ridge"]
    return k


def laplacian_operator(adjacency, cfg, dtype) -> torch.Tensor:
    """The graph Laplacian plus the ridge, with each entry rounded to the
    type the configuration stores the blocks in, as the table holds it."""
    deg = adjacency.sum(1)
    lap = -adjacency.clone()
    idx = torch.arange(lap.shape[0], device=lap.device)
    lap[idx, idx] = deg + cfg["ridge"]
    stored = {"float32": torch.float32, "float64": torch.float64}[
        cfg["block_dtype"]]
    return lap.to(stored).to(dtype)
