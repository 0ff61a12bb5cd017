"""Synthetic data builders (numpy only; the caller picks the device)."""
from .kernel_matrices import density, graph_laplacian, random_sparse_spd, \
    rbf_kernel  # noqa: F401
