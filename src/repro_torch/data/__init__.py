"""Data: numpy matrix builders, the synthetic token stream and the DPP
batch selector (counterpart of ``repro.data``)."""
from .dpp_selection import DPPBatchStream, DPPSelector  # noqa: F401
from .kernel_matrices import density, graph_laplacian, random_sparse_spd, \
    rbf_kernel  # noqa: F401
from .synthetic import DataConfig, TokenStream, sequence_embeddings  # noqa
