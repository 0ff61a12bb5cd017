"""Optimizers (counterpart of ``repro.optim``): AdamW, whose update runs
on plain tensors or on DTensors placed over a mesh, and the error-feedback
int8 gradient compression of the data-parallel reduce
(``optim.compression``; like the reference's, not wired into the train
step)."""
from .adamw import AdamW, AdamWState, warmup_cosine  # noqa: F401
from .compression import (compress_tree_psum, compressed_psum,  # noqa: F401
                          dequantize, init_residuals, quantize_int8)
