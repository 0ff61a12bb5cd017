"""olmo-1b [arXiv:2402.00838; hf] — dense, non-parametric LayerNorm."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, norm="layernorm_np", act="swiglu", rope="rope",
    tie_embeddings=True,
))
