"""llama3-405b [arXiv:2407.21783; unverified] — dense GQA, 128k vocab."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab=128256, norm="rmsnorm", act="swiglu", rope="rope",
    rope_theta=5e5,
))
