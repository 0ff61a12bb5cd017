"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352, norm="layernorm", act="swiglu", rope="rope",
))
