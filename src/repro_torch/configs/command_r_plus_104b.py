"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified] —
dense GQA, no biases, 256k vocab."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000, norm="layernorm", act="swiglu", rope="rope",
    use_bias=False,
))
