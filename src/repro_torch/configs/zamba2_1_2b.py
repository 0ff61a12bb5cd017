"""zamba2-1.2b [arXiv:2411.15242; hf] — Mamba2 backbone with a single
parameter-shared attention block applied periodically."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, norm="rmsnorm", act="gelu", rope="rope",
    ssm_state=64, ssm_variant="mamba2", ssm_expand=2, ssm_conv=4,
    ssm_heads=32, hybrid_attn_every=6,
    attn_window=8192,  # for long_500k: windowed shared-attention block
))
