"""falcon-mamba-7b [arXiv:2410.05355; unverified] — pure Mamba1, no attn."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=65024, norm="rmsnorm", act="swiglu", rope="none",
    ssm_state=16, ssm_variant="mamba1", ssm_expand=2, ssm_conv=4,
))
