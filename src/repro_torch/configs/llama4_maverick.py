"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Scout-17B-16E;
unverified] — MoE 128 experts top-1, shared expert, early fusion."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048, norm="rmsnorm", act="swiglu", rope="rope",
    moe_experts=128, moe_top_k=1, moe_every=2, moe_shared_expert=True,
))
