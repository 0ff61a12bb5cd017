"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf] — 128 experts
top-2 with a parallel dense residual MLP."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000, norm="rmsnorm", act="swiglu", rope="rope",
    moe_experts=128, moe_top_k=2, moe_every=1, moe_dense_residual=True,
))
