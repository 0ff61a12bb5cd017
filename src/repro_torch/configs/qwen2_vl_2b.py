"""qwen2-vl-2b [arXiv:2409.12191; hf] — VLM backbone; M-RoPE; vision
frontend is a STUB (input_specs provides patch embeddings)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, norm="rmsnorm", act="swiglu", rope="mrope",
    use_bias=True, vision_tokens=256,
))
