"""whisper-medium [arXiv:2212.04356; unverified] — enc-dec; the conv/audio
frontend is a STUB per assignment (input_specs provides frame embeddings)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=51865, norm="layernorm", act="gelu",
    rope="none", use_bias=True,
))
