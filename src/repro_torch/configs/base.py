"""Architecture configuration (the port's own copy of
``repro.configs.base``; data only).

``ArchConfig`` captures everything the model zoo needs to build any of
the ten assigned architectures (dense / MoE / SSM / hybrid / enc-dec /
VLM); the figures and their sources are in each ``configs/<arch>.py``.
The port builds the dense family so far (ROADMAP Queue 1).

``reduced()`` derives the family-preserving smoke configuration used by
the per-arch CPU tests (small widths, few experts, tiny vocab, f32).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str = "dense"            # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int = 12
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: Optional[int] = None   # default: d_model // n_heads
    d_ff: int = 2048
    vocab: int = 32000
    norm: str = "rmsnorm"            # rmsnorm | layernorm | layernorm_np
    act: str = "swiglu"              # swiglu | gelu
    rope: str = "rope"               # rope | mrope | none
    rope_theta: float = 1e4
    use_bias: bool = False
    tie_embeddings: bool = False
    attn_window: Optional[int] = None  # sliding-window attention (tokens)
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_every: int = 1               # every k-th block is MoE (1 = all)
    moe_shared_expert: bool = False
    moe_dense_residual: bool = False  # arctic: parallel dense MLP
    moe_capacity_factor: float = 1.25
    # --- SSM ---
    ssm_state: int = 0
    ssm_variant: str = "mamba1"      # mamba1 | mamba2
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0               # mamba2 value heads
    ssm_impl: str = "scan"           # scan | chunked (mamba2 SSD matmuls)
    ssm_chunk: int = 128             # SSD chunk length Q
    hybrid_attn_every: int = 0       # zamba: shared attn block every k
    # --- encoder-decoder ---
    enc_layers: int = 0              # >0 => enc-dec (whisper)
    # --- multimodal stub ---
    vision_tokens: int = 0           # qwen2-vl: patch-embedding slots
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: str = "block"             # none | block
    logits_chunk: int = 1024         # chunked CE to avoid (B,T,V) logits
    attn_impl: str = "auto"          # full | chunked | auto
    attn_chunk: int = 512            # query-block size for chunked attn
    scan_unroll: bool = False        # unroll all scans (dry-run analysis
    #                                  only: makes XLA cost_analysis count
    #                                  loop bodies exactly; see dryrun.py)
    decode_constrain_kv: bool = False  # pin seq-sharded KV math in decode
    #                                   (hillclimb knob; EXPERIMENTS Perf)

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid-with-window)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS = 6*N*D)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb

        def attn_params():
            return d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d

        def mlp_params(width):
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * width

        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn_params() + mlp_params(ff))
        elif self.family == "moe":
            n_moe = len([i for i in range(self.n_layers)
                         if (i + 1) % self.moe_every == 0])
            n_dense = self.n_layers - n_moe
            per_moe = self.moe_experts * mlp_params(ff)
            if self.moe_shared_expert:
                per_moe += mlp_params(ff)
            if self.moe_dense_residual:
                per_moe += mlp_params(ff)
            total += self.n_layers * attn_params() \
                + n_moe * per_moe + n_dense * mlp_params(ff)
            total += n_moe * d * self.moe_experts  # router
        elif self.family in ("ssm", "hybrid"):
            di = self.ssm_expand * d
            per_ssm = 2 * d * di + di * d + di * self.ssm_conv \
                + 2 * di * self.ssm_state + di  # in/out proj, conv, B/C, dt
            if self.family == "ssm":
                total += self.n_layers * per_ssm
            else:
                total += self.n_layers * per_ssm
                # one shared attention+MLP block (parameters reused)
                total += attn_params() + mlp_params(ff)
        elif self.family == "encdec":
            # encoder: self-attn + mlp; decoder: self + cross + mlp
            total += self.enc_layers * (attn_params() + mlp_params(ff))
            total += self.n_layers * (2 * attn_params() + mlp_params(ff))
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k of experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff

        def attn_params():
            hd = self.head_dim_
            return d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d

        def mlp_params(width):
            mult = 3 if self.act == "swiglu" else 2
            return mult * d * width

        n_moe = len([i for i in range(self.n_layers)
                     if (i + 1) % self.moe_every == 0])
        n_dense = self.n_layers - n_moe
        per_moe_active = self.moe_top_k * mlp_params(ff)
        if self.moe_shared_expert:
            per_moe_active += mlp_params(ff)
        if self.moe_dense_residual:
            per_moe_active += mlp_params(ff)
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        total += self.n_layers * attn_params() + n_moe * per_moe_active \
            + n_dense * mlp_params(ff) + n_moe * d * self.moe_experts
        return total

    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke config: runs a CPU step in <seconds."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.hybrid_attn_every else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, int(4 * self.n_kv_heads
                                         / max(self.n_heads, 1)))),
            head_dim=16,
            d_ff=128,
            vocab=256,
            moe_experts=min(self.moe_experts, 4),
            moe_capacity_factor=8.0,  # effectively dropless at smoke scale
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            enc_layers=min(self.enc_layers, 2),
            vision_tokens=min(self.vision_tokens, 8),
            logits_chunk=64,
            attn_chunk=16,
            dtype="float32",
        )


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import (arctic_480b, command_r_plus_104b, falcon_mamba_7b,  # noqa
                   llama3_405b, llama4_maverick, olmo_1b, qwen2_vl_2b,
                   stablelm_1_6b, whisper_medium, zamba2_1_2b)
