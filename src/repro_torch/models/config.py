"""Architecture config schema covering all assigned families.

A copy of the JAX package's ``models/config.py``: the same fields and
defaults, so the port's registry (:mod:`repro_torch.configs`) matches the
reference field for field. ``tdtype`` (a ``torch.dtype``) takes the place of
``jdtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | encdec | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False            # per-head RMSNorm on q/k (qwen3)
    rope_fraction: float = 1.0       # chatglm3 "2d rope": 0.5
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    # scalar multipliers (granite)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None  # None -> 1/sqrt(head_dim)
    logits_scaling: float = 1.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0      # deepseek-v2: layer 0 keeps a dense FFN
    first_dense_d_ff: int = 0        # ... with its own (larger) dense d_ff
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128
    # --- hybrid (zamba2) ---
    attn_every: int = 0              # shared attn block after every k ssm layers
    # --- encdec (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 1500             # encoder positions (conv frontend stub)
    # --- vlm (internvl2) ---
    n_patches: int = 0               # image patch positions (ViT stub)
    # --- compute ---
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "hybrid", "encdec"):
            hd = self.hd
            if self.use_mla:
                attn = (
                    d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d
                )
            else:
                attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            per_layer += attn
        if self.family == "encdec":
            per_layer += per_layer  # cross attention ~ same size as self-attn
        if self.family in ("dense", "vlm", "encdec"):
            ff_mult = 2 if self.family == "encdec" else 3  # gelu vs swiglu
            per_layer += ff_mult * d * self.d_ff
        if self.family == "moe":
            per_layer += 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
            per_layer += d * self.n_experts  # router
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            ssm = d * 2 * di + d * 2 * self.ssm_ngroups * self.ssm_state
            ssm += d * self.ssm_nheads + di * d  # dt proj + out proj
            per_layer = ssm if self.family == "ssm" else per_layer
            if self.family == "hybrid":
                per_layer = ssm  # per-ssm-layer; shared block counted below
        total_layers = self.n_layers + (self.n_enc_layers or 0)
        n += per_layer * total_layers
        if self.family == "hybrid" and self.attn_every:
            hd_full = self.d_model // self.n_heads
            shared = (
                2 * d * d  # concat proj
                + d * hd_full * (self.n_heads + 2 * self.n_kv_heads)
                + self.n_heads * hd_full * d
                + 3 * d * self.d_ff
            )
            n += shared  # weights shared across applications
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        n = self.param_count()
        n -= 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts) * self.n_layers
        dense_ff = 3 * d * self.moe_d_ff * (self.top_k + self.n_shared_experts)
        return int(n + dense_ff * self.n_layers)
