"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 128-expert top-8 MoE.

48L d_model=2048 32H (GQA kv=4, head_dim=128, QK-norm) expert d_ff=768
vocab=151936, no shared experts.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab_size=151936, head_dim=128, qk_norm=True, rope_theta=1000000.0,
    n_experts=128, top_k=8, moe_d_ff=768, norm_topk_prob=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, moe_d_ff=64, n_experts=8, top_k=2, vocab_size=128,
    capacity_factor=64.0,  # dropless at smoke sizes (exact prefill/decode match)
    dtype="float32", remat=False)
