"""deepseek-v2-lite-16b [arXiv:2405.04434]: MLA + fine-grained MoE.

27L d_model=2048 16H, MLA kv_lora=512 (qk_nope=128, qk_rope=64, v=128),
MoE 64 routed top-6 + 2 shared experts, expert d_ff=1408, vocab=102400,
first layer keeps a dense FFN (10944).

The assignment line lists both "64e top-6" and "160 routed"; we follow the
published v2-lite config (64 routed + 2 shared, top-6) -- see DESIGN.md.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400,
    use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
    first_dense_layers=1, first_dense_d_ff=10944,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    d_ff=64, moe_d_ff=64, n_experts=8, top_k=2, n_shared_experts=1,
    first_dense_layers=1, first_dense_d_ff=128, vocab_size=128,
    capacity_factor=64.0,  # dropless at smoke sizes (exact prefill/decode match)
    dtype="float32", remat=False)
