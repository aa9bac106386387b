"""zamba2-2.7b [arXiv:2411.15242]: Mamba2 backbone + shared attention block.

54 Mamba2 layers d_model=2560 (d_inner=5120, headdim=64 -> 80 ssm heads,
ssm_state=64) with the shared transformer block (32H MHA kv=32, d_ff=10240)
applied after every 6th Mamba layer on concat(h, embed) -- weights shared
across the 9 applications, per-application KV caches. vocab=32000.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, attn_every=6,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1, ssm_conv=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, attn_every=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=128, ssm_state=16, ssm_headdim=16, ssm_chunk=8,
    dtype="float32", remat=False)
