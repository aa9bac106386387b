"""mamba2-1.3b [arXiv:2405.21060]: attention-free SSD (state-space duality).

48L d_model=2048 (d_inner=4096, headdim=64 -> 64 ssm heads, ssm_state=128),
vocab=50280, no FFN (d_ff=0).
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1, ssm_conv=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab_size=128, ssm_state=16,
    ssm_headdim=16, ssm_chunk=8, dtype="float32", remat=False)
