"""chatglm3-6b [arXiv:2406.12793]: GQA kv=2, 2d RoPE (half-dim rotary).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=65024, qkv_bias=True, rope_fraction=0.5,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=128, dtype="float32", remat=False)
