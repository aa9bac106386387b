"""qwen2.5-14b [hf:Qwen/Qwen2.5-14B]: dense GQA with QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab_size=152064, qkv_bias=True, rope_theta=1000000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
    vocab_size=128, dtype="float32", remat=False)
