"""internvl2-2b [arXiv:2404.16821]: InternViT(stub) + InternLM2 backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. Vision frontend is a
stub per the task spec: input_specs provides precomputed patch embeddings
(B, n_patches, d_model) that are prepended to the text sequence.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92553, n_patches=256,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=128, n_patches=8, dtype="float32", remat=False)
