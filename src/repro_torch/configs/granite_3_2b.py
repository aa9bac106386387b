"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: dense GQA.

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155. Granite 3.0 uses
tied embeddings and its depth-scaled multiplier scheme.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=49155, tie_embeddings=True,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=8.0,
    rope_theta=10000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=128, dtype="float32", remat=False)
