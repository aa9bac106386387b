"""whisper-base [arXiv:2212.04356]: encoder-decoder, conv frontend stubbed.

6L enc + 6L dec, d_model=512 8H (MHA) d_ff=2048 vocab=51865; 1500 encoder
frames (the 2x conv1d stem is a stub -- input_specs provides precomputed
frame embeddings).
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, norm="layernorm", n_frames=1500,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=128, n_frames=16, dtype="float32", remat=False)
