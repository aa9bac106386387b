"""Whisper-style encoder-decoder (audio backbone; conv frontend stubbed).

The port of the JAX package's ``models/encdec.py`` for serving. As in the
reference, the modality frontend is a stub: the batch brings precomputed
frame embeddings ``frames`` (B, n_frames, d_model), and Whisper's two
strided conv1d layers are not modeled. Both stacks add sinusoidal
positions (:func:`_sinusoid`, the reference's substitute for Whisper's
learned decoder positions); the decoder's self-attention also applies
RoPE, as the reference's ``gqa_apply`` does.

LayerNorm, the GELU MLP (:func:`repro_torch.models.layers.gelu_mlp_apply`)
and MHA (n_kv_heads == n_heads) in pre-norm residual blocks. The encoder's
self-attention is bidirectional (``wq``, ``wk``, ``wv``, ``wo``, no
biases); each decoder block runs causal cached self-attention, then
cross-attention over the encoder's ``memory``
(:func:`repro_torch.models.attention.cross_attn_apply`), then the MLP. The
head is tied to the embedding. A Python loop over the layers takes the
place of ``lax.scan``: params hold one dict per layer in
``params["enc_layers"]`` and ``params["dec_layers"]`` (the reference
stacks them ``(L, ...)``; :mod:`repro_torch.convert` keeps that layout
apart). Caches are ``{"self": [KVCache] * n_layers, "memory": (B, n_frames,
d_model)}``.

On the card every attention is one K6 launch: a prefill makes
``n_enc_layers`` non-causal ones in the encoder, then per decoder layer a
causal one and a non-causal cross-attention (whisper-base: 6 + 6 + 6 = 18);
every decode step makes one cross-attention launch per decoder layer (6) at
Tq = 1, its k and v recomputed from ``memory`` as the reference does. The
self-attention's decode is :func:`repro_torch.models.attention.cached_attention`,
no kernel. ``encdec_loss`` is the training entry point: the encoder and the
decoder each layer under ``cfg.remat``, the tied head, the CE; every
attention of it needs a gradient and takes the plain path on the card too,
so a train step launches no K6.

Under a ``model`` axis (tensor-parallel serving) every encoder and decoder
layer runs at the rank's heads and hidden: an encoder layer all-reduces
twice, a decoder layer three times (self-attention, cross-attention, MLP);
the tied head is cut with the embedding where the vocabulary divides the
axis; ``memory`` is whole on every rank.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import attention as A
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    apply_norm,
    cross_entropy_loss,
    embed_init,
    embed_lookup,
    gelu_mlp_apply,
    gelu_mlp_init,
    mm,
    norm_init,
    remat_call,
    row_parallel,
    vocab_logits,
)


def _sinusoid(positions, d):
    """(..., S) positions -> (..., S, d) float32: sines of d // 2
    frequencies 10000^(-i / max(d/2 - 1, 1)), then their cosines.

    The frequencies are made on the host, whatever the positions' device:
    the reference's float32 exponent (its true division; the card divides a
    tensor by a number as a product with the reciprocal, which rounds
    otherwise), then its exp in float64, rounded once. So the CPU and the
    card take the same frequencies: an ulp of one is an ulp of the angle,
    which at position 1,500 is 1.2e-4 in the sinusoid. XLA's float32 exp
    sits an ulp from that rounding on a few frequencies, so the reference's
    angles can differ by as much."""
    half = d // 2
    expo = -math.log(10000.0) * torch.arange(half, dtype=torch.float32) / max(half - 1, 1)
    freq = torch.exp(expo.double()).float().to(positions.device)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_layer_init(gen, cfg: ArchConfig, dtype):
    dev = gen.device
    return {
        "attn_norm": norm_init(cfg.d_model, "layernorm", dtype, dev),
        "attn": A.gqa_init(gen, cfg, dtype),
        "mlp_norm": norm_init(cfg.d_model, "layernorm", dtype, dev),
        "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def _dec_layer_init(gen, cfg: ArchConfig, dtype):
    dev = gen.device
    return {
        "attn_norm": norm_init(cfg.d_model, "layernorm", dtype, dev),
        "attn": A.gqa_init(gen, cfg, dtype),
        "cross_norm": norm_init(cfg.d_model, "layernorm", dtype, dev),
        "cross": A.cross_attn_init(gen, cfg, dtype),
        "mlp_norm": norm_init(cfg.d_model, "layernorm", dtype, dev),
        "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def encdec_init(cfg: ArchConfig, gen, dtype=None):
    """Random params from ``gen``, on ``gen``'s device, in ``cfg``'s dtype."""
    dtype = dtype or cfg.tdtype
    dev = gen.device
    n_enc = cfg.n_enc_layers or cfg.n_layers
    enc = [_enc_layer_init(gen, cfg, dtype) for _ in range(n_enc)]
    dec = [_dec_layer_init(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    return {
        "enc_layers": enc,
        "enc_norm": norm_init(cfg.d_model, "layernorm", dtype, dev),
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "dec_layers": dec,
        "dec_norm": norm_init(cfg.d_model, "layernorm", dtype, dev),
    }


def _enc_block(cfg: ArchConfig, lp, h):
    """One encoder layer: bidirectional self-attention, then the MLP."""
    x = apply_norm(h, lp["attn_norm"], "layernorm")
    b, s, _ = x.shape
    q = mm(x, lp["attn"]["wq"]).reshape(b, s, -1, cfg.hd)
    k = mm(x, lp["attn"]["wk"]).reshape(b, s, -1, cfg.hd)
    v = mm(x, lp["attn"]["wv"]).reshape(b, s, -1, cfg.hd)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    o = A.chunked_attention(qh, kh, vh, causal=False, scale=cfg.hd ** -0.5)
    h = h + row_parallel(o.transpose(1, 2).reshape(b, s, -1), lp["attn"]["wo"])
    return h + gelu_mlp_apply(lp["mlp"], apply_norm(h, lp["mlp_norm"], "layernorm"))


def encode(cfg: ArchConfig, params, frames, *, remat: bool = False):
    """frames: (B, M, d) precomputed embeddings (the conv stub) -> the
    encoder's states (B, M, d) in ``cfg``'s dtype; each layer recomputed in
    the backward under ``remat``."""
    h = frames.to(cfg.tdtype)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h = h + _sinusoid(positions, cfg.d_model).to(h.dtype)
    for lp in params["enc_layers"]:
        h = remat_call(remat, lambda h, lp=lp: _enc_block(cfg, lp, h), h)
    return apply_norm(h, params["enc_norm"], "layernorm")


def _dec_block(cfg: ArchConfig, lp, h, memory, positions, *, cache=None, cache_max_len=None):
    """Causal GQA (cached), cross-attention over ``memory``, the MLP; all
    pre-LayerNorm. Returns (h, the layer's KV cache)."""
    a_out, new_cache = A.gqa_apply(lp["attn"], cfg,
                                   apply_norm(h, lp["attn_norm"], "layernorm"), positions,
                                   cache=cache, cache_max_len=cache_max_len)
    h = h + a_out
    h = h + A.cross_attn_apply(lp["cross"], cfg,
                               apply_norm(h, lp["cross_norm"], "layernorm"), memory)
    h = h + gelu_mlp_apply(lp["mlp"], apply_norm(h, lp["mlp_norm"], "layernorm"))
    return h, new_cache


def decode_stack(cfg: ArchConfig, params, tokens, memory, positions, *, caches=None,
                 cache_max_len=None, remat: bool = False):
    """The decoder over ``tokens`` (B, S) at ``positions``: returns (h after
    the final norm, one KV cache per layer). ``remat`` (training, no
    caches): each layer recomputed in the backward, and no caches."""
    h = embed_lookup(params["embed"], tokens, cfg.vocab_size).to(cfg.tdtype)
    h = h + _sinusoid(positions, cfg.d_model).to(h.dtype)
    new_caches = []
    for i, lp in enumerate(params["dec_layers"]):
        if remat:
            h = remat_call(True, lambda h, lp=lp: _dec_block(cfg, lp, h, memory, positions)[0],
                           h)
            continue
        h, nc = _dec_block(cfg, lp, h, memory, positions,
                           cache=None if caches is None else caches[i],
                           cache_max_len=cache_max_len)
        new_caches.append(nc)
    return apply_norm(h, params["dec_norm"], "layernorm"), new_caches


def encdec_loss(cfg: ArchConfig, params, batch):
    """Teacher-forced token CE: ``frames`` (B, M, d) through the encoder,
    ``tokens``/``labels`` (B, S) through the decoder over its memory, the
    head tied to the embedding; the batch's optional ``loss_mask``."""
    memory = encode(cfg, params, batch["frames"], remat=cfg.remat)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    h, _ = decode_stack(cfg, params, tokens, memory, positions, remat=cfg.remat)
    return cross_entropy_loss(mm(h, params["embed"].t()), batch["labels"],
                              batch.get("loss_mask"))


def encdec_make_caches(cfg: ArchConfig, batch_size: int, max_len: int, dtype, device=None):
    return {"self": [A.make_kv_cache(cfg, batch_size, max_len, dtype, device)
                     for _ in range(cfg.n_layers)],
            "memory": torch.zeros((batch_size, cfg.n_frames, cfg.d_model), dtype=dtype,
                                  device=device)}


def encdec_prefill(cfg: ArchConfig, params, batch, *, max_len: int):
    """batch: ``frames`` (B, M, d) and ``tokens`` (B, P). Returns
    (last-token logits (B, 1, V), caches)."""
    memory = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    h, caches = decode_stack(cfg, params, tokens, memory, positions, cache_max_len=max_len)
    return (vocab_logits(h[:, -1:, :], params["embed"].t(), cfg.vocab_size),
            {"self": caches, "memory": memory})


def encdec_decode(cfg: ArchConfig, params, batch, caches):
    """One-token step. batch: tokens (B, 1), positions (B, 1) absolute. The
    KV caches are written in place (:mod:`repro_torch.models.attention`);
    ``memory`` is passed on as it is."""
    h, new_caches = decode_stack(cfg, params, batch["tokens"], caches["memory"],
                                 batch["positions"], caches=caches["self"])
    return (vocab_logits(h, params["embed"].t(), cfg.vocab_size),
            {"self": new_caches, "memory": caches["memory"]})
