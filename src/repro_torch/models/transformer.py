"""Decoder-only transformer assembly, dense family.

The port of the JAX package's ``models/transformer.py`` for ``family ==
"dense"``: ``lm_init``, the pre-norm residual block, and the serving entry
points ``lm_make_caches``, ``lm_prefill`` (build KV caches + last-position
logits) and ``lm_decode`` (single-token step). A Python loop over the layers
takes the place of ``lax.scan``; params hold one dict per layer
(``params["layers"][i]``), and the reference's stacked ``(L, ...)`` leaves
are kept at the converter (:mod:`repro_torch.convert`), not here. Caches are
``{"layers": [KVCache, ...]}``, one per layer. The activation-sharding
``constrain`` is the identity on one device and is not ported.

The MoE / DeepSeek prefix layers, the vlm image prefix and ``lm_loss`` wait
for their slices (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    apply_norm,
    embed_init,
    embed_lookup,
    norm_init,
    swiglu_apply,
    swiglu_init,
)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: ArchConfig, dtype):
    dev = gen.device
    return {
        "attn_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "attn": A.gqa_init(gen, cfg, dtype),
        "mlp_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def lm_init(cfg: ArchConfig, gen, dtype=None):
    """Random params from ``gen``, on ``gen``'s device, in ``cfg``'s dtype."""
    dtype = dtype or cfg.tdtype
    layers = [_layer_init(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "layers": layers,
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype).t()
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _block(cfg: ArchConfig, p, h, positions, *, cache=None, cache_max_len=None):
    """Pre-norm residual block. Returns (h, new_cache)."""
    a_out, new_cache = A.gqa_apply(
        p["attn"], cfg, apply_norm(h, p["attn_norm"], cfg.norm), positions,
        cache=cache, cache_max_len=cache_max_len)
    h = h + cfg.residual_multiplier * a_out
    x = apply_norm(h, p["mlp_norm"], cfg.norm)
    h = h + cfg.residual_multiplier * swiglu_apply(p["mlp"], x)
    return h, new_cache


def _run_layers(cfg: ArchConfig, params, h, positions, *, caches=None,
                cache_max_len=None):
    """All layers in order; caches: one per layer or None. Returns (h, caches)."""
    new_caches = []
    for i, lp in enumerate(params["layers"]):
        h, nc = _block(cfg, lp, h, positions,
                       cache=None if caches is None else caches[i],
                       cache_max_len=cache_max_len)
        new_caches.append(nc)
    return h, new_caches


def _embed_h(cfg, params, tokens):
    h = embed_lookup(params["embed"], tokens).to(cfg.tdtype)
    return h * cfg.embedding_multiplier


def _logits(cfg, params, h):
    h = apply_norm(h, params["final_norm"], cfg.norm)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = h @ head
    return logits / cfg.logits_scaling


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lm_make_caches(cfg: ArchConfig, batch_size: int, max_len: int, dtype, device=None):
    return {"layers": [A.make_kv_cache(cfg, batch_size, max_len, dtype, device)
                       for _ in range(cfg.n_layers)]}


def lm_prefill(cfg: ArchConfig, params, batch, *, max_len: int):
    """Returns (last-token logits (B, 1, V), caches)."""
    tokens = batch["tokens"]
    h = _embed_h(cfg, params, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, new_caches = _run_layers(cfg, params, h, positions, cache_max_len=max_len)
    logits = _logits(cfg, params, h[:, -1:, :])
    return logits, {"layers": new_caches}


def lm_decode(cfg: ArchConfig, params, batch, caches):
    """One-token step. batch: tokens (B, 1), positions (B, 1) absolute.

    The caches are written in place (see :mod:`repro_torch.models.attention`).
    """
    tokens, positions = batch["tokens"], batch["positions"]
    h = _embed_h(cfg, params, tokens)
    h, new_caches = _run_layers(cfg, params, h, positions, caches=caches["layers"])
    logits = _logits(cfg, params, h)
    return logits, {"layers": new_caches}
