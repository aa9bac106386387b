"""Decoder-only transformer assembly: the dense, MoE and vlm families.

The port of the JAX package's ``models/transformer.py`` for ``family`` in
``("dense", "moe", "vlm")``: ``lm_init``, the pre-norm residual block (a SwiGLU
MLP, or :func:`repro_torch.models.moe.moe_apply` in a MoE layer), and the
serving entry points ``lm_make_caches``, ``lm_prefill`` (build KV caches +
last-position logits) and ``lm_decode`` (single-token step). A Python loop
over the layers takes the place of ``lax.scan``; params hold one dict per
layer (``params["layers"][i]``), and the reference's stacked ``(L, ...)``
leaves are kept at the converter (:mod:`repro_torch.convert`), not here.
DeepSeek's ``first_dense_layers`` (MoE family only) are dense blocks of
``first_dense_d_ff`` held apart as ``params["prefix_layers"]``, run before
the others, with their own caches under ``"prefix"``. A ``use_mla`` config
(deepseek-v2-lite) takes MLA attention in every layer, the prefix layers
too (:func:`repro_torch.models.attention.mla_apply`, its absorbed decode).
Caches are ``{"layers": [KVCache, ...]}`` (``MLACache`` under MLA; plus
``"prefix"``), one per layer. The activation-sharding ``constrain`` is the
identity on one device and is not ported.

A vlm prefill takes ``batch["image_embeds"]`` (B, n_patches, d_model), cast
to the model dtype and put in front of the token embeddings before the
layers (the stubbed vision frontend's patch embeddings), so its positions
and caches start with the patches; its decode is the dense one.

``lm_loss`` is the training entry point: the teacher-forced CE, plus 0.01
x the summed MoE aux loss of the non-prefix layers, the image positions of
a vlm batch masked out, each non-prefix layer recomputed in the backward
under ``cfg.remat`` (a MoE layer's MLP half kept). Its attention needs a
gradient, so it takes the plain chunked path on the card as well
(:func:`repro_torch.models.attention.chunked_attention`): a train step
launches no K6.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    apply_norm,
    cross_entropy_loss,
    embed_init,
    embed_lookup,
    mm,
    norm_init,
    remat_call,
    swiglu_apply,
    swiglu_init,
)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: ArchConfig, *, moe_layer: bool, d_ff: int, dtype):
    dev = gen.device
    p = {
        "attn_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "attn": (A.mla_init if cfg.use_mla else A.gqa_init)(gen, cfg, dtype),
        "mlp_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
    }
    if moe_layer:
        p["moe"] = MOE.moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = swiglu_init(gen, cfg.d_model, d_ff, dtype)
    return p


def _n_prefix(cfg: ArchConfig) -> int:
    return cfg.first_dense_layers if cfg.family == "moe" else 0


def lm_init(cfg: ArchConfig, gen, dtype=None):
    """Random params from ``gen``, on ``gen``'s device, in ``cfg``'s dtype."""
    dtype = dtype or cfg.tdtype
    n_prefix = _n_prefix(cfg)
    prefix = [_layer_init(gen, cfg, moe_layer=False,
                          d_ff=cfg.first_dense_d_ff or cfg.d_ff, dtype=dtype)
              for _ in range(n_prefix)]
    layers = [_layer_init(gen, cfg, moe_layer=cfg.family == "moe", d_ff=cfg.d_ff,
                          dtype=dtype)
              for _ in range(cfg.n_layers - n_prefix)]
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "layers": layers,
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, gen.device),
    }
    if prefix:
        params["prefix_layers"] = prefix
    if not cfg.tie_embeddings:
        # contiguous (d, V), as a converted or restored head is: the head's
        # product then sums in one order whichever way the params came
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype).t().contiguous()
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _attn_half(cfg: ArchConfig, p, h, positions, *, cache=None, cache_max_len=None):
    """The block's pre-norm attention and its residual: (h, new_cache)."""
    attn_fn = A.mla_apply if cfg.use_mla else A.gqa_apply
    a_out, new_cache = attn_fn(
        p["attn"], cfg, apply_norm(h, p["attn_norm"], cfg.norm), positions,
        cache=cache, cache_max_len=cache_max_len)
    return h + cfg.residual_multiplier * a_out, new_cache


def _mlp_half(cfg: ArchConfig, p, h):
    """The block's pre-norm MLP (SwiGLU or MoE) and its residual: (h, aux);
    the aux loss of a dense block is the float 0.0 (no launch on the card)."""
    x = apply_norm(h, p["mlp_norm"], cfg.norm)
    if "moe" in p:
        m_out, aux = MOE.moe_apply(p["moe"], cfg, x)
    else:
        m_out, aux = swiglu_apply(p["mlp"], x), 0.0
    return h + cfg.residual_multiplier * m_out, aux


def _block(cfg: ArchConfig, p, h, positions, *, cache=None, cache_max_len=None):
    """Pre-norm residual block. Returns (h, new_cache, aux_loss)."""
    h, new_cache = _attn_half(cfg, p, h, positions, cache=cache, cache_max_len=cache_max_len)
    h, aux = _mlp_half(cfg, p, h)
    return h, new_cache, aux


def _train_block(cfg: ArchConfig, p, h, positions, *, remat: bool):
    """A block of the loss: (h, aux). Under ``remat`` a dense block is
    recomputed whole in the backward; a MoE block only its attention half,
    its MLP half (router, dispatch, experts) kept: the reference saves the
    MoE output (``save_only_these_names("moe_out")``), and here nothing of
    the MoE layer is recomputed, so its routing is made once."""
    if "moe" in p:
        h = remat_call(remat, lambda h: _attn_half(cfg, p, h, positions)[0], h)
        return _mlp_half(cfg, p, h)
    return remat_call(remat, lambda h: _block(cfg, p, h, positions)[0], h), 0.0


def _run_layers(cfg: ArchConfig, layers, h, positions, *, caches=None,
                cache_max_len=None):
    """``layers`` in order; caches: one per layer or None.
    Returns (h, new caches, the layers' summed aux loss)."""
    new_caches, aux = [], 0.0
    for i, lp in enumerate(layers):
        h, nc, a = _block(cfg, lp, h, positions,
                          cache=None if caches is None else caches[i],
                          cache_max_len=cache_max_len)
        new_caches.append(nc)
        aux = aux + a
    return h, new_caches, aux


def _run_all(cfg: ArchConfig, params, h, positions, *, caches=None, cache_max_len=None):
    """The prefix layers (if any), then the others. Returns (h, caches)."""
    out = {}
    if "prefix_layers" in params:
        h, out["prefix"], _ = _run_layers(
            cfg, params["prefix_layers"], h, positions, cache_max_len=cache_max_len,
            caches=None if caches is None else caches["prefix"])
    h, out["layers"], _ = _run_layers(
        cfg, params["layers"], h, positions, cache_max_len=cache_max_len,
        caches=None if caches is None else caches["layers"])
    return h, out


def _embed_h(cfg, params, tokens):
    h = embed_lookup(params["embed"], tokens).to(cfg.tdtype)
    return h * cfg.embedding_multiplier


def _logits(cfg, params, h):
    h = apply_norm(h, params["final_norm"], cfg.norm)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = mm(h, head)
    return logits / cfg.logits_scaling


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lm_loss(cfg: ArchConfig, params, batch):
    """Teacher-forced token CE + 0.01 x the summed MoE aux loss (a scalar).

    batch: ``tokens`` and ``labels`` (B, S), optional ``loss_mask`` (B, S);
    a vlm's ``image_embeds`` (B, P, d) go in front of the tokens, their
    positions labelled 0 and masked out. The prefix layers run without
    remat and their aux loss is dropped, as the reference's; the other
    layers each run under ``cfg.remat`` (:func:`_train_block`)."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("loss_mask")
    b, s = tokens.shape
    h = _embed_h(cfg, params, tokens)
    if cfg.family == "vlm":
        img = batch["image_embeds"].to(cfg.tdtype)           # (B, P, d)
        n_img = img.shape[1]
        h = torch.cat([img, h], dim=1)
        labels = torch.cat([labels.new_zeros((b, n_img)), labels], dim=1)
        tok_mask = (mask.float() if mask is not None
                    else torch.ones((b, s), dtype=torch.float32, device=h.device))
        mask = torch.cat([torch.zeros((b, n_img), dtype=torch.float32, device=h.device),
                          tok_mask], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for lp in params.get("prefix_layers", []):
        h = _block(cfg, lp, h, positions)[0]
    aux = 0.0
    for lp in params["layers"]:
        h, a = _train_block(cfg, lp, h, positions, remat=cfg.remat)
        aux = aux + a
    ce = cross_entropy_loss(_logits(cfg, params, h), labels, mask)
    return ce + 0.01 * aux



def lm_make_caches(cfg: ArchConfig, batch_size: int, max_len: int, dtype, device=None):
    make_one = A.make_mla_cache if cfg.use_mla else A.make_kv_cache

    def make(n):
        return [make_one(cfg, batch_size, max_len, dtype, device) for _ in range(n)]

    n_prefix = _n_prefix(cfg)
    caches = {"layers": make(cfg.n_layers - n_prefix)}
    if n_prefix:
        caches["prefix"] = make(n_prefix)
    return caches


def lm_prefill(cfg: ArchConfig, params, batch, *, max_len: int):
    """Returns (last-token logits (B, 1, V), caches). A vlm batch also holds
    ``image_embeds``; ``max_len`` then counts the patches too."""
    h = _embed_h(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        h = torch.cat([batch["image_embeds"].to(cfg.tdtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, caches = _run_all(cfg, params, h, positions, cache_max_len=max_len)
    return _logits(cfg, params, h[:, -1:, :]), caches


def lm_decode(cfg: ArchConfig, params, batch, caches):
    """One-token step. batch: tokens (B, 1), positions (B, 1) absolute.

    The caches are written in place (see :mod:`repro_torch.models.attention`).
    """
    tokens, positions = batch["tokens"], batch["positions"]
    h = _embed_h(cfg, params, tokens)
    h, caches = _run_all(cfg, params, h, positions, caches=caches)
    return _logits(cfg, params, h), caches
