"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block.

The port of the JAX package's ``models/hybrid.py`` for serving.
``n_layers`` Mamba2 blocks run in G = ``n_layers / attn_every`` groups of
``attn_every``; after each group the shared transformer block (the same
weights at every application, Zamba's parameter sharing) runs on
``concat(h, e0) @ w_concat``, where ``e0`` is the embedding after its cast
(Zamba's global skip); its attention and MLP residuals add to ``h``, not to
the concatenation. Each application has its own KV cache. A group's blocks
run :func:`repro_torch.models.ssm_lm.run_blocks` (the reference's
``_mamba_group`` is the same scan as ``ssm_lm``'s). Params hold
``params["mamba"][g][k]``, one dict per block (the reference stacks them
``(G, K, ...)``; :mod:`repro_torch.convert` keeps that layout apart), and
``params["shared"]`` once; caches are ``{"mamba": [[SSMCache] * K] * G,
"attn": [KVCache] * G}``. On the card the shared block's prefill attention
is one K6 launch an application (zamba2-2.7b: D = DV = 80, 9 a prefill);
the Mamba2 blocks run no kernel of the port. ``hybrid_loss`` is the
training entry point: the teacher-forced CE, each Mamba2 block and each
shared-block application recomputed in the backward under ``cfg.remat``;
its attention takes the plain path on the card too (it needs a gradient),
so a train step launches no K6.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models import ssm_lm as SL
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    apply_norm,
    cross_entropy_loss,
    dense_init,
    embed_init,
    embed_lookup,
    mm,
    norm_init,
    remat_call,
    swiglu_apply,
    swiglu_init,
)


def _groups(cfg: ArchConfig):
    return cfg.n_layers // cfg.attn_every, cfg.attn_every


def hybrid_init(cfg: ArchConfig, gen, dtype=None):
    """Random params from ``gen``, on ``gen``'s device, in ``cfg``'s dtype."""
    dtype = dtype or cfg.tdtype
    dev = gen.device
    g, k = _groups(cfg)
    mamba = [[{"norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
               "ssm": S.ssm_init(gen, cfg, dtype)} for _ in range(k)] for _ in range(g)]
    shared = {
        "w_concat": dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype),
        "attn_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "attn": A.gqa_init(gen, cfg, dtype),
        "mlp_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "mamba": mamba,
        "shared": shared,
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "lm_head": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype).t().contiguous(),
    }


def _shared_block(cfg: ArchConfig, sp, h, e0, positions, *, cache=None, cache_max_len=None):
    """The shared transformer block on ``concat(h, e0) @ w_concat``; its
    residuals add to ``h``. Returns (h, the application's KV cache)."""
    x = mm(torch.cat([h, e0], dim=-1), sp["w_concat"])
    a_out, new_cache = A.gqa_apply(
        sp["attn"], cfg, apply_norm(x, sp["attn_norm"], cfg.norm), positions,
        cache=cache, cache_max_len=cache_max_len)
    h = h + a_out
    h = h + swiglu_apply(sp["mlp"], apply_norm(h, sp["mlp_norm"], cfg.norm))
    return h, new_cache


def _forward(cfg: ArchConfig, params, tokens, positions, *, mamba_caches=None,
             attn_caches=None, cache_max_len=None):
    """Every group and shared-block application. Returns (h before the final
    norm, the Mamba2 caches, the KV caches)."""
    g, _ = _groups(cfg)
    h = embed_lookup(params["embed"], tokens).to(cfg.tdtype)
    e0 = h
    new_mamba, new_attn = [], []
    for gi in range(g):
        h, nmc = SL.run_blocks(cfg, params["mamba"][gi], h,
                               caches=None if mamba_caches is None else mamba_caches[gi])
        h, nac = _shared_block(cfg, params["shared"], h, e0, positions,
                               cache=None if attn_caches is None else attn_caches[gi],
                               cache_max_len=cache_max_len)
        new_mamba.append(nmc)
        new_attn.append(nac)
    return h, new_mamba, new_attn


def hybrid_loss(cfg: ArchConfig, params, batch):
    """Teacher-forced token CE over ``tokens``/``labels`` (B, S), with the
    batch's optional ``loss_mask``."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    g, _ = _groups(cfg)
    h = embed_lookup(params["embed"], tokens).to(cfg.tdtype)
    e0 = h
    for gi in range(g):
        h = SL.train_blocks(cfg, params["mamba"][gi], h, remat=cfg.remat)
        h = remat_call(cfg.remat,
                       lambda h: _shared_block(cfg, params["shared"], h, e0, positions)[0], h)
    return cross_entropy_loss(SL.logits(cfg, params, h), batch["labels"],
                              batch.get("loss_mask"))


def hybrid_make_caches(cfg: ArchConfig, batch_size: int, max_len: int, dtype, device=None):
    g, k = _groups(cfg)
    return {"mamba": [[S.make_ssm_cache(cfg, batch_size, dtype, device) for _ in range(k)]
                      for _ in range(g)],
            "attn": [A.make_kv_cache(cfg, batch_size, max_len, dtype, device)
                     for _ in range(g)]}


def hybrid_prefill(cfg: ArchConfig, params, batch, *, max_len: int):
    """Returns (last-token logits (B, 1, V), caches)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    h, nm, na = _forward(cfg, params, tokens, positions, cache_max_len=max_len)
    return SL.logits(cfg, params, h[:, -1:, :]), {"mamba": nm, "attn": na}


def hybrid_decode(cfg: ArchConfig, params, batch, caches):
    """One-token step. batch: tokens (B, 1), positions (B, 1) absolute. The
    KV caches are written in place (:mod:`repro_torch.models.attention`)."""
    h, nm, na = _forward(cfg, params, batch["tokens"], batch["positions"],
                         mamba_caches=caches["mamba"], attn_caches=caches["attn"])
    return SL.logits(cfg, params, h), {"mamba": nm, "attn": na}
