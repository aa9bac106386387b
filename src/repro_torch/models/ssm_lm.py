"""Mamba2 (attention-free) language model: embed -> Mamba2 blocks -> head.

The port of the JAX package's ``models/ssm_lm.py`` for serving:
``ssm_lm_init``, ``ssm_lm_make_caches``, ``ssm_lm_prefill`` (the sequence
through the chunked SSD, keeping each block's final state and conv tail)
and ``ssm_lm_decode`` (the O(1) recurrent step). A Python loop over the
blocks takes the place of ``lax.scan``; params hold one dict per block
(``params["layers"][i]``), and caches are a list of one
:class:`~repro_torch.models.ssm.SSMCache` per block. The reference's stacked
``(L, ...)`` leaves are kept at the converter (:mod:`repro_torch.convert`).
No kernel of the port runs here (the SSD is plain tensor code, as in the
reference). ``ssm_lm_loss`` is the training entry point: the teacher-forced
CE, each block recomputed in the backward under ``cfg.remat``
(:func:`train_blocks`, the hybrid's too).
"""

from __future__ import annotations

from repro_torch.models import ssm as S
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    apply_norm,
    cross_entropy_loss,
    embed_init,
    embed_lookup,
    mm,
    norm_init,
    remat_call,
)


def ssm_lm_init(cfg: ArchConfig, gen, dtype=None):
    """Random params from ``gen``, on ``gen``'s device, in ``cfg``'s dtype."""
    dtype = dtype or cfg.tdtype
    dev = gen.device
    layers = [{"norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
               "ssm": S.ssm_init(gen, cfg, dtype)}
              for _ in range(cfg.n_layers)]
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "layers": layers,
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "lm_head": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype).t().contiguous(),
    }


def run_blocks(cfg: ArchConfig, layers, h, *, caches=None):
    """Pre-norm residual Mamba2 blocks in order; ``caches`` one per block
    (decode) or None (prefill). Returns (h, the new caches)."""
    new_caches = []
    for i, lp in enumerate(layers):
        out, nc = S.ssm_apply(lp["ssm"], cfg, apply_norm(h, lp["norm"], cfg.norm),
                              cache=None if caches is None else caches[i])
        h = h + out
        new_caches.append(nc)
    return h, new_caches


def _train_block(cfg: ArchConfig, lp, h):
    out, _ = S.ssm_apply(lp["ssm"], cfg, apply_norm(h, lp["norm"], cfg.norm))
    return h + out


def train_blocks(cfg: ArchConfig, layers, h, *, remat: bool):
    """The blocks of a loss, in order, each under ``remat``
    (:func:`~repro_torch.models.layers.remat_call`). Returns h."""
    for lp in layers:
        h = remat_call(remat, lambda h, lp=lp: _train_block(cfg, lp, h), h)
    return h


def logits(cfg: ArchConfig, params, h):
    """The final norm and the LM head (the hybrid's too)."""
    return mm(apply_norm(h, params["final_norm"], cfg.norm), params["lm_head"])


def ssm_lm_loss(cfg: ArchConfig, params, batch):
    """Teacher-forced token CE over ``tokens``/``labels`` (B, S), with the
    batch's optional ``loss_mask``."""
    h = embed_lookup(params["embed"], batch["tokens"]).to(cfg.tdtype)
    h = train_blocks(cfg, params["layers"], h, remat=cfg.remat)
    return cross_entropy_loss(logits(cfg, params, h), batch["labels"],
                              batch.get("loss_mask"))


def ssm_lm_make_caches(cfg: ArchConfig, batch_size: int, max_len: int, dtype, device=None):
    """One zeroed :class:`~repro_torch.models.ssm.SSMCache` per block; an SSM
    cache does not grow with ``max_len``."""
    return [S.make_ssm_cache(cfg, batch_size, dtype, device) for _ in range(cfg.n_layers)]


def ssm_lm_prefill(cfg: ArchConfig, params, batch, *, max_len: int):
    """The prompt through the chunked SSD. Returns (last-token logits (B, 1,
    V), the caches: each block's final state and conv tail)."""
    h = embed_lookup(params["embed"], batch["tokens"]).to(cfg.tdtype)
    h, caches = run_blocks(cfg, params["layers"], h)
    return logits(cfg, params, h[:, -1:, :]), caches


def ssm_lm_decode(cfg: ArchConfig, params, batch, caches):
    """One-token step: batch tokens (B, 1); positions are not needed."""
    h = embed_lookup(params["embed"], batch["tokens"]).to(cfg.tdtype)
    h, caches = run_blocks(cfg, params["layers"], h, caches=caches)
    return logits(cfg, params, h), caches
