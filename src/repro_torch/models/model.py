"""Unified model API: ``build_model(config) -> Model`` with init/loss/prefill/decode.

The port of the JAX package's ``models/model.py``. Every family of the
registry runs (serving: prefill + decode): dense, MoE and vlm (the
transformer, with GQA or MLA attention; vlm with its image prefix), ssm
(Mamba2), hybrid (Zamba2) and encdec (whisper: an encode of the batch's
``frames`` in the prefill, cross-attention over it in every decoder layer).
``loss`` (``(params, batch) -> scalar``) is what the train step
(:mod:`repro_torch.launch.steps`) differentiates, for every family. There
is no ``use_pallas`` switch:
as everywhere in the port, a CUDA tensor runs the kernels and a CPU tensor
the plain versions. Under a host mesh's activation context
(:mod:`repro_torch.sharding.ctx`, tensor-parallel serving) every entry
point runs at the rank's share of the heads and hidden, and
``make_caches`` makes KV caches of the rank's kv heads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm_lm as SL
from repro_torch.models import transformer as TF
from repro_torch.models.config import ArchConfig

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]                  # (generator) -> params
    loss: Callable[..., Any]                  # (params, batch) -> scalar
    prefill: Callable[..., Any]               # (params, batch, max_len) -> (logits, caches)
    decode: Callable[..., Any]                # (params, batch, caches) -> (logits, caches)
    make_caches: Callable[..., Any]           # (batch, max_len, dtype, device) -> caches


def build_model(cfg: ArchConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return Model(
            cfg=cfg,
            init=lambda gen: TF.lm_init(cfg, gen),
            loss=lambda p, b: TF.lm_loss(cfg, p, b),
            prefill=lambda p, b, max_len: TF.lm_prefill(cfg, p, b, max_len=max_len),
            decode=lambda p, b, c: TF.lm_decode(cfg, p, b, c),
            make_caches=lambda bs, ml, dt, dev=None: TF.lm_make_caches(cfg, bs, ml, dt, dev),
        )
    if fam == "ssm":
        return Model(
            cfg=cfg,
            init=lambda gen: SL.ssm_lm_init(cfg, gen),
            loss=lambda p, b: SL.ssm_lm_loss(cfg, p, b),
            prefill=lambda p, b, max_len: SL.ssm_lm_prefill(cfg, p, b, max_len=max_len),
            decode=lambda p, b, c: SL.ssm_lm_decode(cfg, p, b, c),
            make_caches=lambda bs, ml, dt, dev=None: SL.ssm_lm_make_caches(cfg, bs, ml, dt,
                                                                           dev),
        )
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda gen: HY.hybrid_init(cfg, gen),
            loss=lambda p, b: HY.hybrid_loss(cfg, p, b),
            prefill=lambda p, b, max_len: HY.hybrid_prefill(cfg, p, b, max_len=max_len),
            decode=lambda p, b, c: HY.hybrid_decode(cfg, p, b, c),
            make_caches=lambda bs, ml, dt, dev=None: HY.hybrid_make_caches(cfg, bs, ml, dt,
                                                                           dev),
        )
    if fam == "encdec":
        return Model(
            cfg=cfg,
            init=lambda gen: ED.encdec_init(cfg, gen),
            loss=lambda p, b: ED.encdec_loss(cfg, p, b),
            prefill=lambda p, b, max_len: ED.encdec_prefill(cfg, p, b, max_len=max_len),
            decode=lambda p, b, c: ED.encdec_decode(cfg, p, b, c),
            make_caches=lambda bs, ml, dt, dev=None: ED.encdec_make_caches(cfg, bs, ml, dt,
                                                                           dev),
        )
    raise ValueError(f"unknown family {fam}")
