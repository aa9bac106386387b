"""Unified model API: ``build_model(config) -> Model`` with init/prefill/decode.

The port of the JAX package's ``models/model.py``. The dense, MoE and vlm
families (the transformer, with GQA or MLA attention; vlm with its image
prefix), ssm (Mamba2) and hybrid (Zamba2) run (serving: prefill + decode);
encdec raises, naming the part of ``ROADMAP.md`` that brings it, before any
weight is made. ``lm_loss`` (and with it the ``loss`` entry) comes with LM
training. There is no ``use_pallas`` switch:
as everywhere in the port, a CUDA tensor runs the kernels and a CPU tensor
the plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import hybrid as HY
from repro_torch.models import ssm_lm as SL
from repro_torch.models import transformer as TF
from repro_torch.models.config import ArchConfig

# the ROADMAP.md queue item that brings each family not yet ported
_LATER = {
    "encdec": "the LM stack's encdec slice (models/encdec.py)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]                  # (generator) -> params
    prefill: Callable[..., Any]               # (params, batch, max_len) -> (logits, caches)
    decode: Callable[..., Any]                # (params, batch, caches) -> (logits, caches)
    make_caches: Callable[..., Any]           # (batch, max_len, dtype, device) -> caches


def build_model(cfg: ArchConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return Model(
            cfg=cfg,
            init=lambda gen: TF.lm_init(cfg, gen),
            prefill=lambda p, b, max_len: TF.lm_prefill(cfg, p, b, max_len=max_len),
            decode=lambda p, b, c: TF.lm_decode(cfg, p, b, c),
            make_caches=lambda bs, ml, dt, dev=None: TF.lm_make_caches(cfg, bs, ml, dt, dev),
        )
    if fam == "ssm":
        return Model(
            cfg=cfg,
            init=lambda gen: SL.ssm_lm_init(cfg, gen),
            prefill=lambda p, b, max_len: SL.ssm_lm_prefill(cfg, p, b, max_len=max_len),
            decode=lambda p, b, c: SL.ssm_lm_decode(cfg, p, b, c),
            make_caches=lambda bs, ml, dt, dev=None: SL.ssm_lm_make_caches(cfg, bs, ml, dt,
                                                                           dev),
        )
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda gen: HY.hybrid_init(cfg, gen),
            prefill=lambda p, b, max_len: HY.hybrid_prefill(cfg, p, b, max_len=max_len),
            decode=lambda p, b, c: HY.hybrid_decode(cfg, p, b, c),
            make_caches=lambda bs, ml, dt, dev=None: HY.hybrid_make_caches(cfg, bs, ml, dt,
                                                                           dev),
        )
    if fam in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {fam} family is not ported yet; it comes with "
            f"{_LATER[fam]} (ROADMAP.md, section 1)")
    raise ValueError(f"unknown family {fam}")
