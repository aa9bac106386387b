"""The train, prefill and decode steps of every LM family.

The port of the JAX package's ``launch/steps.py``. The train step
accumulates gradients over microbatches (bounding activation memory) and
then takes one AdamW step, with fp32 master params and bf16 compute casts:

* :func:`cast_params_for_compute` casts every fp32 leaf of rank >= 2 to
  the compute dtype, with a per-layer leaf counted at its rank in the
  reference's stacked layout (``(L, ...)``, the hybrid's Mamba2 blocks
  ``(G, K, ...)``), where the reference's cast sees it. So a layer's norm
  scales, biases and Mamba2 vectors (``a_log``, ``dt_bias``, ``d_skip``,
  ``conv_b``, ``out_norm``), stacked in the reference, are cast too, and
  only the unstacked 1-D leaves stay fp32: the final norms, an encdec
  model's ``enc_norm`` and ``dec_norm``, DeepSeek's prefix layers and the
  hybrid's shared block;
* :func:`make_train_step` splits the batch along dim 0 into ``global_batch
  // microbatch`` slices (the reference's reshape), runs ``model.loss`` on
  the cast params of each, and sums the losses and the fp32 gradients
  (autograd accumulates each microbatch's into the masters' ``.grad`` in
  place: ``g1``, then ``+ g2``..., the reference's order from zeros), then
  divides both by the count and runs :func:`repro_torch.train.optimizer.adam_update`
  (default ``AdamConfig(lr=3e-4, clip_norm=1.0, weight_decay=0.0)``), which
  writes the params and moments in place. The gradients reach the fp32
  masters through the cast, as JAX's do.

:func:`batch_template` gives each cell's batch as shapes and dtypes. The
dry-run's ``abstract_params``, ``abstract_caches`` and
``abstract_opt_state`` wait for the sharded LM stack (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ShapeCell
from repro_torch.convert import _STACKED
from repro_torch.core.esrnn import param_leaves
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamConfig, adam_update


def cast_params_for_compute(params, dtype=torch.bfloat16):
    """fp32 master -> ``dtype`` compute for every matrix (a leaf's rank
    counted as the reference's stacked layout has it); small leaves stay
    fp32. The casts stay in the autograd graph."""
    def walk(tree, axes):
        if isinstance(tree, dict):
            return {k: walk(v, axes) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, axes) for v in tree]
        if tree.dtype == torch.float32 and tree.dim() + axes >= 2:
            return tree.to(dtype)
        return tree

    return {k: walk(v, _STACKED.get(k, 0)) for k, v in params.items()}


# ---------------------------------------------------------------------------
# batch templates per cell
# ---------------------------------------------------------------------------


def batch_template(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, Tuple[Tuple[int, ...],
                                                                        torch.dtype]]:
    """``{name: (shape, dtype)}`` of a cell's batch: the reference's
    ``ShapeDtypeStruct``s."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        s_text = s - (cfg.n_patches if cfg.family == "vlm" else 0)
        out = {"tokens": ((b, s_text), torch.int32)}
        if cell.kind == "train":
            out["labels"] = ((b, s_text), torch.int32)
        if cfg.family == "vlm":
            out["image_embeds"] = ((b, cfg.n_patches, cfg.d_model), torch.bfloat16)
        if cfg.family == "encdec":
            out["frames"] = ((b, cfg.n_frames, cfg.d_model), torch.bfloat16)
        return out
    # decode: one new token against a cache of length s
    return {"tokens": ((b, 1), torch.int32), "positions": ((b, 1), torch.int32)}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def make_train_step(model: Model, cell: ShapeCell, *, adam: Optional[AdamConfig] = None,
                    compute_dtype=torch.bfloat16):
    """``(params_fp32, opt_state, batch) -> (params, opt_state, loss)``.

    ``params`` and ``opt_state`` are updated in place and returned; ``loss``
    is the microbatches' mean, a 0-d float32 tensor on the params' device.
    """
    adam = adam or AdamConfig(lr=3e-4, clip_norm=1.0, weight_decay=0.0)
    mb = cell.microbatch or cell.global_batch
    n_micro = max(1, cell.global_batch // mb)

    def train_step(params, opt_state, batch):
        leaves = [t for _, t in param_leaves(params)]
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        try:
            loss = None
            for i in range(n_micro):
                micro = (batch if n_micro == 1 else
                         {k: v.reshape((n_micro, mb) + v.shape[1:])[i]
                          for k, v in batch.items()})
                m_loss = model.loss(cast_params_for_compute(params, compute_dtype), micro)
                m_loss.backward()
                m_loss = m_loss.detach()
                loss = m_loss if loss is None else loss + m_loss
            # a leaf the loss does not reach: a zero gradient, as JAX's
            grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in leaves]
        finally:
            for t in leaves:
                t.grad = None
                t.requires_grad_(False)
        if n_micro > 1:
            loss = loss / n_micro
            for g in grads:
                g.div_(n_micro)
        params, opt_state = adam_update(grads, opt_state, params, adam)
        return params, opt_state, loss

    return train_step


def make_prefill_step(model: Model, cell: ShapeCell):
    def prefill(params, batch):
        return model.prefill(params, batch, cell.seq_len)
    return prefill


def make_decode_step(model: Model, cell: ShapeCell):
    def decode(params, batch, caches):
        return model.decode(params, batch, caches)
    return decode
