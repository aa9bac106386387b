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
  masters through the cast, as JAX's do. Built under a host mesh's
  activation context, it is the sharded step of the training plan
  (:func:`make_sharded_train_step`, :mod:`repro_torch.sharding.fsdp`).

:func:`batch_template` gives each cell's batch as shapes and dtypes, and
the dry-run's :func:`abstract_params`, :func:`abstract_caches` and
:func:`abstract_opt_state` the reference's ``jax.eval_shape`` trees: the
stacked layout (:func:`repro_torch.convert.lm_stacked_layout`) with a
:class:`~repro_torch.convert.StackedLeaf` (shape and dtype name) per
array, built on the ``meta`` device, so nothing is allocated (qwen3-moe's
fp32 masters alone are 122 GB).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ShapeCell
from repro_torch.convert import _STACKED, StackedLeaf, lm_stacked_layout
from repro_torch.core.esrnn import param_leaves
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import Model
from repro_torch.sharding import ctx
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
# abstract inputs (the dry-run's)
# ---------------------------------------------------------------------------


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: an ``init`` that draws
    from it and allocates on its device makes shapes and dtypes only."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_params(model: Model, *, master_fp32: bool):
    """``model``'s params in the reference's stacked layout, shapes and
    dtypes only; with ``master_fp32`` the bf16 leaves as float32 (the fp32
    masters of training)."""
    layout = lm_stacked_layout(model.init(_MetaGenerator()))

    def master(tree):
        if isinstance(tree, dict):
            return {k: master(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [master(v) for v in tree]
        return StackedLeaf(tree.shape, "float32") if tree.dtype == "bfloat16" else tree

    return master(layout) if master_fp32 else layout


def _stack_parts(parts):
    first = parts[0]
    if hasattr(first, "_fields"):
        return type(first)(*(_stack_parts([getattr(p, f) for p in parts])
                             for f in first._fields))
    return StackedLeaf((len(parts),) + first.shape, first.dtype)


def _cache_layout(tree):
    if isinstance(tree, dict):
        return {k: _cache_layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _stack_parts([_cache_layout(v) for v in tree])
    if hasattr(tree, "_fields"):
        return type(tree)(*(_cache_layout(getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, int):                  # a cache's fill: int32 in the reference
        return StackedLeaf((), "int32")
    return StackedLeaf(tree.shape, str(tree.dtype).removeprefix("torch."))


def abstract_caches(model: Model, cell: ShapeCell):
    """The bf16 caches of ``cell`` (``global_batch`` x ``seq_len``) in the
    reference's stacked layout: a cache per layer stacked on ``(L,)`` (the
    hybrid's Mamba2 caches on ``(G, K)``), its fill an int32 of ``(L,)``."""
    return _cache_layout(model.make_caches(cell.global_batch, cell.seq_len, torch.bfloat16,
                                           "meta"))


def abstract_opt_state(params_abs):
    """Adam's state for ``params_abs``: float32 ``mu`` and ``nu`` of every
    leaf's shape and an int32 ``step`` (the reference's ``adam_init``)."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [zeros(v) for v in tree]
        return StackedLeaf(tree.shape, "float32")

    return {"mu": zeros(params_abs), "nu": zeros(params_abs), "step": StackedLeaf((), "int32")}


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def make_train_step(model: Model, cell: ShapeCell, *, adam: Optional[AdamConfig] = None,
                    compute_dtype=torch.bfloat16):
    """``(params_fp32, opt_state, batch) -> (params, opt_state, loss)``.

    ``params`` and ``opt_state`` are updated in place and returned; ``loss``
    is the microbatches' mean, a 0-d float32 tensor on the params' device.

    Built inside a host mesh's activation context
    (:func:`repro_torch.sharding.ctx.activation_sharding`) of more than one
    rank, the step is the sharded one (:func:`make_sharded_train_step`):
    ``params`` and ``opt_state`` are then this rank's shards and ``batch``
    the global batch.
    """
    adam = adam or AdamConfig(lr=3e-4, clip_norm=1.0, weight_decay=0.0)
    mb = cell.microbatch or cell.global_batch
    n_micro = max(1, cell.global_batch // mb)
    mesh = (ctx.current() or {}).get("mesh")
    if hasattr(mesh, "axis") and mesh.shape["data"] * mesh.shape["model"] > 1:
        return make_sharded_train_step(model, cell, mesh, adam=adam,
                                       compute_dtype=compute_dtype)

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


def make_sharded_train_step(model: Model, cell: ShapeCell, mesh, *,
                            adam: Optional[AdamConfig] = None, compute_dtype=torch.bfloat16):
    """The train step on a host ``mesh``: FSDP on ``data``, tensor and
    expert parallelism on ``model`` (:class:`repro_torch.sharding.fsdp.TrainPlan`,
    built from the model's shapes on the ``meta`` device; the step's
    ``plan``). ``(masters, opt_state, batch) -> (masters, opt_state,
    loss)``: this rank's fp32 master shards and Adam state (``plan.shard``,
    ``plan.shard_list``), updated in place, and the global batch, of which
    each ``data`` rank takes its rows of every microbatch (the MoE aux loss
    is a function of a microbatch's token means). Each microbatch gathers
    the compute params (``plan.compute_params``) and runs the loss under a
    training context, its gradient reduce-scattered to the shards; then the
    leaves whole on ``data`` are all-reduced there, the losses summed over
    ``data``, and Adam runs on the shards with the global norm
    (``plan.sq_reduce``). ``loss`` is the global one, on every rank."""
    from repro_torch.sharding.fsdp import TrainPlan

    adam = adam or AdamConfig(lr=3e-4, clip_norm=1.0, weight_decay=0.0)
    mb = cell.microbatch or cell.global_batch
    n_micro = max(1, cell.global_batch // mb)
    plan = TrainPlan(model.cfg, mesh, model.init(_MetaGenerator()))
    rows = plan.rows(mb)

    def train_step(masters, opt_state, batch):
        leaves = [t for _, t in param_leaves(masters)]
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        try:
            loss = None
            with ctx.activation_sharding(mesh, dp="data", tp="model", train=True):
                for i in range(n_micro):
                    micro = {k: v[i * mb:(i + 1) * mb][rows] for k, v in batch.items()}
                    m_loss = model.loss(plan.compute_params(masters, compute_dtype), micro)
                    m_loss.backward()
                    m_loss = m_loss.detach()
                    loss = m_loss if loss is None else loss + m_loss
            grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in leaves]
        finally:
            for t in leaves:
                t.grad = None
                t.requires_grad_(False)
        plan.reduce_whole_on_data(grads)
        if mesh.shape["data"] > 1:
            loss = mesh.axis("data").all_reduce(loss.clone())
        if n_micro > 1:
            loss = loss / n_micro
            for g in grads:
                g.div_(n_micro)
        masters, opt_state = adam_update(grads, opt_state, masters, adam,
                                         sq_reduce=plan.sq_reduce)
        return masters, opt_state, loss

    train_step.plan = plan
    return train_step


def make_prefill_step(model: Model, cell: ShapeCell):
    def prefill(params, batch):
        return model.prefill(params, batch, cell.seq_len)
    return prefill


def make_decode_step(model: Model, cell: ShapeCell):
    def decode(params, batch, caches):
        return model.decode(params, batch, caches)
    return decode
