"""Training steps and engines for the ES-RNN (PyTorch port of ``repro.train.engine``).

* :func:`make_step_fn` -- one training step ``(params, opt_state, idx) ->
  (params, opt_state, loss)`` over the batch rows ``idx`` of the full series
  tensors: the loss (:func:`~repro_torch.core.esrnn.esrnn_loss_fn`; on the
  card its backward runs the kernels K2 and K5), the gradients, and dense or
  sparse two-group Adam (:mod:`repro_torch.train.optimizer`).
* :func:`make_online_step_fn` -- the same step over a batch passed in as
  tensors (the serving fine-tune hook).
* :func:`make_superstep_fn` -- K steps whose losses stay on the device and
  come back as one ``(K,)`` tensor, so the caller syncs with the host once
  per K steps. The trainer's per-step engine is the superstep at K = 1, so
  both walk the same trajectory. (Capturing a superstep into a CUDA
  graph, the counterpart of the reference's one ``lax.scan`` dispatch, is
  later speed work.)
* :func:`make_chunk_step_fn` / :func:`make_chunk_superstep_fn` -- the
  out-of-core fit's step and superstep: the sparse step over one chunk's
  rows, with the chunk's series tensors passed in.
* with a series mesh, the steps are series-data-parallel
  (:mod:`repro_torch.sharding.series`), and the dense step takes int8
  error-feedback gradient compression (``compress``);
* :func:`segment_steps` -- chops ``[start, n_steps)`` into superstep
  segments that end on every eval/checkpoint boundary.

Steps update ``params`` and ``opt_state`` in place and return them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, FrozenSet, Iterator, List, Tuple

import torch
from torch import nn

from repro_torch.core.esrnn import (
    ESRNNConfig, combine_series, esrnn_loss_fn, param_leaves, partition_series,
    value_and_grad,
)
from repro_torch.train.optimizer import (
    AdamConfig, adam_update, adam_update_sparse, esrnn_group_fn,
)

StepFn = Callable


def split_frozen(params, frozen: FrozenSet[str]):
    """Split a params dict by top-level key into (trainable, frozen).

    The head registry (``heads.frozen_param_groups``) names the groups a
    head keeps fixed; steps differentiate and update the trainable part
    only, and optimizer state covers exactly that part.
    """
    return ({k: v for k, v in params.items() if k not in frozen},
            {k: v for k, v in params.items() if k in frozen})


@contextlib.contextmanager
def _fixed(groups):
    """The frozen groups' parameters with no gradient requirement for the
    body of a step, then as they were. The loss then builds no graph to
    them (under bf16 the policy's cast of a fixed weight is a plain copy),
    so autograd asks no weight gradient of their kernels: on the card the
    esn reservoir's backward launches K5's dx-only kernel, while dx still
    flows through it to the HW parameters upstream of the windows."""
    leaves = [p for g in groups.values() if isinstance(g, nn.Module) for p in g.parameters()]
    was = [p.requires_grad for p in leaves]
    for p in leaves:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, r in zip(leaves, was):
            p.requires_grad_(r)


def _value_and_grad(loss_fn: Callable[[], torch.Tensor],
                    leaves: List[torch.Tensor]):
    """:func:`~repro_torch.core.esrnn.value_and_grad`, marking the leaves as
    requiring a gradient first (the HW table is drawn without)."""
    for t in leaves:
        t.requires_grad_(True)
    return value_and_grad(loss_fn, leaves)


def _loss_and_grads(mcfg, batch_params, loss_args, leaves, mesh):
    """The loss and its gradients w.r.t. ``leaves``; with a ``mesh`` the
    series-data-parallel loss, the gradients summed over the ranks by one
    all-reduce (:func:`~repro_torch.sharding.series.value_and_grad_dp`)."""
    if mesh is None:
        return _value_and_grad(lambda: esrnn_loss_fn(mcfg, batch_params, *loss_args), leaves)
    from repro_torch.sharding.series import esrnn_loss_dp, value_and_grad_dp

    for t in leaves:
        t.requires_grad_(True)
    return value_and_grad_dp(
        lambda: esrnn_loss_dp(mcfg, batch_params, *loss_args, mesh=mesh), leaves, mesh)


def _row_grads(mcfg, params, frozen, rows, loss_args, mesh):
    """The loss and the gradients of the trainable leaves w.r.t. the
    gathered rows ``rows`` (the HW leaves hold the batch's rows only):
    ``(p_train, p_froz, loss, grads)``."""
    p_train, p_froz = split_frozen(params, frozen)
    hw_rows, shared = partition_series(params, rows)
    sh_train, sh_froz = split_frozen(shared, frozen)
    batch_train = combine_series(hw_rows, sh_train)
    with _fixed(sh_froz):
        loss, grads = _loss_and_grads(mcfg, {**batch_train, **sh_froz}, loss_args,
                                      [t for _, t in param_leaves(batch_train)], mesh)
    return p_train, p_froz, loss, grads


def _sparse_update(mcfg, cfg_adam, params, opt_state, frozen, rows, loss_args, mesh=None):
    """Gradients w.r.t. the gathered rows ``rows``; segment Adam on them."""
    p_train, p_froz, loss, grads = _row_grads(mcfg, params, frozen, rows, loss_args, mesh)
    p_train, opt_state = adam_update_sparse(
        grads, opt_state, p_train, cfg_adam, idx=rows, group_fn=esrnn_group_fn)
    return {**p_train, **p_froz}, opt_state, loss


def _dense_update(mcfg, cfg_adam, params, opt_state, frozen, rows, loss_args, mesh=None,
                  compress=False):
    """Dense Adam over the full table; with ``compress`` the shared-weight
    gradients go through int8 error-feedback compression first and
    ``opt_state`` is ``(adam_state, residuals)``."""
    p_train, p_froz, loss, grads = _row_grads(mcfg, params, frozen, rows, loss_args, mesh)
    # the rows' gradients scattered over the full table, as autograd's
    # backward of the row gather accumulates them
    grads = [torch.zeros_like(p, dtype=g.dtype).index_add_(0, rows, g) if path[0] == "hw"
             else g for (path, p), g in zip(param_leaves(p_train), grads, strict=True)]
    if compress:
        from repro_torch.train.grad_compression import batch_generator, compress_tree_int8

        opt_state, err = opt_state
        shared = [path[0] != "hw" for path, _ in param_leaves(p_train)]
        # the batch's own noise: a resumed run, and every rank, draws the
        # same noise at the same step
        g_sh, err = compress_tree_int8([g for g, s in zip(grads, shared) if s], err,
                                       batch_generator(rows))
        it = iter(g_sh)
        grads = [next(it) if s else g for g, s in zip(grads, shared)]
    p_train, opt_state = adam_update(grads, opt_state, p_train, cfg_adam,
                                     group_fn=esrnn_group_fn)
    if compress:
        opt_state = (opt_state, err)
    return {**p_train, **p_froz}, opt_state, loss


def make_step_fn(
    mcfg: ESRNNConfig,
    cfg_adam: AdamConfig,
    y_all,
    cats_all,
    mask_all,
    *,
    mesh=None,
    sparse: bool = False,
    frozen: FrozenSet[str] = frozenset(),
    compress: bool = False,
) -> StepFn:
    """Build the training step the per-step loop and the superstep share.

    ``y_all``/``cats_all``/``mask_all`` are the full series tensors on the
    training device; the step receives only the batch's row indices.
    ``sparse`` takes the gradients w.r.t. the gathered rows and updates only
    those rows (:func:`~repro_torch.train.optimizer.adam_update_sparse`);
    otherwise the gradient scatters over the full table and dense Adam runs
    over it. ``frozen`` names top-level groups left untrained; ``opt_state``
    must cover exactly the rest.

    ``mesh`` (a :class:`~repro_torch.sharding.series.SeriesMesh`) makes it
    the series-data-parallel step: every rank computes its block of the
    batch's rows (:func:`~repro_torch.sharding.series.esrnn_loss_dp`), the
    gradients are summed over the ranks in one flat all-reduce, and the
    update runs identically on every rank. ``compress`` turns on int8
    error-feedback compression of the shared-weight gradients
    (:mod:`repro_torch.train.grad_compression`); ``opt_state`` is then
    ``(adam_state, residuals)``, the residuals over the shared trainable
    leaves. Dense optimizer path only, as in the reference.
    """
    if sparse and compress:
        raise ValueError(
            "compress=True requires the dense optimizer path: the sparse "
            "segment update only ever touches per-series HW rows locally, "
            "so there is no shared-gradient exchange to compress")

    def step(params, opt_state, idx):
        loss_args = (y_all[idx], cats_all[idx], mask_all[idx])
        if sparse:
            return _sparse_update(mcfg, cfg_adam, params, opt_state, frozen, idx, loss_args,
                                  mesh)
        return _dense_update(mcfg, cfg_adam, params, opt_state, frozen, idx, loss_args,
                             mesh, compress)

    return step


def make_online_step_fn(
    mcfg: ESRNNConfig,
    cfg_adam: AdamConfig,
    *,
    sparse: bool = True,
    frozen: FrozenSet[str] = frozenset(),
) -> StepFn:
    """Training step over an ad-hoc batch: the serving fine-tune hook.

    ``step(params, opt_state, y, cats, mask, rows)``: the batch arrives as
    tensors and ``rows`` names the HW-table rows its series belong to. With
    ``sparse`` (the serving shape) Adam touches exactly those rows.
    """
    update = _sparse_update if sparse else _dense_update

    def step(params, opt_state, y, cats, mask, rows):
        return update(mcfg, cfg_adam, params, opt_state, frozen, rows,
                      (y, cats, mask))

    return step


def make_chunk_step_fn(
    mcfg: ESRNNConfig,
    cfg_adam: AdamConfig,
    *,
    mesh=None,
    frozen: FrozenSet[str] = frozenset(),
) -> StepFn:
    """The chunked fit's training step.

    ``step(params, opt_state, y_c, cats_c, mask_c, idx)``: the sparse
    step's math (gathered-row gradients, segment Adam with the closed-form
    moment catch-up), where ``(y_c, cats_c, mask_c)`` are the current
    chunk's series tensors and ``params``/``opt_state`` the chunk-assembled
    state: the ``hw`` leaves, their moments and ``t_hw`` hold the chunk's
    rows only (``idx`` is chunk-local), while the shared weights and the
    global step count persist across chunks. ``t_hw`` carries global
    last-touch steps, which makes the per-chunk updates exact. ``mesh`` as
    in :func:`make_step_fn`.
    """
    def step(params, opt_state, y_c, cats_c, mask_c, idx):
        return _sparse_update(mcfg, cfg_adam, params, opt_state, frozen, idx,
                              (y_c[idx], cats_c[idx], mask_c[idx]), mesh)

    return step


def make_chunk_superstep_fn(step_fn: StepFn) -> StepFn:
    """:func:`make_superstep_fn` over one chunk: ``(params, opt_state, y_c,
    cats_c, mask_c, idx_schedule (K, B)) -> (params, opt_state, losses
    (K,))``, the chunk's tensors passed through to every step unchanged."""
    def superstep(params, opt_state, y_c, cats_c, mask_c, idx_schedule):
        losses = []
        for idx in idx_schedule:
            params, opt_state, loss = step_fn(params, opt_state, y_c, cats_c,
                                              mask_c, idx)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return superstep


def make_superstep_fn(step_fn: StepFn) -> StepFn:
    """K steps with the losses kept on the device.

    ``(params, opt_state, idx_schedule (K, B)) -> (params, opt_state,
    losses (K,))``: the same steps in the same order as K calls of
    ``step_fn``, with no host sync inside; the caller reads ``losses`` once.
    """
    def superstep(params, opt_state, idx_schedule):
        losses = []
        for idx in idx_schedule:
            params, opt_state, loss = step_fn(params, opt_state, idx)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return superstep


def next_boundary(step: int, n_steps: int, *everys: int) -> int:
    """First step strictly after ``step`` where eval/ckpt may fire."""
    cands = [n_steps]
    for e in everys:
        if e and e > 0:
            cands.append((step // e + 1) * e)
    return min(c for c in cands if c > step)


def segment_steps(
    start_step: int,
    n_steps: int,
    scan_steps: int,
    *everys: int,
) -> Iterator[Tuple[int, int]]:
    """Yield ``(step, K)`` superstep segments covering [start_step, n_steps).

    Every eval/checkpoint boundary (multiples of the ``everys``, plus
    ``n_steps``) is a segment end, so host-side work fires at the same
    global steps as in the per-step loop.
    """
    step = start_step
    while step < n_steps:
        limit = next_boundary(step, n_steps, *everys)
        k = min(max(1, scan_steps), limit - step)
        yield step, k
        step += k
