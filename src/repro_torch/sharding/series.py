"""Series data parallelism on ``torch.distributed`` (port of ``repro.sharding.series``).

The reference is one controller driving every device: ``shard_map`` splits a
batch's rows over a 1-D ``series`` mesh axis in contiguous blocks, the
per-series HW rows stay device-local, the shared RNN/head weights are
replicated and the transpose of replication all-reduces their gradients.
``torch.distributed`` is SPMD instead -- every rank runs the same program --
so the port keeps the same split of the work with state replicated:

* every rank holds the same params, optimizer state and full HW table (for
  the chunked fit, the same host table), builds the same data from the seed
  and draws the same global batch schedule;
* rank ``r`` of ``d`` computes the contiguous rows ``[r B/d, (r+1) B/d)`` of
  each batch of ``B`` rows, as ``P("series")`` assigns them;
* the loss is the exact global masked mean: one ``all_reduce`` of the three
  scalars ``(pinball_sum, valid_count, penalties)``; each rank then
  backpropagates its local objective ``pinball_sum_r / max(C, 1) +
  penalties_r / d`` (``C`` the reduced count, taken without a gradient);
* one ``all_reduce`` (sum) of a single flat float32 buffer then gives every
  rank the global gradient: the gradients of the batch's gathered HW rows
  (zero outside the rank's own rows, so the sum is exact) and of the
  trainable shared weights. Clipping and Adam run identically on every
  rank, so after every step every rank's state is bit-identical;
* the ``*_dp`` functions below take batches that divide the mesh, as the
  reference's do (:func:`check_series_divisible`); the estimator's verbs
  and the trainer's validation split any row count into contiguous blocks
  (:meth:`SeriesMesh.block`, ``numpy.array_split``'s split), so no row is
  padded, and reduce the blocks' outputs once;
* inference runs each rank's rows with no collective in the forward pass;
  the full ``(N, ...)`` result that every rank returns (the counterpart of
  reading the reference's sharded array back) comes from one ``all_reduce``
  of a zero-filled buffer in which each rank filled its own rows -- exact,
  and the same call on NCCL and on gloo with CUDA tensors;
* eval and backtest reduce their metric terms once.

Collectives per call (:attr:`SeriesMesh.counts`, by op; the CPU tests and
``chip_smoke.py`` assert these numbers):

====================================================  ==============
call                                                  collectives
====================================================  ==============
train step (dense or sparse, each step of a           2 ``all_reduce``
superstep, the chunked fit's steps): the loss terms,
the gradient buffer
:func:`esrnn_forecast_dp`, :func:`esrnn_predict_stats_dp`  1 ``all_reduce``
:func:`esrnn_eval_dp`                                 1 ``all_reduce``
:func:`esrnn_backtest_dp` (forecasts and the (4, K)   1 ``all_reduce``
terms in one buffer)
the trainer's validation sMAPE (resident or chunked)  1 ``all_reduce``
the estimator's ``predict``, ``predict_quantiles``,   1 ``all_reduce``
``evaluate``, ``backtest`` (resident or chunked)
a checkpoint save (rank 0 writes, the others wait)    1 ``barrier``
====================================================  ==============

A barrier is an ``all_reduce`` of one element whose value the host reads,
counted apart. A mesh of one rank is never built by the entry points: a
1-device mesh degenerates to the single-device path, as in the reference.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import losses as L
from repro_torch.core.esrnn import (
    ESRNNConfig, esrnn_forecast, esrnn_forecast_at, esrnn_loss_terms_fn,
    esrnn_predict_stats, value_and_grad,
)

SERIES_AXIS = "series"

# the calls of a train step, an inference call and an eval/backtest, as the
# module docstring's table gives them
STEP_COLLECTIVES = {"all_reduce": 2}
FORECAST_COLLECTIVES = {"all_reduce": 1}
EVAL_COLLECTIVES = {"all_reduce": 1}
BACKTEST_COLLECTIVES = {"all_reduce": 1}
VERB_COLLECTIVES = {"all_reduce": 1}        # each of the estimator's verbs

_LAUNCHER = ("start the ranks with repro_torch.sharding.run_ranks (or torchrun) "
             "and call torch.distributed.init_process_group first")


class SeriesMesh:
    """A 1-D ``series`` mesh over the ranks of a process group.

    ``rank``, ``size`` and ``device`` (this rank's device) describe it;
    every collective the port issues goes through :meth:`all_reduce` or
    :meth:`barrier`, which count it in :attr:`counts` by op.
    """

    axis_names = (SERIES_AXIS,)

    def __init__(self, group, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        self.counts: collections.Counter = collections.Counter()

    def __repr__(self) -> str:
        return (f"SeriesMesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")

    # -- counted collectives -------------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        self.counts["all_reduce"] += 1
        dist.all_reduce(t, group=self.group)
        return t

    def barrier(self) -> None:
        """Every rank waits here until all have arrived."""
        self.counts["barrier"] += 1
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.group)
        t.item()                       # the host waits for the reduction

    def reset_counts(self) -> None:
        self.counts.clear()

    def collective_counts(self) -> Dict[str, int]:
        return dict(self.counts)

    # -- row blocks ------------------------------------------------------------

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows (``n`` divides the mesh)."""
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def block(self, lo: int, hi: int) -> Tuple[int, int]:
        """This rank's part of the rows ``[lo, hi)`` when they need not
        divide the mesh: contiguous blocks, the first ``(hi - lo) % size``
        one row longer (``numpy.array_split``'s split)."""
        n = hi - lo
        b, extra = divmod(n, self.size)
        start = lo + self.rank * b + min(self.rank, extra)
        return start, start + b + (self.rank < extra)

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The ``(n, ...)`` tensor whose :meth:`rows` are each rank's
        ``local``: one :meth:`all_reduce` of a zero-filled float32 buffer."""
        buf = torch.zeros((n,) + tuple(local.shape[1:]), dtype=torch.float32,
                          device=local.device)
        buf[self.rows(n)] = local.float()
        return self.all_reduce(buf).to(local.dtype)


def make_series_mesh(n_devices: Optional[int] = None, *, group=None,
                     device=None) -> SeriesMesh:
    """The series mesh over an initialized process group (default: the
    world). ``device`` defaults to ``cuda:(rank % device_count)``; the CPU
    tests pass ``device="cpu"``. Raises :class:`ValueError` when no process
    group is initialized or its size is not ``n_devices``."""
    if not (dist.is_available() and dist.is_initialized()):
        want = "" if n_devices is None else f" of {n_devices} ranks"
        raise ValueError(f"no torch.distributed process group{want} is initialized: "
                         + _LAUNCHER)
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"requested a {n_devices}-device series mesh but the process "
                         f"group has {size} ranks: " + _LAUNCHER)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_series_mesh places each rank on a card by default, and "
                               "this host has none; pass device='cpu'")
        device = torch.device("cuda", dist.get_rank(group) % torch.cuda.device_count())
    return SeriesMesh(group, device)


def esrnn_param_specs(params) -> Dict[str, Optional[str]]:
    """Per top-level group: :data:`SERIES_AXIS` for the per-series table
    (each rank computes on its own rows of it), ``None`` for the replicated
    shared weights -- the reference's ``P("series")`` and ``P()``."""
    return {k: (SERIES_AXIS if k == "hw" else None) for k in params}


def check_series_divisible(n: int, mesh: SeriesMesh) -> int:
    """The sharded paths need the batch to divide the mesh evenly."""
    d = mesh.size
    if n % d:
        raise ValueError(
            f"series batch of {n} does not divide the {d}-device "
            f"'{'/'.join(mesh.axis_names)}' mesh; pick a batch size that is "
            f"a multiple of {d}")
    return d


def _local(params, rows: slice):
    """The rank's rows of the per-series groups, the shared groups whole."""
    specs = esrnn_param_specs(params)
    return {k: (v.map(lambda a: a[rows]) if specs[k] else v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


class _GlobalValue(torch.autograd.Function):
    """Forward: the reduced global loss; backward: the gradient passes to
    the rank's local objective unchanged (its sum over the ranks, which the
    gradient all-reduce takes, is the global loss's gradient)."""

    @staticmethod
    def forward(ctx, local_objective, global_loss):
        return global_loss.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def esrnn_loss_dp(cfg: ESRNNConfig, params, y, cats, mask=None, *, mesh: SeriesMesh):
    """The series-data-parallel training loss, exact global masked mean.

    ``params`` is the *batch* params tree (HW rows gathered for the batch);
    ``y``/``cats``/``mask`` lead with the same series axis, which the mesh
    must divide. The rank scores its block of rows
    (``esrnn_loss_terms_fn``); one all-reduce of ``(pinball_sum,
    valid_count, penalties)`` gives ``S / max(C, 1) + P / d`` on every rank.
    The returned scalar holds that value, and differentiating it gives the
    rank's share of the global gradient (zero for rows of other ranks);
    :func:`esrnn_loss_and_grad_dp` sums the shares.
    """
    n = y.shape[0]
    check_series_divisible(n, mesh)
    rows = mesh.rows(n)
    pin_sum, pin_cnt, pen = esrnn_loss_terms_fn(
        cfg, _local(params, rows), y[rows], cats[rows], None if mask is None else mask[rows])
    terms = torch.stack([pin_sum.detach(), pin_cnt.detach(), pen.detach()]).float()
    s, c, p = mesh.all_reduce(terms).unbind()
    denom = torch.clamp_min(c, 1.0)
    local_objective = pin_sum / denom + pen / mesh.size
    return _GlobalValue.apply(local_objective, s / denom + p / mesh.size)


def value_and_grad_dp(loss_fn, leaves, mesh: SeriesMesh):
    """``(loss, grads)`` of a :func:`esrnn_loss_dp`-valued ``loss_fn()``
    w.r.t. ``leaves``, the rank's gradient shares summed over the ranks by
    one all-reduce of a single flat float32 buffer."""
    loss, grads = value_and_grad(loss_fn, leaves)
    flat = mesh.all_reduce(torch.cat([g.reshape(-1).float() for g in grads]))
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return loss, out


def esrnn_loss_and_grad_dp(cfg: ESRNNConfig, params, y, cats, mask=None, *,
                           mesh: SeriesMesh):
    """``(loss, grads)`` of :func:`esrnn_loss_dp`, ``grads`` in
    ``param_leaves(params)`` order and equal on every rank; every leaf must
    require a gradient."""
    from repro_torch.core.esrnn import param_leaves

    return value_and_grad_dp(lambda: esrnn_loss_dp(cfg, params, y, cats, mask, mesh=mesh),
                             [t for _, t in param_leaves(params)], mesh)


# ---------------------------------------------------------------------------
# Inference: forecast / quantile stats / eval / backtest
# ---------------------------------------------------------------------------


def esrnn_forecast_dp(cfg: ESRNNConfig, params, y, cats, *, mesh: SeriesMesh):
    """Sharded h-step forecast: each rank forecasts its own rows (no
    collective in the forward pass); every rank returns the full ``(N, H)``,
    gathered by one all-reduce."""
    n = y.shape[0]
    check_series_divisible(n, mesh)
    rows = mesh.rows(n)
    return mesh.gather_rows(esrnn_forecast(cfg, _local(params, rows), y[rows], cats[rows]), n)


def esrnn_predict_stats_dp(cfg: ESRNNConfig, params, y, cats, *, mesh: SeriesMesh):
    """Sharded ``(forecast (N, H), quantile sigma (N, 1))``, both gathered
    by one all-reduce."""
    n = y.shape[0]
    check_series_divisible(n, mesh)
    rows = mesh.rows(n)
    fc, sigma = esrnn_predict_stats(cfg, _local(params, rows), y[rows], cats[rows])
    both = mesh.gather_rows(torch.cat([fc.float(), sigma.float()], dim=1), n)
    return both[:, :fc.shape[1]].to(fc.dtype), both[:, fc.shape[1]:].to(sigma.dtype)


def esrnn_eval_dp(cfg: ESRNNConfig, params, y, cats, target, insample, *,
                  seasonality: int, mesh: SeriesMesh):
    """Sharded sMAPE/MASE of the model forecast as exact global means.

    Each rank forecasts its rows and contributes its metric sums and valid
    counts; one all-reduce of the four terms, divided once, gives
    ``{"smape", "mase"}`` on every rank.
    """
    n, h = y.shape[0], target.shape[1]
    check_series_divisible(n, mesh)
    rows = mesh.rows(n)
    fc = esrnn_forecast(cfg, _local(params, rows), y[rows], cats[rows])[:, :h]
    s_sum, s_cnt = L.smape_terms(fc, target[rows])
    m_sum, m_cnt = L.mase_terms(fc, target[rows], insample[rows], seasonality)
    s_sum, s_cnt, m_sum, m_cnt = mesh.all_reduce(
        torch.stack([s_sum, s_cnt, m_sum, m_cnt]).float()).unbind()
    return {"smape": 200.0 * s_sum / torch.clamp_min(s_cnt, 1.0),
            "mase": m_sum / torch.clamp_min(m_cnt, 1.0)}


def esrnn_backtest_dp(cfg: ESRNNConfig, params, y, cats, origins, target, tmask, *,
                      seasonality: int, mesh: SeriesMesh):
    """Sharded rolling-origin forecasts and metric terms in one pass.

    ``target``/``tmask`` are (N, K, H) scoring windows and their validity
    masks (0 past the series end). Returns ``(fc (N, K,
    H), (s_sum, s_cnt, m_sum, m_cnt))``, the terms (K,) summed over the
    ranks: the forecasts and the terms travel in one all-reduce.
    """
    origins = tuple(int(o) for o in origins)
    n = y.shape[0]
    check_series_divisible(n, mesh)
    rows = mesh.rows(n)
    fc = esrnn_forecast_at(cfg, _local(params, rows), y[rows], cats[rows], origins)
    terms = torch.stack(L.rolling_metric_terms(fc, target[rows], tmask[rows], y[rows],
                                               origins, seasonality)).float()
    size = n * fc[0].numel()
    buf = torch.zeros(size + terms.numel(), dtype=torch.float32, device=fc.device)
    buf[rows.start * fc[0].numel():rows.stop * fc[0].numel()] = fc.reshape(-1).float()
    buf[size:] = terms.reshape(-1)
    mesh.all_reduce(buf)
    fc_all = buf[:size].view((n,) + tuple(fc.shape[1:])).to(fc.dtype)
    return fc_all, tuple(buf[size:].view(terms.shape).unbind())
