"""Bucketed forecast dispatch: pad-to-bucket batching (PyTorch port).

Counterpart of ``repro.forecast.serving``. Requests arrive with ragged
history lengths and ragged batch sizes; the dispatcher snaps each history to
a length bucket (left-padded with its first value, the section-8.1
convention; longer histories keep their most recent ``max(bucket)``
observations, counted in ``ServeStats.truncated_series``) and each group to
a batch bucket (padded by repeating the last row), so the device only ever
sees ``len(length_buckets) * len(batch_buckets)`` distinct shapes.

The JAX package counts XLA compiles per shape; the port runs eagerly, so
``ServeStats.compiles``/``cache_hits`` are the dispatcher's bucket-shape
accounting, ``ServeStats.launch_shapes`` the distinct ``(kernel, input
shapes, dtype)`` keys its dispatches actually issued (a
:class:`~repro_torch.kernels.shapes.LaunchShapeCounter` armed around the
first dispatch of each distinct input shape: the forecast's kernel shapes
follow from its input shapes alone, so a repeat adds no key and runs
unarmed; the counterpart of the reference's ``xla_compiles``), and
``ServeStats.kernel_launches`` how many times each CUDA kernel ran on
behalf of the served batches. The dispatcher declares a budget of distinct
shapes (``compile_budget``, by default the bucket grid's size), and
:func:`check_compile_budget` holds ``ServeStats.compiles`` to it; the
kernels' keys are bounded by ``compile_budget x``
:func:`bucket_launch_shapes`.

Per-series HW parameters are looked up by ``series_id`` for series seen at
fit time; unknown series fall back to a primer row (alpha = gamma = 0.5,
flat seasonality -- section 3.3), the cold-start behaviour of a forecast
service. The table is snapshot to host memory once; per-request resolution
is a numpy row gather and only the gathered ``(B, ...)`` rows move to the
device. With a series mesh (``mesh=``) every rank serves the same request
stream: the batch buckets are snapped up to the mesh multiple at
construction, each rank forecasts its rows of every bucket
(:func:`~repro_torch.sharding.series.esrnn_forecast_dp`) and every rank
returns the same responses. The deprecated ``BatchedForecastServer`` is not
ported.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import params_to_device
from repro_torch.core.esrnn import ESRNNConfig, esrnn_forecast
from repro_torch.core.holt_winters import hw_init_params
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.shapes import CompileBudgetExceeded, LaunchShapeCounter
from repro_torch.sharding.series import esrnn_forecast_dp
from repro_torch.train.host_table import HostStateTable

log = logging.getLogger("repro_torch.forecast.serving")

# latency samples kept for the percentile estimate (FIFO window)
_LATENCY_WINDOW = 65536


@dataclasses.dataclass
class ForecastRequest:
    """One series to forecast: raw history + category + optional identity.

    ``y=None`` is allowed when ``series_id`` is set and the serving layer
    tracks that series' history online (the server's ``observe`` verb); the
    dispatcher itself requires a resolved history.
    """

    y: Optional[np.ndarray] = None   # (T,) strictly positive history
    category: int = 0
    series_id: Optional[int] = None  # row in the fitted per-series table


@dataclasses.dataclass
class ServeStats:
    """Serving counters + latency/queue telemetry (single writer)."""

    requests: int = 0
    batches: int = 0
    compiles: int = 0                # distinct bucket shapes dispatched
    compile_budget: Optional[int] = None  # len(length) x len(batch buckets)
    cache_hits: int = 0              # dispatches of an already-seen shape
    launch_shapes: int = 0           # distinct kernel launch shapes issued
    repeat_launch_shapes: int = 0    # of those, first issued by a dispatch of an
                                     # already-seen bucket shape (0 while the
                                     # buckets bound what the kernels see)
    padded_series: int = 0           # batch-padding rows added (wasted lanes)
    truncated_series: int = 0        # histories longer than the largest
                                     # length bucket (served on the tail)
    observes: int = 0                # online observations absorbed
    write_batches: int = 0           # batched write-absorption passes
    finetunes: int = 0               # idle incremental fine-tune runs
    queue_depth: int = 0             # gauge: pending requests at last pass
    queue_peak: int = 0              # high-water mark of the request queue
    total_s: float = 0.0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    latencies_s: Deque[float] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_LATENCY_WINDOW),
        repr=False)

    @property
    def requests_per_s(self) -> float:
        return self.requests / self.total_s if self.total_s > 0 else 0.0

    def record_latency(self, seconds: float) -> None:
        self.latencies_s.append(seconds)

    def note_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth
        self.queue_peak = max(self.queue_peak, depth)

    def note_launches(self, before: Dict[str, int], after: Dict[str, int]) -> None:
        for name, count in after.items():
            self.kernel_launches[name] = (self.kernel_launches.get(name, 0)
                                          + count - before.get(name, 0))

    def reset(self) -> None:
        """Zero every counter and drop the latency window (the budget stays,
        and so do the launch shapes already seen, as a kernel cache would)."""
        self.requests = self.batches = self.compiles = self.cache_hits = 0
        self.launch_shapes = self.repeat_launch_shapes = 0
        self.padded_series = self.truncated_series = 0
        self.observes = self.write_batches = self.finetunes = 0
        self.queue_depth = self.queue_peak = 0
        self.total_s = 0.0
        self.kernel_launches.clear()
        self.latencies_s.clear()

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p95/p99 of the recorded request latencies, in milliseconds.

        NaN (not 0.0) when nothing has been recorded.
        """
        if not self.latencies_s:
            nan = float("nan")
            return {"p50_ms": nan, "p95_ms": nan, "p99_ms": nan}
        lat_ms = np.asarray(self.latencies_s, np.float64) * 1e3
        p50, p95, p99 = np.percentile(lat_ms, [50.0, 95.0, 99.0])
        return {"p50_ms": float(p50), "p95_ms": float(p95),
                "p99_ms": float(p99)}


def check_compile_budget(stats: ServeStats, budget: Optional[int] = None) -> int:
    """Hold ``stats.compiles`` (distinct bucket shapes dispatched) to
    ``budget`` (default ``stats.compile_budget``); returns the count, or
    raises :class:`CompileBudgetExceeded` past it."""
    if budget is None:
        budget = stats.compile_budget
    if budget is None:
        raise ValueError("no compile budget declared on stats or passed in")
    if stats.compiles > budget:
        raise CompileBudgetExceeded(
            f"serving dispatched {stats.compiles} distinct bucket shapes, over the "
            f"declared budget of {budget} ({stats.cache_hits} repeats)")
    return stats.compiles


def bucket_launch_shapes(config: ESRNNConfig) -> int:
    """Distinct kernel keys one bucket's forecast issues.

    K1 once, for the single-ring HW scan (``seasonality2 == 0``; the double
    ring runs no kernel), plus, for a head with the dilated LSTM stack (lstm,
    esn), K3 once per distinct ``(d, I)`` over its layers: the layer of
    dilation d runs every step on ``B * d`` rows (``core/drnn.py``), its
    input width I is ``input_size + n_categories`` for the first layer and
    ``hidden_size`` after. The ssm head adds none. For the quarterly preset
    ((1, 2), (4, 8), I = 14 then 40): 1 + 4 = 5.
    """
    n = 1 if config.seasonality2 == 0 else 0
    if config.head in ("lstm", "esn"):
        dilations = [d for block in config.dilations for d in block]
        widths = ([config.input_size + config.n_categories]
                  + [config.hidden_size] * (len(dilations) - 1))
        n += len(set(zip(dilations, widths)))
    return n


def _pick_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value; the largest bucket when value exceeds all."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


class BucketDispatcher:
    """The serving core: shape, resolve, and dispatch one bucket on ``device``.

    ``device`` defaults to the card; the shared weights are copied there once
    (the caller's modules are not moved), the HW table is snapshot to host.
    ``mesh``: a series mesh to shard every bucket over (its device is this
    rank's); ``compile_budget``: the declared bound on distinct bucket
    shapes (default: len(length buckets) x len(batch buckets)); the kernel
    launch shapes those buckets can issue are bounded by
    ``launch_shape_budget``.
    """

    def __init__(
        self,
        config: ESRNNConfig,
        params,
        *,
        length_buckets: Tuple[int, ...] = (32, 64, 128, 256),
        batch_buckets: Tuple[int, ...] = (1, 4, 16, 64),
        max_batch: Optional[int] = None,
        mesh=None,
        stats: Optional[ServeStats] = None,
        compile_budget: Optional[int] = None,
        device=None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        min_len = config.input_size + max(config.seasonality, 1)
        self.length_buckets = tuple(sorted(max(b, min_len) for b in length_buckets))
        if self.mesh is not None:
            # every padded chunk still lands on a bucket that divides the
            # mesh, so max_batch and the shape budget keep their meaning
            d = self.mesh.size
            batch_buckets = {b + (-b) % d for b in batch_buckets}
        self.batch_buckets = tuple(sorted(batch_buckets))
        # a chunk must always fit the largest batch bucket
        self.max_batch = min(max_batch or self.batch_buckets[-1],
                             self.batch_buckets[-1])
        self.stats = stats if stats is not None else ServeStats()
        # the bound on distinct dispatch shapes the bucketing guarantees
        self.compile_budget = (compile_budget if compile_budget is not None
                               else len(self.length_buckets) * len(self.batch_buckets))
        self.stats.compile_budget = self.compile_budget
        self._seen_shapes = set()
        self._launch_shape_counter = LaunchShapeCounter(stats=self.stats)
        self._counted_inputs = set()     # the y shapes a dispatch was counted on
        # the kernel keys the bucket grid can issue
        self.launch_shape_budget = self.compile_budget * bucket_launch_shapes(config)
        self._warned_truncation = False
        self.set_params(params)

    # -- params / host table -------------------------------------------------

    def set_params(self, params) -> None:
        """(Re)install params and rebuild the host-side HW-table snapshot."""
        self.params = params_to_device(
            {k: v for k, v in params.items() if k != "hw"}, self.device)
        self.n_known = params["hw"].alpha_logit.shape[0]
        # row n_known of the extended view is the cold-start primer row
        primer = hw_init_params(1, self.config.seasonality,
                                seasonality2=self.config.seasonality2,
                                dtype=self.config.tdtype, device="cpu")
        self._host_table = HostStateTable.from_hw(params["hw"])
        self._hw_table = self._host_table.extended(primer)

    # -- shaping -------------------------------------------------------------

    def pick_length_bucket(self, n_obs: int) -> int:
        """Length bucket for a history of ``n_obs``, counting truncation."""
        b = _pick_bucket(n_obs, self.length_buckets)
        if n_obs > self.length_buckets[-1]:
            self.stats.truncated_series += 1
            if not self._warned_truncation:
                self._warned_truncation = True
                log.warning(
                    "history of %d observations exceeds the largest length "
                    "bucket (%d); serving on the most recent %d (counted in "
                    "ServeStats.truncated_series; further truncations are "
                    "counted silently)", n_obs, b, b)
        return b

    def shape_history(self, y: np.ndarray, bucket: int) -> np.ndarray:
        y = np.asarray(y, np.float32)
        if len(y) >= bucket:
            return y[-bucket:]
        pad = np.full(bucket - len(y), y[0], np.float32)
        return np.concatenate([pad, y])

    def resolve_row(self, series_id: Optional[int]) -> int:
        """Extended-table row for a request: fitted row or the primer row."""
        if series_id is not None and 0 <= series_id < self.n_known:
            return int(series_id)
        return self.n_known

    def hw_rows(self, requests: Sequence[ForecastRequest]):
        """Per-request HW rows (numpy): fitted rows, primer for unknown ids."""
        idx = np.asarray([self.resolve_row(r.series_id) for r in requests])
        return self._hw_table.rows(idx)

    # -- dispatch ------------------------------------------------------------

    def pad_batch(self, requests: List[ForecastRequest], bb: int) -> List[ForecastRequest]:
        """``requests`` padded to the batch bucket ``bb`` by repeating the last."""
        return requests + [requests[-1]] * (bb - len(requests))

    def run_bucket(self, requests: List[ForecastRequest], bucket: int):
        """Forecast one length-bucket group, padded to a batch bucket."""
        n = len(requests)
        bb = _pick_bucket(n, self.batch_buckets)
        padded = self.pad_batch(requests, bb)
        self.stats.padded_series += len(padded) - n

        y = np.stack([self.shape_history(r.y, bucket) for r in padded])
        cats = np.zeros((len(padded), self.config.n_categories), np.float32)
        for row, r in enumerate(padded):
            # out-of-range category -> all-zero one-hot (cold start)
            if 0 <= r.category < self.config.n_categories:
                cats[row, r.category] = 1.0

        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        params = dict(self.params, hw=self.hw_rows(padded).map(to_dev))

        shape = (bb, bucket)
        repeat = shape in self._seen_shapes
        if repeat:
            self.stats.cache_hits += 1
        else:
            self._seen_shapes.add(shape)
            self.stats.compiles += 1
        before = kernel_ops.launch_counts()
        shapes_before = self.stats.launch_shapes
        # y's shape fixes every kernel key of the forecast: count its first
        # dispatch only
        counted = y.shape in self._counted_inputs
        self._counted_inputs.add(y.shape)
        with contextlib.nullcontext() if counted else self._launch_shape_counter:
            if self.mesh is None:
                fc = esrnn_forecast(self.config, params, to_dev(y), to_dev(cats))
            else:
                fc = esrnn_forecast_dp(self.config, params, to_dev(y), to_dev(cats),
                                       mesh=self.mesh)
        if repeat:
            self.stats.repeat_launch_shapes += self.stats.launch_shapes - shapes_before
        out = fc.cpu().numpy()[:n]
        self.stats.note_launches(before, kernel_ops.launch_counts())
        self.stats.batches += 1
        return out

    def forecast_batch(
        self, requests: Sequence[ForecastRequest]
    ) -> List[np.ndarray]:
        """Serve a batch of ragged requests synchronously, in order.

        Groups by length bucket, chunks by ``max_batch``, dispatches each
        chunk through :meth:`run_bucket`; one (H,) forecast per request.
        """
        t0 = time.perf_counter()
        groups: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            if r.y is None:
                raise ValueError(
                    "ForecastRequest.y is required for batch serving; "
                    "history-less series_id requests need the online "
                    "ForecastServer (repro_torch.forecast.server)")
            groups.setdefault(
                self.pick_length_bucket(len(r.y)), []).append(i)

        out: List[Optional[np.ndarray]] = [None] * len(requests)
        for bucket, idxs in sorted(groups.items()):
            for lo in range(0, len(idxs), self.max_batch):
                chunk = idxs[lo:lo + self.max_batch]
                fc = self.run_bucket([requests[i] for i in chunk], bucket)
                for j, i in enumerate(chunk):
                    out[i] = fc[j]
        dt = time.perf_counter() - t0
        self.stats.requests += len(requests)
        self.stats.total_s += dt
        if requests:
            # batch wall-time attributed to each request
            per_req = dt / len(requests)
            for _ in requests:
                self.stats.record_latency(per_req)
        return out  # type: ignore[return-value]


def synthetic_request_stream(
    config: ESRNNConfig, n_requests: int, *, n_known: int = 0, seed: int = 0,
    len_range: Tuple[int, int] = (20, 200),
) -> List[ForecastRequest]:
    """Ragged request stream for smoke/benchmark runs (lognormal level walks).

    Deterministic in ``seed`` and bitwise the same stream as the JAX
    package's (numpy ``default_rng`` draws in the same order).
    """
    rng = np.random.default_rng(seed)
    m = max(config.seasonality, 1)
    reqs = []
    for i in range(n_requests):
        t = int(rng.integers(*len_range))
        drift = rng.normal(0, 0.002, t).cumsum()
        seas = np.tile(np.exp(rng.normal(0, 0.08, m)), t // m + 1)[:t]
        y = np.exp(np.log(rng.uniform(50, 500)) + drift) * seas
        y = np.maximum(y * np.exp(rng.normal(0, 0.03, t)), 1e-3)
        sid = int(rng.integers(0, n_known)) if n_known and rng.random() < 0.5 else None
        reqs.append(ForecastRequest(
            y=y.astype(np.float32),
            category=int(rng.integers(0, config.n_categories)),
            series_id=sid,
        ))
    return reqs
