"""The continuous-batching forecast server: queue -> bucket fill -> dispatch.

Port of ``repro.forecast.server.engine``. Requests trickle in one at a time;
serving them one at a time would waste the card (a batch-1 forecast costs
nearly the wall time of a batch-64 one through the same kernels), so
:class:`ForecastServer` runs the standard continuous-batching loop:

* **bounded request queue** -- ``submit`` enqueues a request and returns a
  :class:`ForecastFuture`; a full queue blocks the submitter (backpressure).
* **dynamic bucket fill with a max-wait deadline** -- a length-bucket group
  is dispatched as soon as it fills a batch, or when its oldest request has
  waited ``max_wait_ms``.
* **batched dispatch** through the shared
  :class:`~repro_torch.forecast.serving.BucketDispatcher`, on its device, or
  sharded over a series mesh (``mesh=``). A sharded server is driven
  synchronously (``step``/``drain``/``forecast_batch``), so every rank makes
  the same dispatch decisions; the background thread's deadlines would
  not. The fine-tune then runs replicated, the same on every rank.
* **online state ingestion** -- ``observe`` enqueues
  :class:`~repro_torch.forecast.server.state.ObserveWrite` records; the
  scheduler absorbs the write queue before every dispatch, so a forecast
  submitted after an ``observe`` conditions on the new value
  (read-your-writes).
* **idle fine-tune** -- with ``ServerConfig.finetune_steps > 0``, once per
  drained busy period an
  :class:`~repro_torch.forecast.server.finetune.IdleFineTuner` burst runs a
  few sparse-Adam steps on the freshest observed series (on the server's
  device), installs the result in the dispatcher and re-rolls those series'
  online state under the new parameters.

The scheduler is single-threaded (one dispatching thread, or the caller's
thread via :meth:`ForecastServer.step`/:meth:`ForecastServer.drain` for
deterministic tests); the only lock is the queue's condition variable.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.esrnn import ESRNNConfig
from repro_torch.forecast.serving import (
    BucketDispatcher, ForecastRequest, ServeStats, check_compile_budget,
)
from repro_torch.forecast.server.finetune import IdleFineTuner
from repro_torch.forecast.server.state import ObserveWrite, OnlineStateStore


class QueueFull(RuntimeError):
    """The bounded request queue stayed full past the submit timeout."""


@dataclasses.dataclass
class ServerConfig:
    """Continuous-batching knobs (the serving analogue of a TrainConfig)."""

    max_queue: int = 1024          # bounded request queue (backpressure)
    max_wait_ms: float = 5.0       # deadline: oldest request's max hold time
    max_batch: Optional[int] = None   # per-dispatch cap (None: largest bucket)
    history_cap: Optional[int] = None  # online store tail (None: largest
                                       # length bucket -- what forecasts use)
    compile_budget: Optional[int] = None  # declared bound on distinct bucket
                                       # shapes (None: length x batch
                                       # bucket-grid size)
    # idle fine-tune hook (0 steps = off)
    finetune_steps: int = 0
    finetune_batch: int = 32
    finetune_lr: float = 1e-4
    finetune_hw_lr_ratio: float = 10.0
    finetune_min_history: Optional[int] = None


class ForecastFuture:
    """Handle for one submitted request: blocks on :meth:`result`."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, value: np.ndarray) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("forecast not ready within timeout")
        if self._error is not None:
            raise self._error
        return self._value


@dataclasses.dataclass
class _Pending:
    request: ForecastRequest
    future: ForecastFuture
    arrival: float               # perf_counter at submit


class ForecastServer:
    """Continuous-batching serving front end over the shared dispatcher.

    Use either threaded (``start()`` / ``submit`` / ``observe`` / ``stop()``)
    or synchronously (``submit``+``step(force=True)`` or the
    ``forecast_batch`` compatibility call) -- the scheduler pass is the same
    code path, so tests drive it deterministically without threads.
    """

    def __init__(
        self,
        config: ESRNNConfig,
        params,
        *,
        server_config: Optional[ServerConfig] = None,
        length_buckets: Tuple[int, ...] = (32, 64, 128, 256),
        batch_buckets: Tuple[int, ...] = (1, 4, 16, 64),
        mesh=None,
        device=None,
    ):
        self.config = config
        self.server_config = server_config or ServerConfig()
        sc = self.server_config
        self.stats = ServeStats()
        self.dispatcher = BucketDispatcher(
            config, params, length_buckets=length_buckets,
            batch_buckets=batch_buckets, max_batch=sc.max_batch, mesh=mesh,
            stats=self.stats, compile_budget=sc.compile_budget, device=device)
        cap = (sc.history_cap if sc.history_cap is not None
               else self.dispatcher.length_buckets[-1])
        self.store = OnlineStateStore(
            config, lambda: self.dispatcher._hw_table,
            self.dispatcher.n_known, history_cap=cap)
        self.tuner = None
        if sc.finetune_steps > 0:
            self.tuner = IdleFineTuner(
                config, params, steps=sc.finetune_steps,
                batch=sc.finetune_batch,
                window=self.dispatcher.length_buckets[-1],
                lr=sc.finetune_lr, hw_lr_ratio=sc.finetune_hw_lr_ratio,
                min_history=sc.finetune_min_history,
                device=self.dispatcher.device)

        self._cond = threading.Condition()
        self._pending: List[_Pending] = []
        self._writes: List[ObserveWrite] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._active_since_tune = False

    # -- client surface ------------------------------------------------------

    def submit(self, request: ForecastRequest,
               timeout: Optional[float] = None) -> ForecastFuture:
        """Enqueue a request; returns its future immediately.

        Blocks (backpressure) while the bounded queue is full; raises
        :class:`QueueFull` if it stays full past ``timeout``.
        """
        fut = ForecastFuture()
        entry = _Pending(request, fut, time.perf_counter())
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while len(self._pending) >= self.server_config.max_queue:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise QueueFull(
                        f"request queue held {len(self._pending)} >= "
                        f"max_queue={self.server_config.max_queue} past "
                        f"the submit timeout")
                if not self._cond.wait(timeout=remaining):
                    raise QueueFull(
                        f"request queue held {len(self._pending)} >= "
                        f"max_queue={self.server_config.max_queue} past "
                        f"the submit timeout")
            self._pending.append(entry)
            self.stats.note_queue_depth(len(self._pending))
            self._cond.notify_all()
        return fut

    def observe(self, series_id: int, y: float,
                category: Optional[int] = None) -> None:
        """Ingest one new observation for ``series_id`` (async, batched).

        Returns immediately; the write is absorbed into the online HW state
        by the scheduler before the next dispatch, so any forecast submitted
        after this call conditions on the new value (read-your-writes).
        """
        with self._cond:
            self._writes.append(ObserveWrite(int(series_id), float(y),
                                             category))
            self._cond.notify_all()

    def forecast_batch(
        self, requests: Sequence[ForecastRequest]
    ) -> List[np.ndarray]:
        """Compatibility verb: submit all, force-drain, return in order."""
        futs = [self.submit(r) for r in requests]
        if self._thread is None:
            self.drain()
        return [f.result() for f in futs]

    def check_compile_budget(self) -> int:
        """Hold the distinct bucket shapes served (``ServeStats.compiles``)
        to the declared budget: raises
        :class:`~repro_torch.forecast.serving.CompileBudgetExceeded` past it,
        returns the count otherwise."""
        return check_compile_budget(self.stats)

    # -- scheduler -----------------------------------------------------------

    def _absorb_writes(self) -> int:
        with self._cond:
            writes, self._writes = self._writes, []
        if not writes:
            return 0
        n = self.store.absorb(writes, self.dispatcher.resolve_row)
        self.stats.observes += n
        self.stats.write_batches += 1
        return n

    def _resolve_history(self, entry: _Pending) -> Optional[np.ndarray]:
        """Request history: explicit ``y``, else the online store's tail."""
        r = entry.request
        if r.y is not None:
            return np.asarray(r.y, np.float32)
        hist = (None if r.series_id is None
                else self.store.history(r.series_id))
        if hist is None or len(hist) == 0:
            entry.future.set_exception(ValueError(
                f"request for series {r.series_id} has no history: pass y "
                f"explicitly or observe() the series first"))
            return None
        return hist

    def step(self, force: bool = False) -> Tuple[int, Optional[float]]:
        """One scheduler pass: absorb writes, dispatch due bucket groups.

        Returns ``(completed, next_deadline)`` -- the number of requests
        answered and the ``perf_counter`` time at which the oldest remaining
        request hits its ``max_wait_ms`` deadline (None when the queue is
        empty). ``force`` dispatches everything regardless of fill/deadline
        (the drain / synchronous path).
        """
        self._absorb_writes()

        with self._cond:
            pending, self._pending = self._pending, []
        if not pending:
            self._maybe_finetune()
            return 0, None

        # group by length bucket, resolving online histories after the write
        # absorption above (read-your-writes ordering)
        groups: Dict[int, List[Tuple[_Pending, np.ndarray]]] = {}
        for entry in pending:
            hist = self._resolve_history(entry)
            if hist is None:
                continue
            b = self.dispatcher.pick_length_bucket(len(hist))
            groups.setdefault(b, []).append((entry, hist))

        now = time.perf_counter()
        max_wait_s = self.server_config.max_wait_ms / 1e3
        max_batch = self.dispatcher.max_batch
        completed = 0
        leftover: List[_Pending] = []
        for bucket in sorted(groups):
            entries = groups[bucket]
            due = (force or len(entries) >= max_batch
                   or now - min(e.arrival for e, _ in entries) >= max_wait_s)
            if not due:
                leftover.extend(e for e, _ in entries)
                continue
            t0 = time.perf_counter()
            for lo in range(0, len(entries), max_batch):
                chunk = entries[lo:lo + max_batch]
                reqs = [dataclasses.replace(e.request, y=h)
                        for e, h in chunk]
                try:
                    fc = self.dispatcher.run_bucket(reqs, bucket)
                except Exception as err:     # the batch fails, not the server
                    for e, _ in chunk:
                        e.future.set_exception(err)
                    continue
                done_t = time.perf_counter()
                for j, (e, _) in enumerate(chunk):
                    e.future.set_result(fc[j])
                    self.stats.record_latency(done_t - e.arrival)
                completed += len(chunk)
            self.stats.total_s += time.perf_counter() - t0
        self.stats.requests += completed
        if completed:
            self._active_since_tune = True

        with self._cond:
            # leftover groups go back in arrival order, ahead of anything
            # submitted during the dispatch
            leftover.sort(key=lambda e: e.arrival)
            self._pending = leftover + self._pending
            self.stats.note_queue_depth(len(self._pending))
            if completed:
                self._cond.notify_all()   # wake blocked submitters
            next_deadline = (min(e.arrival for e in self._pending)
                             + max_wait_s if self._pending else None)
            empty = not self._pending and not self._writes
        if empty:
            self._maybe_finetune()
        return completed, next_deadline

    def drain(self) -> int:
        """Force-dispatch until the queue and write backlog are empty."""
        total = 0
        while True:
            with self._cond:
                if not self._pending and not self._writes:
                    return total
            done, _ = self.step(force=True)
            total += done

    def _maybe_finetune(self) -> None:
        """Idle hook: one fine-tune burst per drained busy period."""
        if self.tuner is None or not self._active_since_tune:
            return
        self._active_since_tune = False
        params, rows = self.tuner.run(self.store, self.dispatcher.n_known)
        if rows:
            # the dispatcher snapshots the HW rows to host and shares the
            # tuner's shared weights; both change only inside a burst, on
            # this (the scheduler's) thread
            self.dispatcher.set_params(params)
            self.store.refresh(rows)
            self.stats.finetunes += 1

    # -- background thread ---------------------------------------------------

    def start(self) -> "ForecastServer":
        """Run the scheduler on a background thread (idempotent)."""
        if self._thread is not None:
            return self
        if self.dispatcher.mesh is not None:
            raise RuntimeError(
                "a server sharded over a series mesh is driven synchronously "
                "(step/drain/forecast_batch): every rank must make the same "
                "dispatch decisions, which the thread's deadlines do not give")
        self._stop = False
        self._thread = threading.Thread(
            target=self._serve_loop, name="forecast-server", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler thread, optionally force-draining first."""
        thread = self._thread
        if thread is None:
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        thread.join()
        self._thread = None
        if drain:
            self.drain()

    def __enter__(self) -> "ForecastServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                if not self._pending and not self._writes:
                    self._cond.wait(timeout=0.05)
                    if self._stop:
                        return
            _, next_deadline = self.step()
            if next_deadline is not None:
                # queue holds requests not yet due: sleep to the deadline
                # unless new arrivals top a batch up first
                delay = next_deadline - time.perf_counter()
                if delay > 0:
                    with self._cond:
                        if not self._stop:
                            self._cond.wait(timeout=delay)
