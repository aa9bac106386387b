"""The launch-shape hook of the kernel entry points, and its counter.

Each entry point of the port's kernels reports the key ``(kernel, input
shapes, dtype)`` of every call here before it runs: K1 and K2 from
:class:`~repro_torch.kernels.hw_scan.HWScan`, K3 from
:func:`~repro_torch.kernels.ops.lstm_cell`, K4 and K5 (full or dx-only)
from :class:`~repro_torch.kernels.lstm_cell.LSTMCell`, K6 from
:func:`~repro_torch.kernels.ops.flash_attention`. The plain versions pass
through the same points, so a CPU run reports the keys a card run launches.
Keys are counted apart from the launch counters of
:func:`~repro_torch.kernels.ops.launch_counts`.

A :class:`LaunchShapeCounter` receives the keys while it is armed; with
none armed a call pays the one check in :func:`note`. The serving
dispatcher arms one (``ServeStats.launch_shapes``) and
:mod:`repro_torch.analysis.recompile` re-exports it for the auditor.
"""

from __future__ import annotations

import contextlib
import threading

_armed: tuple = ()          # the armed counters; replaced whole under _lock
_lock = threading.Lock()


class CompileBudgetExceeded(AssertionError):
    """Serving dispatched more distinct bucket shapes than it declared."""


def note(kernel: str, *tensors) -> None:
    """Report one call of ``kernel`` on ``tensors``, its stream first (the
    key's dtype is the first tensor's)."""
    armed = _armed
    if armed:
        key = (kernel, tuple(tuple(t.shape) for t in tensors),
               str(tensors[0].dtype).removeprefix("torch."))
        for counter in armed:
            counter._see(key)


class LaunchShapeCounter:
    """Context manager counting new kernel launch shapes while armed.

    Counts every kernel call in the process during the armed window, on any
    thread (the ``fc[:n]`` family was invisible to per-callable
    accounting). The keys seen persist across armings, so re-arming one
    counter around each dispatch counts each shape once, as a kernel cache
    would. ``stats``: a :class:`~repro_torch.forecast.serving.ServeStats`
    whose ``launch_shapes`` mirrors the count.
    """

    def __init__(self, stats=None):
        self.count = 0
        self.seen = set()
        self._stats = stats

    def _see(self, key) -> None:
        if key in self.seen:
            return
        with _lock:
            if key not in self.seen:
                self.seen.add(key)
                self.count += 1
                if self._stats is not None:
                    self._stats.launch_shapes += 1

    def __enter__(self) -> "LaunchShapeCounter":
        global _armed
        with _lock:
            _armed = _armed + (self,)
        return self

    def __exit__(self, *exc) -> None:
        global _armed
        with _lock:
            i = len(_armed) - 1 - _armed[::-1].index(self)
            _armed = _armed[:i] + _armed[i + 1:]

    @contextlib.contextmanager
    def expect(self, budget: int, what: str = "hot path"):
        """Fail if the wrapped region issues more than ``budget`` new shapes::

            with counter, counter.expect(budget=len(grid), what="serving waves"):
                drive_requests()
        """
        before = self.count
        yield self
        grew = self.count - before
        if grew > budget:
            raise CompileBudgetExceeded(
                f"{what} issued {grew} new kernel launch shapes, over its declared "
                f"budget of {budget}: an unbounded shape family on a hot path (the "
                f"reference's fc[:n] bug class)")
