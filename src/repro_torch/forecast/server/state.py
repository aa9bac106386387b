"""Online Holt-Winters state ingestion: the server's resident state table.

Port of ``repro.forecast.server.state`` (numpy only, with the port's own
:func:`repro_torch.core.holt_winters.hw_step`). The per-series half of the
model is a one-step recurrence, so the server ingests a new observation and
rolls that series' (level, seasonal rings) state forward in place, O(1) per
write, with no refit and no pass over the history.

:class:`OnlineStateStore` keeps, per tracked series id:

* the **history tail** (most recent ``history_cap`` observations, float32)
  -- what the batched forecast pass consumes,
* the **rolled HW state** ``(level, s_ring, s2_ring)`` after the *full*
  observed history -- exact even once the tail is truncated,
* the category and the resolved row in the extended HW table (fitted row
  for known ids, the cold-start primer row otherwise).

All arithmetic is host-side numpy float32 in the expression order of the
scan, so the write path never touches a device. Writes are absorbed in
batches (:meth:`OnlineStateStore.absorb`); series with a single pending
write roll in one vectorized ``hw_step`` across the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.esrnn import ESRNNConfig
from repro_torch.core.holt_winters import hw_step


@dataclasses.dataclass
class ObserveWrite:
    """One queued observation: series ``series_id`` gained value ``y``."""

    series_id: int
    y: float
    category: Optional[int] = None   # sticky: None keeps the known category


def _sigmoid32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return (1.0 / (1.0 + np.exp(-x, dtype=np.float32))).astype(np.float32)


@dataclasses.dataclass
class SeriesState:
    """Rolled Holt-Winters state + history tail for one tracked series."""

    series_id: int
    row: int                      # row in the extended HW table
    category: int
    # constrained per-series smoothing parameters (f32, cached at prime time)
    alpha: np.float32
    gamma: np.float32
    gamma2: Optional[np.float32]
    init_s_ring: np.ndarray       # (m,) constrained initial ring
    init_s2_ring: np.ndarray      # (m2,)
    # rolled state; level is None until the first observation arrives
    level: Optional[np.float32] = None
    s_ring: np.ndarray = None     # type: ignore[assignment]
    s2_ring: np.ndarray = None    # type: ignore[assignment]
    t: int = 0                    # total observations absorbed (full history)
    history: List[float] = dataclasses.field(default_factory=list)
    truncated: bool = False       # tail dropped observations beyond the cap
    last_write: int = -1          # store write counter at last observation

    def __post_init__(self):
        if self.s_ring is None:
            self.s_ring = self.init_s_ring.copy()
        if self.s2_ring is None:
            self.s2_ring = self.init_s2_ring.copy()

    def history_array(self) -> np.ndarray:
        return np.asarray(self.history, np.float32)

    def future_seasonal(self, m: int) -> np.ndarray:
        """Combined future factors s_T .. s_{T+m-1} (both rings, tiled).

        Mirrors the ``future`` construction of ``hw_smooth``: the shorter
        second ring tiles up to the primary period, and the product is what
        de-seasonalization uses -- directly comparable to
        ``hw_smooth(y_full)[1][:, T:]``.
        """
        m2 = len(self.s2_ring)
        reps = (m + m2 - 1) // m2
        return (self.s_ring[:m]
                * np.tile(self.s2_ring, reps)[:m]).astype(np.float32)


class OnlineStateStore:
    """Host-side table of rolled HW states, keyed by series id.

    ``table`` returns the current host HW-table snapshot (the dispatcher's
    extended fitted-plus-primer view), read when a series is first seen and
    again on :meth:`refresh` after an idle fine-tune changed the table.
    """

    def __init__(
        self,
        config: ESRNNConfig,
        table: Callable[[], object],
        n_known: int,
        *,
        history_cap: int,
    ):
        self.config = config
        self._table = table
        self.n_known = n_known
        self.history_cap = int(history_cap)
        self._states: Dict[int, SeriesState] = {}
        self._seasonal = config.seasonality > 1
        self._dual = config.seasonality2 > 1
        self._writes = 0   # monotone write counter (recency ordering)

    # -- introspection -------------------------------------------------------

    def __contains__(self, series_id: int) -> bool:
        return series_id in self._states

    def __len__(self) -> int:
        return len(self._states)

    def get(self, series_id: int) -> Optional[SeriesState]:
        return self._states.get(series_id)

    def history(self, series_id: int) -> Optional[np.ndarray]:
        st = self._states.get(series_id)
        return st.history_array() if st is not None else None

    # -- registration --------------------------------------------------------

    def recently_observed(
        self, *, rows_below: Optional[int] = None, min_history: int = 0,
    ) -> List[SeriesState]:
        """Tracked series, most recently written first (fine-tune candidates).

        ``rows_below`` keeps only series with a fitted table row below it
        (cold-start primer series have no row of their own to fine-tune);
        ``min_history`` drops series whose stored tail is too short to form
        a training window.
        """
        states = [
            st for st in self._states.values()
            if (rows_below is None or st.row < rows_below)
            and len(st.history) >= min_history]
        return sorted(states, key=lambda st: st.last_write, reverse=True)

    def _constrained_row(self, row: int):
        hw = self._table()
        alpha = _sigmoid32(hw.alpha_logit[row])
        gamma = _sigmoid32(hw.gamma_logit[row])
        if self._seasonal:
            s_ring = np.exp(np.asarray(hw.init_seas_logit[row], np.float32))
        else:
            s_ring = np.ones(
                max(self.config.seasonality, 1), np.float32)
        if self._dual:
            gamma2 = _sigmoid32(hw.gamma2_logit[row])
            s2_ring = np.exp(
                np.asarray(hw.init_seas_logit2[row], np.float32))
        else:
            gamma2 = None
            s2_ring = np.ones(1, np.float32)
        return alpha, gamma, gamma2, s_ring.astype(np.float32), s2_ring.astype(np.float32)

    def ensure(self, series_id: int, *, row: int,
               category: Optional[int] = None) -> SeriesState:
        """Get-or-create the state for ``series_id`` (resolved table ``row``)."""
        st = self._states.get(series_id)
        if st is None:
            alpha, gamma, gamma2, s_ring, s2_ring = self._constrained_row(row)
            st = SeriesState(
                series_id=series_id, row=row, category=category or 0,
                alpha=alpha, gamma=gamma, gamma2=gamma2,
                init_s_ring=s_ring, init_s2_ring=s2_ring)
            self._states[series_id] = st
        if category is not None:
            st.category = category
        return st

    # -- the write path ------------------------------------------------------

    def _roll_one(self, st: SeriesState, y: float) -> None:
        """Apply one observation to a state (the scalar hw_step path)."""
        y32 = np.float32(y)
        if st.level is None:
            # primer estimate, exactly as hw_smooth: the first observation
            # de-seasonalized by the initial ring heads the recurrence
            st.level = np.float32(y32 / (st.s_ring[0] * st.s2_ring[0]))
        l_t, s_new, s2_new = hw_step(
            y32, st.level, st.s_ring[0], st.s2_ring[0],
            st.alpha, st.gamma, st.gamma2,
            seasonal=self._seasonal, dual=self._dual)
        st.level = np.float32(l_t)
        st.s_ring = np.roll(st.s_ring, -1)
        st.s_ring[-1] = s_new
        st.s2_ring = np.roll(st.s2_ring, -1)
        st.s2_ring[-1] = s2_new
        self._note_obs(st, y32)

    def _note_obs(self, st: SeriesState, y32: np.float32) -> None:
        self._writes += 1
        st.last_write = self._writes
        st.t += 1
        st.history.append(float(y32))
        if len(st.history) > self.history_cap:
            del st.history[:len(st.history) - self.history_cap]
            st.truncated = True

    def absorb(self, writes: Sequence[ObserveWrite],
               resolve_row: Callable[[Optional[int]], int]) -> int:
        """Absorb a batch of writes; returns the number applied.

        Series with exactly ONE pending write and an already-primed state --
        the steady-state shape of a live write stream -- roll together in a
        single vectorized ``hw_step`` over the write batch; everything else
        (first-ever observations, multi-write bursts, which must apply in
        order) takes the scalar path. Both paths are the same f32
        expression, so the split is invisible in the numbers.
        """
        if not writes:
            return 0
        by_sid: Dict[int, List[ObserveWrite]] = {}
        for w in writes:
            self.ensure(int(w.series_id), row=resolve_row(w.series_id),
                        category=w.category)
            by_sid.setdefault(int(w.series_id), []).append(w)

        fast = [sid for sid, ws in by_sid.items()
                if len(ws) == 1 and self._states[sid].level is not None]
        if len(fast) > 1:
            sts = [self._states[s] for s in fast]
            y = np.asarray([by_sid[s][0].y for s in fast], np.float32)
            lvl = np.asarray([st.level for st in sts], np.float32)
            s_t = np.asarray([st.s_ring[0] for st in sts], np.float32)
            s2_t = np.asarray([st.s2_ring[0] for st in sts], np.float32)
            alpha = np.asarray([st.alpha for st in sts], np.float32)
            gamma = np.asarray([st.gamma for st in sts], np.float32)
            gamma2 = (np.asarray([st.gamma2 for st in sts], np.float32)
                      if self._dual else None)
            l_t, s_new, s2_new = hw_step(
                y, lvl, s_t, s2_t, alpha, gamma, gamma2,
                seasonal=self._seasonal, dual=self._dual)
            s2_new = np.broadcast_to(np.asarray(s2_new, np.float32), l_t.shape)
            for i, st in enumerate(sts):
                st.level = np.float32(l_t[i])
                st.s_ring = np.roll(st.s_ring, -1)
                st.s_ring[-1] = np.float32(s_new[i])
                st.s2_ring = np.roll(st.s2_ring, -1)
                st.s2_ring[-1] = np.float32(s2_new[i])
                self._note_obs(st, np.float32(y[i]))
            slow = [s for s in by_sid if s not in set(fast)]
        else:
            slow = list(by_sid)

        for sid in slow:
            st = self._states[sid]
            for w in by_sid[sid]:
                self._roll_one(st, w.y)
        return sum(len(ws) for ws in by_sid.values())

    # -- seeding + fine-tune refresh -----------------------------------------

    def seed(self, series_id: int, history: Iterable[float], *, row: int,
             category: Optional[int] = None) -> SeriesState:
        """Register a series with an existing history (warm start).

        The history is rolled through the same recurrence one observation at
        a time, so a seeded series is indistinguishable from one built up by
        ``observe`` calls.
        """
        st = self.ensure(series_id, row=row, category=category)
        for y in np.asarray(history, np.float32):
            self._roll_one(st, y)
        return st

    def refresh(self, rows: Optional[Sequence[int]] = None) -> int:
        """Re-prime states after the HW table changed under them.

        The idle fine-tune updates per-series smoothing parameters in the
        fitted table; a state rolled under the OLD parameters no longer
        matches a fresh pass under the new ones, so affected series re-pull
        their constrained row and replay their stored history tail. (Post-
        refresh the invariant is "state == pass over the *stored* history"
        -- for a truncated tail the pre-truncation prefix is gone, which is
        exactly what the batched forecast conditions on anyway.)
        """
        rows_set = None if rows is None else set(int(r) for r in rows)
        n = 0
        for st in self._states.values():
            if rows_set is not None and st.row not in rows_set:
                continue
            alpha, gamma, gamma2, s_ring, s2_ring = self._constrained_row(st.row)
            st.alpha, st.gamma, st.gamma2 = alpha, gamma, gamma2
            st.init_s_ring, st.init_s2_ring = s_ring, s2_ring
            st.level = None
            st.s_ring = s_ring.copy()
            st.s2_ring = s2_ring.copy()
            history, st.history, st.t = st.history, [], 0
            writes_before, last_write = self._writes, st.last_write
            for y in history:
                self._roll_one(st, y)
            # the replay is not new traffic: keep the write clock and this
            # series' recency rank exactly where they were
            self._writes, st.last_write = writes_before, last_write
            n += 1
        return n
