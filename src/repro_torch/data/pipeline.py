"""Data preparation (paper section 5).

* Eq. 7/8 splits: ``Train_{N-O*2-C..N-O*2-1}, Val_{N-O*2..N-O-1},
  Test_{N-O..N}`` with O = horizon, C = equalized length.
* Section 5.2 length equalization: drop series shorter than the per-frequency
  threshold (72 for quarterly/monthly in the paper), keep the most recent C
  observations of the rest.
* Batching: deterministic, seeded, *stateless* (step -> batch indices), so a
  restarted job resumes the exact data order (fault-tolerance requirement).
* Section 8.1 (future work in the paper, implemented here): variable-length
  support via left-padding + masks; `equalize` remains the faithful default.

A numpy copy of ``repro.data.pipeline`` for the port (which imports nothing
of the JAX package): the same arrays, the same stateless schedule and the
same chunk-major schedule of the out-of-core fit, bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic_m4 import M4Dataset

# Paper section 5.2: minimum-length thresholds ("we used 72 as minimum series
# value for both quarterly and monthly").
MIN_LENGTH = {"yearly": 13, "quarterly": 72, "monthly": 72, "weekly": 80,
              "daily": 93, "hourly": 700}


@dataclasses.dataclass
class PreparedData:
    """Fixed-shape arrays ready for the model.

    train:     (N, C)   training portion (ends at N-2*O-1 per Eq. 8)
    val_input: (N, C+O) train+val observations (for forecasting the test part)
    val_target:(N, O)   validation targets
    test_target:(N, O)  test targets
    mask:      (N, C)   1 where train is real data (all-ones when equalized)
    cats:      (N, n_categories) one-hot
    """

    frequency: str
    seasonality: int
    horizon: int
    train: np.ndarray
    val_input: np.ndarray
    val_target: np.ndarray
    test_target: np.ndarray
    mask: np.ndarray
    cats: np.ndarray
    categories: np.ndarray

    @property
    def n_series(self) -> int:
        return self.train.shape[0]


def prepare(
    ds: M4Dataset,
    *,
    min_length: Optional[int] = None,
    variable_length: bool = False,
) -> PreparedData:
    """Equalize + split per sections 5.1/5.2.

    A series of raw length L supplies: test = last O, val = previous O,
    train = the C observations before those (so we require
    L >= C + 2*O, with C = min_length - 2*O_adjusted... the paper's C is the
    *train* length after removing val+test; we take C = min_length so that
    train windows always have >= one full output window).
    """
    o = ds.horizon
    c = int(min_length if min_length is not None else MIN_LENGTH[ds.frequency])
    need = c + 2 * o

    keep_idx, rows_train, rows_vin, rows_vt, rows_tt, rows_mask = [], [], [], [], [], []
    for i, y in enumerate(ds.series):
        ln = len(y)
        if ln < need:
            if not variable_length or ln < (2 * o + max(2 * ds.seasonality, 8)):
                continue  # section 5.2: disregard series below the threshold
        tail = y[-need:] if ln >= need else y
        t = len(tail)
        test = tail[t - o:]
        val = tail[t - 2 * o : t - o]
        train = tail[: t - 2 * o]
        if variable_length and len(train) < c:
            pad = np.full(c - len(train), train[0], np.float32)  # left-pad
            mask = np.concatenate([np.zeros(c - len(train)), np.ones(len(train))])
            train = np.concatenate([pad, train])
        else:
            mask = np.ones(c, np.float32)
        keep_idx.append(i)
        rows_train.append(train.astype(np.float32))
        rows_vin.append(np.concatenate([train, val]).astype(np.float32))
        rows_vt.append(val.astype(np.float32))
        rows_tt.append(test.astype(np.float32))
        rows_mask.append(mask.astype(np.float32))

    if not keep_idx:
        raise ValueError(
            f"no series of {ds.frequency} met the min length {need}"
        )
    cats_int = ds.categories[np.asarray(keep_idx)]
    onehot = np.eye(ds.category_onehot().shape[1], dtype=np.float32)[cats_int]
    return PreparedData(
        frequency=ds.frequency,
        seasonality=ds.seasonality,
        horizon=o,
        train=np.stack(rows_train),
        val_input=np.stack(rows_vin),
        val_target=np.stack(rows_vt),
        test_target=np.stack(rows_tt),
        mask=np.stack(rows_mask),
        cats=onehot,
        categories=cats_int,
    )


def synthetic_prepared(
    n_series: int,
    *,
    frequency: str = "quarterly",
    seasonality: int = 4,
    horizon: int = 8,
    series_length: int = 24,
    n_categories: int = 6,
    seed: int = 0,
) -> PreparedData:
    """Fully vectorized synthetic :class:`PreparedData` at arbitrary N.

    ``prepare(generate(...))`` walks a python loop per series -- fine at M4
    scale, minutes and a second full copy at 1M rows. This builds the
    fixed-shape arrays directly (level walk x seasonal pattern x noise, one
    vectorized expression): ~160 MB of host float32 at N=1M, T=24+2*8.
    """
    rng = np.random.default_rng(seed)
    t_total = series_length + 2 * horizon
    level = (10.0 + 5.0 * rng.random((n_series, 1))).astype(np.float32)
    drift = (0.05 * (rng.random((n_series, 1)) - 0.3)).astype(np.float32)
    phase = rng.integers(0, max(seasonality, 1), (n_series, 1))
    t = np.arange(t_total, dtype=np.float32)[None, :]
    seas = 1.0 + 0.1 * np.sin(
        2.0 * np.pi * (t + phase) / max(seasonality, 1)).astype(np.float32)
    noise = 1.0 + 0.02 * rng.standard_normal(
        (n_series, t_total)).astype(np.float32)
    y = (level * (1.0 + drift * t) * seas * noise).astype(np.float32)
    np.maximum(y, 0.1, out=y)
    cats_int = rng.integers(0, n_categories, n_series)
    return PreparedData(
        frequency=frequency,
        seasonality=seasonality,
        horizon=horizon,
        train=y[:, :series_length],
        val_input=y[:, : series_length + horizon],
        val_target=y[:, series_length : series_length + horizon],
        test_target=y[:, series_length + horizon :],
        mask=np.ones((n_series, series_length), np.float32),
        cats=np.eye(n_categories, dtype=np.float32)[cats_int],
        categories=cats_int,
    )


class _BoundedPermCache:
    """LRU permutation cache bounded by BYTES, not entry count.

    At 1M series each epoch permutation is 8 MB, so a cache bounded by
    entries could pin hundreds of MB; bounding by bytes keeps the small-N
    behavior (identity-stable hits, read-only arrays) with a fixed worst
    case. A single permutation larger than the whole budget is returned
    uncached (drawn fresh per call).
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self._entries: "collections.OrderedDict[tuple, np.ndarray]" = (
            collections.OrderedDict())

    def get_or_draw(self, key: tuple, draw: Callable[[], np.ndarray]):
        arr = self._entries.get(key)
        if arr is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return arr
        self.misses += 1
        arr = draw()
        arr.flags.writeable = False
        if arr.nbytes <= self.max_bytes:
            self._entries[key] = arr
            self.nbytes += arr.nbytes
            while self.nbytes > self.max_bytes:
                _, old = self._entries.popitem(last=False)
                self.nbytes -= old.nbytes
        return arr

    def clear(self):
        self._entries.clear()
        self.nbytes = self.hits = self.misses = 0


# One shared budget for the global-epoch and the chunk-local permutations.
PERM_CACHE_BYTES = 64 << 20
_perm_cache = _BoundedPermCache(PERM_CACHE_BYTES)


def epoch_permutation(n_series: int, epoch: int, seed: int = 0) -> np.ndarray:
    """The (cached) series permutation for one epoch of the schedule.

    Bit-identical to ``np.random.default_rng(SeedSequence([seed, epoch]))
    .permutation(n_series)`` -- the contract :func:`batch_indices` has always
    had -- but materialized once per ``(n_series, epoch, seed)`` instead of
    on every call: a 300-step epoch used to re-draw the same permutation 300
    times. The returned array is marked read-only because it is shared by
    every caller of the cache; the cache itself is bounded by
    :data:`PERM_CACHE_BYTES` (LRU in bytes -- 64 cached 1M-row epochs would
    otherwise pin half a gigabyte of host memory).
    """
    def draw():
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        return rng.permutation(n_series)

    return _perm_cache.get_or_draw(("epoch", n_series, epoch, seed), draw)


def chunk_permutation(
    n_rows: int, epoch: int, chunk_id: int, seed: int = 0
) -> np.ndarray:
    """Chunk-local epoch permutation: the rows *within* one series chunk.

    Deterministic in ``(seed, epoch, chunk_id)`` and independent of the
    total series count. The entropy tuple ends in ``1 + chunk_id``, so no
    stream collides with the global epoch permutation or the chunk visit
    order. Cached in the same byte budget as :func:`epoch_permutation`.
    """
    def draw():
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, epoch, 1 + chunk_id]))
        return rng.permutation(n_rows)

    return _perm_cache.get_or_draw(
        ("chunk", n_rows, epoch, chunk_id, seed), draw)


def batch_indices(
    n_series: int, batch_size: int, step: int, *, seed: int = 0
) -> np.ndarray:
    """Stateless batch schedule: (epoch, step-within-epoch) -> series indices.

    Deterministic in (seed, step); a restarted trainer replays the same order
    without any iterator state in the checkpoint. The per-epoch permutation
    comes from the :func:`epoch_permutation` cache, so repeated calls within
    an epoch only slice.
    """
    steps_per_epoch = max(1, -(-n_series // batch_size))
    epoch, k = divmod(step, steps_per_epoch)
    perm = epoch_permutation(n_series, epoch, seed)
    sl = perm[k * batch_size : (k + 1) * batch_size]
    if len(sl) < batch_size:  # wrap to keep shapes static
        sl = np.concatenate([sl, perm[: batch_size - len(sl)]])
    return np.array(sl)  # private, writable copy (the cache stays frozen)


def batch_schedule(
    n_series: int, batch_size: int, start_step: int, n_steps: int, *,
    seed: int = 0,
) -> np.ndarray:
    """Materialize ``n_steps`` of the stateless schedule as one index array.

    Returns an ``(n_steps, batch_size)`` int array whose row ``i`` equals
    ``batch_indices(n_series, batch_size, start_step + i, seed=seed)`` -- the
    superstep engine uploads it to the device once per K steps, instead of
    drawing + transferring one batch per step. Stateless in ``start_step``, so a resumed run slices the same
    global schedule (fault-tolerance contract unchanged).
    """
    if n_steps <= 0:
        return np.empty((0, batch_size), dtype=np.int64)
    return np.stack([
        batch_indices(n_series, batch_size, s, seed=seed)
        for s in range(start_step, start_step + n_steps)
    ])


# ---------------------------------------------------------------------------
# Chunk-major schedule (the out-of-core fit)
# ---------------------------------------------------------------------------
#
# With ``series_chunk = K`` the N series are cut into contiguous row ranges
# of K; an epoch visits the chunks in a per-epoch permuted order and runs each
# chunk's whole within-chunk epoch (ceil(rows / batch) steps over a
# chunk-local permutation) before moving on. Batches are chunk-pure, so the
# streaming trainer needs one chunk's rows on the device, and the schedule
# stays stateless in the global step, so a resume lands anywhere in it.


def chunk_bounds(n_series: int, chunk: int) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` row ranges cutting N series into chunks."""
    if chunk <= 0:
        raise ValueError(f"series chunk must be positive, got {chunk}")
    return [(lo, min(lo + chunk, n_series))
            for lo in range(0, n_series, chunk)]


def chunk_visit_order(n_chunks: int, epoch: int, seed: int = 0) -> np.ndarray:
    """The order an epoch visits the chunks in (deterministic, stateless)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, 0]))
    return rng.permutation(n_chunks)


def chunk_layout(
    n_series: int, chunk: int, batch_size: int
) -> Tuple[List[Tuple[int, int, int, int]], int]:
    """Static shape plan of the chunk-major schedule.

    Returns ``(per_chunk, steps_per_epoch)``; ``per_chunk[c]`` is ``(lo, hi,
    bs_c, steps_c)``: the chunk's rows, its batch ``min(batch_size, rows)``
    (only a ragged last chunk can differ) and its steps per epoch
    ``ceil(rows / bs_c)``.
    """
    per_chunk = []
    for lo, hi in chunk_bounds(n_series, chunk):
        bs_c = min(batch_size, hi - lo)
        per_chunk.append((lo, hi, bs_c, -(-(hi - lo) // bs_c)))
    return per_chunk, sum(s for _, _, _, s in per_chunk)


def chunk_batch_indices(
    n_rows: int, batch_size: int, epoch: int, chunk_id: int, k: int, *,
    seed: int = 0,
) -> np.ndarray:
    """Chunk-local row indices of step ``k`` of a chunk's epoch visit.

    :func:`batch_indices` against the chunk-local permutation (the short
    tail wraps to keep shapes static); add the chunk's ``lo`` for global rows.
    """
    perm = chunk_permutation(n_rows, epoch, chunk_id, seed)
    sl = perm[k * batch_size : (k + 1) * batch_size]
    if len(sl) < batch_size:
        sl = np.concatenate([sl, perm[: batch_size - len(sl)]])
    return np.array(sl)


def chunk_batch_schedule(
    n_rows: int, batch_size: int, epoch: int, chunk_id: int, start_k: int,
    n_steps: int, *, seed: int = 0,
) -> np.ndarray:
    """``(n_steps, batch_size)`` chunk-local schedule (cf. :func:`batch_schedule`)."""
    if n_steps <= 0:
        return np.empty((0, batch_size), dtype=np.int64)
    return np.stack([
        chunk_batch_indices(n_rows, batch_size, epoch, chunk_id, k, seed=seed)
        for k in range(start_k, start_k + n_steps)
    ])


@dataclasses.dataclass(frozen=True)
class ChunkVisit:
    """One chunk's (possibly partial) epoch visit, in global steps.

    ``start_k`` is the step offset within the visit (non-zero only when a
    resume lands mid-visit); ``step`` is the global step of the visit's
    first scheduled step.
    """

    epoch: int
    chunk_id: int
    lo: int
    hi: int
    batch_size: int
    step: int
    start_k: int
    n_steps: int


def chunk_visit_plan(
    n_series: int, chunk: int, batch_size: int, start_step: int,
    n_steps: int, *, seed: int = 0,
) -> Iterator[ChunkVisit]:
    """Yield the chunk visits covering global steps ``[start_step, n_steps)``.

    Stateless in ``start_step``: a resumed run re-enters the same schedule
    mid-visit (same chunks, permutations and order).
    """
    per_chunk, spe = chunk_layout(n_series, chunk, batch_size)
    epoch = start_step // spe
    base = epoch * spe
    while base < n_steps:
        for c in chunk_visit_order(len(per_chunk), epoch, seed):
            lo, hi, bs_c, steps_c = per_chunk[c]
            s0 = max(base, start_step)
            s1 = min(base + steps_c, n_steps)
            if s1 > s0:
                yield ChunkVisit(epoch=epoch, chunk_id=int(c), lo=lo, hi=hi,
                                 batch_size=bs_c, step=s0, start_k=s0 - base,
                                 n_steps=s1 - s0)
            base += steps_c
            if base >= n_steps:
                break
        epoch += 1


def iterate_batches(
    data: PreparedData, batch_size: int, n_steps: int, *, seed: int = 0,
    start_step: int = 0,
) -> Iterator[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (step, series_idx, y, cats) minibatches; resumable at any step."""
    for step in range(start_step, n_steps):
        idx = batch_indices(data.n_series, batch_size, step, seed=seed)
        yield step, idx, data.train[idx], data.cats[idx]
