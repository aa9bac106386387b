"""Host-resident per-series state: the out-of-core Holt-Winters table.

Port of ``repro.train.host_table``. ES-RNN keeps parameters for every
series -- N rows of HW logits plus, under sparse Adam, their two moments
and the per-row last-touch clock -- and at millions of series that table,
not the network, is what a device cannot hold. The out-of-core fit keeps
the master table in host memory and streams ``series_chunk``-row slices of
it through the device:

* :class:`HostStateTable` -- the master copy: HW rows, sparse-Adam
  ``mu_hw``/``nu_hw`` rows and the ``t_hw`` clock, series axis leading. On
  the card every leaf is a pinned CPU tensor of its own, so a row slice
  ``[lo, hi)`` is one contiguous pinned block. :meth:`~HostStateTable.device_slice`
  copies a slice to the device on a dedicated copy stream and records an
  event (:class:`StagedRows`); the compute stream waits on that event before
  the chunk's first step, so the trainer stages chunk k+1 while chunk k
  computes (:func:`stream_chunks` pipelines inference the same way).
  :meth:`~HostStateTable.absorb` writes a trained chunk back and blocks
  until the rows are on the host. On the CPU nothing is pinned and no
  stream is used. On the card an unpinned leaf raises: no copy falls back to
  a synchronous one.
* :class:`ExtendedHWView` -- the serving view: the fitted table plus one
  virtual primer row for cold-start series, without an (N+1)-row copy. The
  dispatcher snapshots the table to numpy once (:meth:`HostStateTable.from_hw`)
  and only the gathered ``(B, ...)`` rows move to the device.

Exactness: the sparse-Adam clocks carry *global* step numbers, so slicing
rows out, updating them on the device and writing them back is a change of
memory placement only -- the streamed fit walks the trajectory of a fit
with the whole table on the device, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.holt_winters import HWParams


def _logit(p: float) -> float:
    return float(math.log(p / (1.0 - p)))


def hw_init_host(
    n_series: int, seasonality: int, *, seasonality2: int = 0,
    alpha0: float = 0.5, gamma0: float = 0.5, dtype=np.float32,
) -> HWParams:
    """Numpy mirror of :func:`repro_torch.core.holt_winters.hw_init_params`:
    the same primer values bit for bit, built in host memory."""
    m = max(seasonality, 1)
    params = HWParams(
        alpha_logit=np.full((n_series,), _logit(alpha0), dtype),
        gamma_logit=np.full((n_series,), _logit(gamma0), dtype),
        init_seas_logit=np.zeros((n_series, m), dtype),
    )
    if seasonality2:
        params = dataclasses.replace(
            params,
            gamma2_logit=np.full((n_series,), _logit(gamma0), dtype),
            init_seas_logit2=np.zeros((n_series, seasonality2), dtype),
        )
    return params


def _host(a):
    if a is None or isinstance(a, np.ndarray):
        return a
    if isinstance(a, torch.Tensor):
        # a copy even on the CPU: the snapshot must not alias a tensor a
        # fine-tuner updates in place
        return a.detach().to("cpu", copy=True).numpy()
    return np.asarray(a)


def _host_hw(hw) -> HWParams:
    """HWParams with numpy leaves (zero-copy for leaves already numpy)."""
    return HWParams(**{f.name: _host(getattr(hw, f.name))
                       for f in dataclasses.fields(HWParams)})


def _leaves(hw: Optional[HWParams]) -> List[torch.Tensor]:
    """The present leaves of an HWParams, in field order."""
    if hw is None:
        return []
    return [getattr(hw, f.name) for f in dataclasses.fields(HWParams)
            if getattr(hw, f.name) is not None]


def _like(hw: HWParams, leaves) -> HWParams:
    """``hw``'s structure with ``leaves`` (field order) in its place."""
    it = iter(leaves)
    return hw.map(lambda _: next(it))


def pinned_copy(a, device) -> torch.Tensor:
    """A host tensor holding ``a`` (numpy or tensor) that a copy to
    ``device`` can read asynchronously: a pinned copy when ``device`` is a
    card, ``a`` itself as a tensor (no copy) on the CPU. A failed pin raises."""
    t = torch.as_tensor(a).detach()
    if t.device.type != "cpu":
        raise ValueError(f"the host table takes host arrays, not {t.device} tensors")
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def to_device(a, device) -> torch.Tensor:
    """``a`` (numpy or a host tensor) on ``device``, copied on the current
    stream; on the card from pinned memory, without blocking the host."""
    return pinned_copy(a, device).to(device, non_blocking=True)


def _owned(a, device) -> torch.Tensor:
    """A host tensor copy of ``a`` that nothing else aliases (``absorb``
    writes it in place), pinned when ``device`` is a card."""
    t = torch.as_tensor(a).detach()
    if torch.device(device).type == "cuda":
        return t.pin_memory() if not t.is_pinned() else t.clone().pin_memory()
    return t.clone()


class StagedRows:
    """Host rows on their way to the device: :meth:`HostStateTable.device_slice`.

    ``state`` holds the table rows (``{"hw": HWParams, "mu": ..., "nu": ...,
    "t_hw": ...}``, the moments only where they were asked for) and
    ``extra`` the rows of the other host tensors staged with them. On the
    card they were allocated and filled on the table's copy stream
    (``stream``), between the events ``start`` and ``done``; :meth:`wait`
    must come before any use.
    """

    def __init__(self, state: Dict, extra: List[torch.Tensor], stream=None,
                 start=None, done=None, tensors=()):
        self.state = state
        self.extra = extra
        self.stream = stream
        self.start = start
        self.done = done
        self.ready = None
        self._tensors = list(tensors)

    def wait(self) -> "StagedRows":
        """Make the current (compute) stream wait for the copies, and mark
        the tensors as used by it, so that the caching allocator hands
        their memory out again only once the compute stream is done with
        them. ``ready`` records whether the copies had already finished
        (a host-side query, no wait): if so, no work waited on them."""
        if self.done is not None:
            self.ready = self.done.query()
            compute = torch.cuda.current_stream(self.done.device)
            compute.wait_event(self.done)
            for t in self._tensors:
                t.record_stream(compute)
            self._tensors = []
        return self


def copy_ms(start, done) -> float:
    """Device milliseconds between two timing events of a copy (waits for
    ``done``)."""
    done.synchronize()
    return start.elapsed_time(done)


def stream_chunks(table: "HostStateTable", ranges, extra, compute, finish) -> None:
    """Pipeline chunks of rows through the device.

    For each ``(lo, hi)`` of ``ranges``: the table's HW rows and
    ``extra(lo, hi)`` (host tensors of the chunk) are copied to the device,
    ``compute(rows)`` (a waited-on :class:`StagedRows`) enqueues the
    chunk's work and returns its device result, and ``finish(lo, hi,
    result)`` does the host's part one chunk behind, while the next chunk
    computes. Chunk i+1's copies are issued as chunk i's work begins, so
    they run while it is enqueued and computed; at most three chunks are on
    the device at a time.
    """
    stage = lambda lo, hi: table.device_slice(lo, hi, extra(lo, hi), moments=False)
    nxt, prev = stage(*ranges[0]), None
    for i, (lo, hi) in enumerate(ranges):
        rows = nxt.wait()
        if i + 1 < len(ranges):
            nxt = stage(*ranges[i + 1])
        result = compute(rows)
        if prev is not None:
            finish(*prev)
        prev = (lo, hi, result)
    finish(*prev)


class HostStateTable:
    """The master per-series state, resident in host memory.

    ``hw`` is an :class:`HWParams`; ``mu_hw``/``nu_hw`` mirror it (the
    sparse-Adam moments) and ``t_hw`` is the (N,) int32 last-touch clock,
    ``None`` for an inference-only table. A table built for a ``device``
    (:meth:`init`, :meth:`from_state`, :meth:`adopt`) holds host tensors,
    pinned when the device is a card, and streams rows to it; the serving
    snapshot (:meth:`from_hw`) holds numpy arrays.
    """

    def __init__(self, hw: HWParams, *, mu_hw: Optional[HWParams] = None,
                 nu_hw: Optional[HWParams] = None, t_hw=None, device=None):
        self.hw = hw
        self.mu_hw = mu_hw
        self.nu_hw = nu_hw
        self.t_hw = t_hw
        self.device = None if device is None else torch.device(device)
        self._copy_stream = None

    @property
    def n_rows(self) -> int:
        return self.hw.alpha_logit.shape[0]

    @property
    def has_moments(self) -> bool:
        return self.mu_hw is not None

    def _all_leaves(self) -> list:
        return (_leaves(self.hw) + _leaves(self.mu_hw) + _leaves(self.nu_hw)
                + ([] if self.t_hw is None else [self.t_hw]))

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self._all_leaves())

    def is_pinned(self) -> bool:
        return all(isinstance(a, torch.Tensor) and a.is_pinned()
                   for a in self._all_leaves())

    # -- constructors --------------------------------------------------------

    @classmethod
    def adopt(cls, hw: HWParams, *, mu_hw: Optional[HWParams] = None,
              nu_hw: Optional[HWParams] = None, t_hw=None,
              device) -> "HostStateTable":
        """A streaming table over copies of the given host rows (numpy or
        tensors), pinned when ``device`` is a card."""
        own = lambda tree: None if tree is None else tree.map(lambda a: _owned(a, device))
        return cls(own(hw), mu_hw=own(mu_hw), nu_hw=own(nu_hw),
                   t_hw=None if t_hw is None else _owned(t_hw, device), device=device)

    @classmethod
    def init(cls, n_series: int, seasonality: int, *, seasonality2: int = 0,
             with_moments: bool = True, dtype=np.float32,
             device="cpu") -> "HostStateTable":
        """Fresh table: primer HW rows, zero moments, zero clocks."""
        hw = hw_init_host(n_series, seasonality, seasonality2=seasonality2,
                          dtype=dtype)
        if not with_moments:
            return cls.adopt(hw, device=device)
        zeros = hw.map(lambda a: np.zeros(a.shape, np.float32))
        return cls.adopt(hw, mu_hw=zeros, nu_hw=zeros,
                         t_hw=np.zeros((n_series,), np.int32), device=device)

    @classmethod
    def from_hw(cls, hw: HWParams) -> "HostStateTable":
        """Inference-only numpy snapshot of existing HW rows (zero-copy if
        numpy, a host copy of tensors)."""
        return cls(_host_hw(hw))

    @classmethod
    def from_state(cls, params: Dict, *, with_moments: bool = False,
                   device="cpu") -> "HostStateTable":
        """Adopt a params tree's per-series rows (copied: :meth:`absorb`
        writes the table in place); ``with_moments=True`` starts zero
        moments and clocks over them (a warm start)."""
        hw = params["hw"].map(lambda a: torch.as_tensor(a).detach().cpu())
        if not with_moments:
            return cls.adopt(hw, device=device)
        zeros = hw.map(lambda a: torch.zeros(a.shape, dtype=torch.float32))
        return cls.adopt(hw, mu_hw=zeros, nu_hw=zeros,
                         t_hw=torch.zeros((hw.alpha_logit.shape[0],), dtype=torch.int32),
                         device=device)

    # -- the streaming surface ----------------------------------------------

    def copy_stream(self):
        """The card's copy stream of this table (None on the CPU)."""
        if self.device is None or self.device.type != "cuda":
            return None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    def device_slice(self, lo: int, hi: int, extra: Sequence[torch.Tensor] = (),
                     *, moments: bool = True) -> StagedRows:
        """Issue the copy of rows ``[lo, hi)`` to the device: the chunk's
        working set (the HW rows, and with ``moments`` their moments and
        clocks), plus ``extra`` (host tensors of the chunk, e.g. its data
        rows, already sliced). Call :meth:`StagedRows.wait` before using
        them.

        On the card the destination tensors are allocated on the table's
        copy stream and filled there, non-blocking, from pinned memory, with
        no wait on the compute stream: the copies run under whatever the
        compute stream is doing. Memory the copy stream allocates is only
        handed out again after the copy stream's earlier work, so an unwaited
        chunk can be dropped safely. An unpinned source raises.
        """
        if self.device is None:
            raise ValueError("an inference snapshot (from_hw) streams nothing; "
                             "build the table with a device")
        moments = moments and self.has_moments
        tables = [self.hw] + ([self.mu_hw, self.nu_hw] if moments else [])
        src = [a[lo:hi] for t in tables for a in _leaves(t)]
        if moments:
            src.append(self.t_hw[lo:hi])
        src += list(extra)
        stream = self.copy_stream()
        if stream is None:
            out = [a.to(self.device, copy=True) for a in src]
            start = done = None
        else:
            unpinned = [i for i, a in enumerate(src) if not a.is_pinned()]
            if unpinned:
                raise RuntimeError(
                    f"host rows {unpinned} of the chunk are not in pinned memory: "
                    "the card's copy would be synchronous")
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                out = [torch.empty(a.shape, dtype=a.dtype, device=self.device) for a in src]
                start.record(stream)
                for d, a in zip(out, src):
                    d.copy_(a, non_blocking=True)
                done.record(stream)
        it = iter(out)
        state = {"hw": _like(self.hw, [next(it) for _ in _leaves(self.hw)])}
        if moments:
            state["mu"] = _like(self.mu_hw, [next(it) for _ in _leaves(self.mu_hw)])
            state["nu"] = _like(self.nu_hw, [next(it) for _ in _leaves(self.nu_hw)])
            state["t_hw"] = next(it)
        return StagedRows(state, list(it), stream, start, done,
                          tensors=out if stream is not None else ())

    def absorb(self, lo: int, hi: int, chunk: Dict) -> None:
        """Write a trained chunk's rows back into the table: ``chunk`` is
        :attr:`StagedRows.state`'s layout. Returns when the rows are in host
        memory (the copies wait for the compute stream's work on them), so
        a later :meth:`device_slice` of the same rows reads them."""
        pairs = list(zip(_leaves(self.hw), _leaves(chunk["hw"])))
        if self.has_moments and "mu" in chunk:
            pairs += list(zip(_leaves(self.mu_hw), _leaves(chunk["mu"])))
            pairs += list(zip(_leaves(self.nu_hw), _leaves(chunk["nu"])))
            pairs.append((self.t_hw, chunk["t_hw"]))
        with torch.no_grad():
            for dst, src in pairs:
                dst[lo:hi].copy_(src)           # blocking device-to-host copy

    # -- serving view --------------------------------------------------------

    def extended(self, primer: HWParams) -> "ExtendedHWView":
        """(N+1)-row view: fitted rows + a virtual primer row, no concat."""
        return ExtendedHWView(self, _host_hw(primer))


class _ExtLeaf:
    """One leaf of :class:`ExtendedHWView`: N fitted rows + 1 primer row.

    Supports scalar row reads (``leaf[row]``, the online state store) and
    vectorized row gathers (``leaf[idx_array]``, the dispatcher).
    """

    __slots__ = ("base", "primer")

    def __init__(self, base: np.ndarray, primer: np.ndarray):
        self.base = base
        self.primer = primer          # (1, ...) row

    def __getitem__(self, idx):
        n = self.base.shape[0]
        if isinstance(idx, (int, np.integer)):
            return self.primer[0] if int(idx) == n else self.base[idx]
        idx = np.asarray(idx)
        out = np.asarray(self.base[np.minimum(idx, n - 1)])
        over = idx >= n
        if over.any():
            out = out.copy()
            out[over] = self.primer[0]
        return out


class ExtendedHWView:
    """The dispatcher's host HW snapshot: fitted table + primer row, by view.

    Attribute access (``view.alpha_logit[row]``) serves the online state
    store; :meth:`rows` is the dispatcher's vectorized per-request gather.
    """

    def __init__(self, table: HostStateTable, primer: HWParams):
        self._table = table
        self._primer = primer

    @property
    def n_rows(self) -> int:
        """The fitted rows plus the primer row."""
        return self._table.n_rows + 1

    def __getattr__(self, name: str):
        base = getattr(self._table.hw, name)
        if base is None:
            return None
        return _ExtLeaf(base, np.atleast_1d(getattr(self._primer, name)))

    def rows(self, idx) -> HWParams:
        """Gather rows ``idx`` (primer for ``idx == n_known``) as numpy HWParams."""
        idx = np.asarray(idx)
        fields = {}
        for f in dataclasses.fields(HWParams):
            base = getattr(self._table.hw, f.name)
            fields[f.name] = (None if base is None
                              else getattr(self, f.name)[idx])
        return HWParams(**fields)
