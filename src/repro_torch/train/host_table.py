"""Host-resident per-series state: the serving side of the HW table.

Port of the part of ``repro.train.host_table`` that serving uses. The
dispatcher snapshots the fitted per-series table to host numpy once
(:meth:`HostStateTable.from_hw`) and resolves every request against that
snapshot plus one virtual primer row for cold-start series
(:class:`ExtendedHWView`), without concatenating an (N+1)-row copy. Only the
gathered ``(B, ...)`` rows ever move to the device. The streaming surface of
the out-of-core fit (moments, clocks, ``device_slice``/``absorb``) comes with
the chunked-fit slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.holt_winters import HWParams


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


class HostStateTable:
    """The master per-series HW rows, resident in host memory (inference)."""

    def __init__(self, hw: HWParams):
        self.hw = hw

    @classmethod
    def from_hw(cls, hw: HWParams) -> "HostStateTable":
        """Inference-only table over existing HW rows (zero-copy if numpy,
        a host copy of tensors)."""
        return cls(_host_hw(hw))

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
