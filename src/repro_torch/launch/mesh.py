"""Mesh construction for the port's launchers.

The port of the JAX package's ``launch/mesh.py``:

* :func:`make_production_mesh` is the production layout, ``(16, 16)`` over
  ``("data", "model")`` or ``(2, 16, 16)`` with ``"pod"`` in front: an
  :class:`AbstractMesh` (axis names and sizes, no ranks), all the dry-run
  and the partition rules (:mod:`repro_torch.sharding.specs`) read;
* :func:`make_host_mesh` is a :class:`HostMesh` over the ranks of the
  initialized process group, ``(world // model_parallel, model_parallel)``
  over ``("data", "model")``, rank ``r`` at ``(r // model_parallel, r %
  model_parallel)`` (``jax.make_mesh``'s order). It has one process group
  per ``data`` row (its ``model`` axis) and one per ``model`` column (its
  ``data`` axis); every collective goes through :meth:`MeshAxis.all_reduce`,
  which counts it, as :class:`~repro_torch.sharding.series.SeriesMesh`
  counts its own. Without a process group the world is one rank, so only
  ``model_parallel == 1`` is accepted.

The ES-RNN series mesh lives in :mod:`repro_torch.sharding.series` and is
re-exported here, as the reference does.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.series import make_series_mesh

__all__ = ["AbstractMesh", "HostMesh", "MeshAxis", "make_host_mesh", "make_production_mesh",
           "make_series_mesh"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no ranks (``jax.make_mesh``'s shape)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


class MeshAxis:
    """One axis of a host mesh as this rank sees it: ``index`` along it,
    its ``size``, and the process group of the ranks that differ from this
    one only along it."""

    def __init__(self, mesh: "HostMesh", name: str, index: int, size: int, group):
        self.mesh, self.name, self.index, self.size, self.group = mesh, name, index, size, group

    def __repr__(self) -> str:
        return f"MeshAxis({self.name!r}, index={self.index}, size={self.size})"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the axis, in place; returns it. Counted, and timed
        (the device synchronized around it) when the mesh is ``timed``."""
        mesh = self.mesh
        mesh.counts[self.name, "all_reduce"] += 1
        if self.size == 1:
            return t
        if mesh.timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
        dist.all_reduce(t, group=self.group)
        if mesh.timed:
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            mesh.seconds[self.name, "all_reduce"] += time.perf_counter() - t0
        return t


class HostMesh:
    """The LM mesh over the ranks of a process group: ``axis_names``
    ``("data", "model")``, ``shape`` (a dict of sizes), ``device`` (this
    rank's), ``backend``; :meth:`axis` gives this rank's view of an axis.
    :attr:`counts` counts the collectives by (axis, op); with ``timed``
    set, :attr:`seconds` adds up their host-clock time."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int, *, rank: int, device, backend: Optional[str],
                 groups: Dict[str, object]):
        self.rank, self.device, self.backend = rank, torch.device(device), backend
        self.shape = {"data": data, "model": model}
        self.counts: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()
        self.timed = False
        self._axes = {"data": MeshAxis(self, "data", rank // model, data, groups.get("data")),
                      "model": MeshAxis(self, "model", rank % model, model,
                                        groups.get("model"))}

    def __repr__(self) -> str:
        return (f"HostMesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")

    def axis(self, name: str) -> MeshAxis:
        return self._axes[name]

    def collective_counts(self) -> Dict[str, Dict[str, int]]:
        """``{axis: {op: count}}`` since the last :meth:`reset_counts`."""
        out: Dict[str, Dict[str, int]] = {}
        for (axis, op), n in sorted(self.counts.items()):
            out.setdefault(axis, {})[op] = n
        return out

    def reset_counts(self) -> None:
        self.counts.clear()
        self.seconds.clear()


def make_host_mesh(model_parallel: int = 1, *, device=None) -> HostMesh:
    """The ``(world // model_parallel, model_parallel)`` mesh over the
    initialized process group (or over this process alone, where none is).
    ``device`` defaults to ``cuda:(rank % device_count)``; the CPU runs pass
    ``device="cpu"``. Every rank of the world must call it, in the same
    order: it creates the axes' process groups."""
    model_parallel = int(model_parallel)
    if not (dist.is_available() and dist.is_initialized()):
        if model_parallel != 1:
            raise ValueError(
                f"a host mesh with model_parallel={model_parallel} needs that many ranks: "
                "start them with repro_torch.sharding.run_ranks (or torchrun) and call "
                "torch.distributed.init_process_group first")
        return HostMesh(1, 1, rank=0, device=resolve_device(device), backend=None, groups={})
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the "
                         f"{world} ranks of the process group")
    data = world // model_parallel
    groups = {}
    if model_parallel > 1:     # one group per data row: its model axis
        for i in range(data):
            g = dist.new_group(list(range(i * model_parallel, (i + 1) * model_parallel)))
            if rank // model_parallel == i:
                groups["model"] = g
    if data > 1:               # one group per model column: its data axis
        for j in range(model_parallel):
            g = dist.new_group(list(range(j, world, model_parallel)))
            if rank % model_parallel == j:
                groups["data"] = g
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_host_mesh places each rank on a card by default, and "
                               "this host has none; pass device='cpu'")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return HostMesh(data, model_parallel, rank=rank, device=device,
                    backend=dist.get_backend(), groups=groups)
