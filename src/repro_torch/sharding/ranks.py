"""Start the ranks of a mesh: :func:`run_ranks` and :func:`choose_backend`.

``run_ranks(target, world_size, device=..., args=..., mesh_factory=...)``
spawns ``world_size`` processes (the ``spawn`` start method), initializes a
process group in each through a ``file://`` store in a temporary directory
(no fixed port: test workers running side by side never collide), builds the
rank's mesh with ``mesh_factory(device=...)`` (default: the series mesh,
:class:`~repro_torch.sharding.series.SeriesMesh`; the LM's is
``functools.partial(repro_torch.launch.mesh.make_host_mesh, model_parallel)``)
and calls ``target(mesh, *args)``; it returns the ranks' results, by rank.
``target``, ``args`` and ``mesh_factory`` are pickled, so they are
module-level functions (or partials of them).

The backend follows the layout, decided before ``init_process_group`` and
logged: NCCL when every rank has a card of its own, gloo when ranks share a
card (NCCL refuses two ranks on one device) or run on the CPU. Nothing
switches backend after an error.
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

log = logging.getLogger("repro_torch.sharding")


def choose_backend(world_size: int, device) -> str:
    """``"nccl"`` when ``device`` is a card and each of the ``world_size``
    ranks has one of its own, else ``"gloo"``."""
    if (torch.device(device).type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def _rank_main(target, rank, world_size, backend, init_method, device, args, timeout_s,
               results, mesh_factory):
    try:
        if mesh_factory is None:
            from repro_torch.sharding.series import make_series_mesh

            mesh_factory = functools.partial(make_series_mesh, world_size)

        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world_size)))
        if rank:
            logging.getLogger().setLevel(logging.WARNING)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = target(mesh_factory(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(target: Callable, world_size: int, *, device="cuda",
              args: Sequence[Any] = (), timeout_s: float = 1800.0,
              mesh_factory: Optional[Callable] = None) -> List[Any]:
    """Run ``target(mesh, *args)`` on ``world_size`` spawned ranks; returns
    their results in rank order. A rank that raises stops the others and
    raises here with its traceback. On the card the kernel library is built
    here first, so the ranks load it instead of each running nvcc."""
    backend = choose_backend(world_size, device)
    log.info("%s: %d ranks on %s, backend %s",
             "series mesh" if mesh_factory is None else "mesh", world_size, device, backend)
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build

        build.library()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(target, r, world_size, backend, init_method, str(device),
                                   tuple(args), timeout_s, results, mesh_factory))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out: List[Any] = [None] * world_size
        deadline = time.monotonic() + timeout_s
        try:
            for _ in range(world_size):
                while True:
                    try:
                        rank, ok, value = results.get(timeout=1.0)
                        break
                    except queue_mod.Empty:
                        # a rank that died without a word (a signal, a
                        # crash in native code) is reported, not waited for
                        dead = [(r, p.exitcode) for r, p in enumerate(procs)
                                if p.exitcode not in (None, 0)]
                        if dead:
                            # its traceback may still be on its way
                            try:
                                rank, ok, value = results.get(timeout=5.0)
                                break
                            except queue_mod.Empty:
                                pass
                        if dead or time.monotonic() > deadline:
                            raise RuntimeError(
                                f"the ranks gave no result (exit codes {dead}, "
                                f"limit {timeout_s} s)") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return out
