"""Collective audit: the sharded calls issue the collectives they document.

The port's series mesh (:mod:`repro_torch.sharding.series`) states the
collectives of each call and counts those that pass through it
(``SeriesMesh.counts``). This lint counts what actually reaches
``torch.distributed``: a :class:`CollectiveRecorder` wraps the collective
functions inside a ``with`` block and counts every call by kind, whoever
makes it. :func:`collective_audit` runs the sharded predict and the sharded
loss gradient on ``devices`` ranks (:func:`repro_torch.sharding.ranks.run_ranks`,
gloo on the CPU or for ranks that share a card, NCCL when each has its own)
and :func:`collective_findings` holds the counts to the documented numbers:

* sharded predict issues exactly ``FORECAST_COLLECTIVES`` (one
  ``all_reduce``, the row gather) and nothing else. The reference's predict
  has zero collectives, because its output stays sharded over the devices
  of one controller; every rank of the port returns the full ``(N, H)``
  forecast, so one gather is by design, not a finding;
* the loss gradient issues exactly ``STEP_COLLECTIVES`` (two
  ``all_reduce``: the loss terms, the flat gradient buffer) and nothing
  else -- a broadcast or a gather there means a sharding rule regressed;
* the recorder's counts equal ``SeriesMesh.counts``, so no collective
  bypasses the mesh.

The JAX package compiles the partitioned programs and reads the counts off
HLO text (``repro.analysis.hlo_text``), in a subprocess with forced host
devices when it has too few; the port's ranks are processes either way.
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d

from repro_torch.analysis.gradleak import Finding
from repro_torch.sharding import series as S

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
               "broadcast", "all_to_all", "barrier", "send", "recv")


class CollectiveRecorder:
    """Counts the ``torch.distributed`` collectives called in its ``with``
    block, by kind (:data:`COLLECTIVES`), in ``counts``. Both
    ``torch.distributed.<kind>`` and ``distributed_c10d.<kind>`` are
    wrapped, so a direct call is counted too; outside the block both are
    the original functions."""

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()
        self._saved = []

    def __enter__(self) -> "CollectiveRecorder":
        for kind in COLLECTIVES:
            original = getattr(distributed_c10d, kind)

            @functools.wraps(original)
            def counted(*args, _kind=kind, _original=original, **kwargs):
                self.counts[_kind] += 1
                return _original(*args, **kwargs)

            for module in (dist, distributed_c10d):
                self._saved.append((module, kind, getattr(module, kind)))
                setattr(module, kind, counted)
        return self

    def __exit__(self, *exc) -> None:
        for module, kind, fn in reversed(self._saved):
            setattr(module, kind, fn)
        self._saved.clear()


def probe_batch(cfg, n: int, t: int = 60, seed: int = 0):
    """Deterministic strictly-positive probe series, the reference's draws."""
    rng = np.random.default_rng(seed)
    y = np.abs(rng.lognormal(3.0, 0.5, (n, t))).astype(np.float32) + 1.0
    cats = np.eye(cfg.n_categories, dtype=np.float32)[rng.integers(0, cfg.n_categories, n)]
    return y, cats


def rank_collective_counts(mesh, cfg, loss_fn=S.esrnn_loss_dp) -> Dict:
    """One rank's counts: the sharded predict and the sharded loss gradient
    (``loss_fn``, default :func:`~repro_torch.sharding.series.esrnn_loss_dp`)
    on ``2 * mesh.size`` probe series, each under a
    :class:`CollectiveRecorder`, beside the mesh's own counts."""
    from repro_torch.core.esrnn import esrnn_init, param_leaves

    n = 2 * mesh.size
    gen = torch.Generator().manual_seed(0)
    params = esrnn_init(gen, cfg, n, device=mesh.device)
    y, cats = (torch.from_numpy(a).to(mesh.device) for a in probe_batch(cfg, n))
    out = {"devices": mesh.size, "backend": mesh.backend}
    mesh.reset_counts()
    with CollectiveRecorder() as rec:
        S.esrnn_forecast_dp(cfg, params, y, cats, mesh=mesh)
    out["predict"], out["mesh_predict"] = dict(rec.counts), mesh.collective_counts()
    mesh.reset_counts()
    leaves = [t.requires_grad_(True) for _, t in param_leaves(params)]
    with CollectiveRecorder() as rec:
        S.value_and_grad_dp(lambda: loss_fn(cfg, params, y, cats, mesh=mesh), leaves, mesh)
    out["loss_grad"], out["mesh_loss_grad"] = dict(rec.counts), mesh.collective_counts()
    mesh.reset_counts()
    return out


def collective_audit(cfg, devices: int = 2, *, device=None, loss_fn=S.esrnn_loss_dp) -> Dict:
    """The counts of :func:`rank_collective_counts` on ``devices`` ranks
    spawned by :func:`~repro_torch.sharding.ranks.run_ranks` on ``device``
    (default the card); the ranks' counts must agree, rank 0's are returned.
    ``loss_fn`` must pickle (a module-level function)."""
    from repro_torch.device import resolve_device
    from repro_torch.sharding.ranks import run_ranks

    ranks = run_ranks(rank_collective_counts, devices, device=str(resolve_device(device)),
                      args=(cfg, loss_fn))
    if any(r != ranks[0] for r in ranks):
        raise RuntimeError(f"the ranks counted different collectives: {ranks}")
    return ranks[0]


def collective_findings(counts: Dict) -> Tuple[List[Finding], dict]:
    """Hold raw counts (:func:`rank_collective_counts`) to the mesh's
    documented numbers."""
    findings: List[Finding] = []
    predict = counts.get("predict", {})
    grad = counts.get("loss_grad", {})
    if predict != S.FORECAST_COLLECTIVES:
        findings.append(Finding(
            "collectives",
            f"sharded predict issued collectives {predict}; the row gather is "
            f"{S.FORECAST_COLLECTIVES} and nothing else"))
    unexpected = {k: v for k, v in grad.items() if k not in S.STEP_COLLECTIVES}
    if unexpected:
        findings.append(Finding(
            "collectives",
            f"sharded loss gradient issued non-all-reduce collectives {unexpected}: a "
            f"sharding rule regressed into resharding traffic (only all_reduce is expected)"))
    if grad.get("all_reduce", 0) != S.STEP_COLLECTIVES["all_reduce"]:
        findings.append(Finding(
            "collectives",
            f"sharded loss gradient issued {grad.get('all_reduce', 0)} all_reduce, the "
            f"step documents {S.STEP_COLLECTIVES['all_reduce']}: the loss terms and the "
            f"gradient buffer each reduce once"))
    for call in ("predict", "loss_grad"):
        mesh_counts = counts.get(f"mesh_{call}")
        if mesh_counts is not None and mesh_counts != counts.get(call, {}):
            findings.append(Finding(
                "collectives",
                f"{call}: torch.distributed saw {counts.get(call, {})} but the series mesh "
                f"counted {mesh_counts}: a collective bypasses the mesh"))
    metrics = {
        "devices": counts.get("devices"),
        "predict_collectives": sum(predict.values()),
        "grad_all_reduces": int(grad.get("all_reduce", 0)),
        "grad_other_collectives": sum(unexpected.values()),
    }
    return findings, metrics
