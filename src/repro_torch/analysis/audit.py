"""The invariant auditor: every lint on the real entry points, one report.

The port's counterpart of ``repro.analysis.audit``. Five invariants, one
lint module each:

1. **recompile** (:mod:`~repro_torch.analysis.recompile`) -- serving issues
   no more kernel launch shapes than its bucket grid bounds, a warm second
   wave issues none, and no dispatch of an already-seen bucket issues a new
   one (the ``fc[:n]`` class: a dispatcher that skips the batch padding);
2. **gradient leak** (:mod:`~repro_torch.analysis.gradleak`) -- frozen
   param groups (the esn reservoir) are passed through the step untouched,
   carry no moments and take no gradient; on the card the step launches
   K5's dx-only kernel for them and the full K5 never;
3. **donation** (:mod:`~repro_torch.analysis.donation`) -- a superstep of
   :data:`PROBE_STEPS` updates ``params`` and ``opt_state`` in place;
4. **collectives** (:mod:`~repro_torch.analysis.collectives`) -- sharded
   predict and the sharded loss gradient issue exactly their documented
   collectives, all through the series mesh;
5. **dtype policy** (:mod:`~repro_torch.analysis.dtypes`) -- no float64
   and no conversion wider than the policy in the step and the forecast;
   the HW table, the moments and the loss in the state dtype.

Each section builds the spec's model at its own width over the probe's
:data:`PROBE_SERIES` series (params drawn from ``generator``, default
seeded 0, or given) on ``device`` (default the card), runs the real entry
point once with the recorders of :mod:`~repro_torch.analysis.trace` armed
and lints what they saw. The fit section runs the step the spec's fit runs
(dense, ``sparse_adam``'s segment update, or ``series_chunk``'s chunk step
over the probe as one chunk). ``python -m repro_torch.launch.forecast
analyze`` is the CLI over :func:`run_audit`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.collectives import (
    collective_audit, collective_findings, probe_batch,
)
from repro_torch.analysis.donation import donation_findings, state_leaf_count, state_storages
from repro_torch.analysis.dtypes import accumulation_findings, dtype_findings
from repro_torch.analysis.gradleak import (
    Finding, cell_steps, gradient_leak_findings, launch_findings, probe_batch_size,
)
from repro_torch.analysis.trace import OpRecorder, Trace
from repro_torch.core.esrnn import esrnn_forecast, esrnn_init
from repro_torch.core.heads import frozen_param_groups
from repro_torch.device import resolve_device
from repro_torch.forecast.serving import BucketDispatcher, synthetic_request_stream
from repro_torch.kernels import ops
from repro_torch.sharding import series as S
from repro_torch.train.engine import (
    make_chunk_step_fn, make_step_fn, make_superstep_fn, split_frozen,
)
from repro_torch.train.optimizer import AdamConfig, adam_init, adam_init_sparse

PROBE_SERIES = 15     # probe table rows (odd, clear of weight dims)
PROBE_STEPS = 4       # superstep length for the donation audit
PROBE_T = 60          # probe series length


@dataclasses.dataclass
class AuditSection:
    """One audited entry point: its violations and raw metrics."""

    name: str
    violations: List[Finding]
    metrics: Dict

    def to_dict(self):
        return {"name": self.name,
                "violations": [f.to_dict() for f in self.violations],
                "metrics": self.metrics}


@dataclasses.dataclass
class AuditReport:
    """Everything ``analyze`` emits: per-section findings + metrics."""

    spec: str
    sections: List[AuditSection]

    @property
    def violations(self) -> List[Finding]:
        return [f for s in self.sections for f in s.violations]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self):
        return {"spec": self.spec, "ok": self.ok,
                "violations_total": len(self.violations),
                "sections": [s.to_dict() for s in self.sections]}

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def probe_model(spec, device=None, generator=None, params=None):
    """``(cfg, params, y, cats)`` of the probe on ``device``: the spec's
    model over :data:`PROBE_SERIES` series of :data:`PROBE_T` observations,
    ``params`` drawn from ``generator`` (default seeded 0) unless given."""
    cfg = spec.model
    dev = resolve_device(device)
    y, cats = probe_batch(cfg, PROBE_SERIES, PROBE_T)
    if params is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params = esrnn_init(gen, cfg, PROBE_SERIES, device=dev)
    return cfg, params, torch.from_numpy(y).to(dev), torch.from_numpy(cats).to(dev)


def _synced(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit_step(spec, cfg, y, cats, frozen):
    """The step the spec's fit runs over the probe rows ``(y, cats)`` as
    its whole table, ``(params, opt_state, idx) -> (params, opt_state,
    loss)``, with its optimizer init and engine name: ``series_chunk``'s
    chunk step (the probe as one chunk), ``sparse_adam``'s segment update,
    else the dense step."""
    adam = AdamConfig(lr=spec.rnn_lr)
    mask = torch.ones_like(y)
    if spec.series_chunk:
        chunk_step = make_chunk_step_fn(cfg, adam, frozen=frozen)
        return (lambda p, o, idx: chunk_step(p, o, y, cats, mask, idx),
                adam_init_sparse, "chunked")
    step = make_step_fn(cfg, adam, y, cats, mask, sparse=spec.sparse_adam, frozen=frozen)
    return step, (adam_init_sparse if spec.sparse_adam else adam_init), (
        "sparse" if spec.sparse_adam else "dense")


def audit_step(cfg, step, params, opt_state, frozen, *, engine: str = "dense") -> AuditSection:
    """Gradient-leak, dtype and donation lints on one training step.

    Runs ``step(params, opt_state, idx)`` once with the recorders armed (a
    probe batch from :func:`probe_batch_size` over the :data:`PROBE_SERIES`
    rows), then a superstep of :data:`PROBE_STEPS` disarmed for the
    donation audit; on the card it also holds the step's K5 launches to
    :func:`~repro_torch.analysis.gradleak.launch_findings`. ``params`` and
    ``opt_state`` are updated in place, as the step does.
    """
    dev = params["hw"].alpha_logit.device
    b = probe_batch_size(cfg, params, frozen=frozen)
    idx = torch.arange(b, device=dev) % PROBE_SERIES
    violations: List[Finding] = []

    trace = Trace()
    ops_before = ops.launch_counts()
    leak, leak_metrics = gradient_leak_findings(step, params, opt_state, idx, frozen,
                                                trace=trace)
    _synced(dev)
    if dev.type == "cuda":
        counts = {k: v - ops_before[k] for k, v in ops.launch_counts().items()}
        found, launch_metrics = launch_findings(cfg, frozen, counts,
                                                cell_steps(cfg, PROBE_T))
        leak += found
        leak_metrics.update(launch_metrics, launches={k: v for k, v in counts.items() if v})
    violations += leak
    params, opt_state, loss = trace.outputs

    # the compute dtype is the policy floor; conversions up to the state
    # dtype are the declared float32 accumulation points
    dt, dt_metrics = dtype_findings(trace.ops, policy_dtype=cfg.compute_dtype,
                                    state_dtype=cfg.dtype)
    violations += dt
    acc, acc_metrics = accumulation_findings(params, opt_state, loss, state_dtype=cfg.dtype)
    violations += acc

    sched = torch.stack([(torch.arange(b, device=dev) + k) % PROBE_SERIES
                         for k in range(PROBE_STEPS)])
    before = state_storages(params, opt_state)
    params, opt_state, losses = make_superstep_fn(step)(params, opt_state, sched)
    _synced(dev)
    don, don_metrics = donation_findings(before, state_storages(params, opt_state),
                                         state_leaf_count(params, opt_state))
    violations += don
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"the audited {engine} step gave losses {losses.tolist()}")

    return AuditSection("fit", violations, {
        "head": cfg.head, "precision": cfg.precision, "engine": engine,
        "device": str(dev), "probe_batch": b, "frozen_groups": sorted(frozen),
        "gradient_leak": leak_metrics, "dtype": dt_metrics,
        "accumulation": acc_metrics, "donation": don_metrics})


def audit_fit(spec, *, device=None, generator=None, params=None) -> AuditSection:
    """Gradient-leak + donation + dtype lints on the real training step."""
    cfg, params, y, cats = probe_model(spec, device, generator, params)
    frozen = frozen_param_groups(cfg)
    step, opt_init, engine = fit_step(spec, cfg, y, cats, frozen)
    opt = opt_init(split_frozen(params, frozen)[0])
    return audit_step(cfg, step, params, opt, frozen, engine=engine)


def audit_predict(spec, *, device=None, generator=None, params=None) -> AuditSection:
    """Dtype lint over the forecast; on the card, its launches."""
    cfg, params, y, cats = probe_model(spec, device, generator, params)
    before = ops.launch_counts()
    with OpRecorder() as rec:
        fc = esrnn_forecast(cfg, params, y, cats)
    _synced(y.device)
    if not bool(torch.isfinite(fc).all()):
        raise RuntimeError("the audited forecast is not finite")
    findings, metrics = dtype_findings(rec, policy_dtype=cfg.compute_dtype,
                                       state_dtype=cfg.dtype)
    out = {"precision": cfg.precision, "device": str(y.device), "dtype": metrics}
    if y.device.type == "cuda":
        out["launches"] = {k: v - before[k] for k, v in ops.launch_counts().items()
                           if v != before[k]}
    return AuditSection("predict", findings, out)


def audit_serve(spec, *, device=None, generator=None, params=None, waves: int = 2,
                requests: int = 24, dispatcher=BucketDispatcher) -> AuditSection:
    """Launch-shape sentinel on the real serving dispatcher.

    Drives ``waves`` identical request waves through ``dispatcher`` (the
    port's :class:`~repro_torch.forecast.serving.BucketDispatcher`) on length
    buckets (32, 64) and batch buckets (1, 8). Violations: more distinct
    bucket shapes than ``compile_budget``, more kernel launch shapes than
    ``compile_budget x bucket_launch_shapes``, any new launch shape on the
    warm second wave, or any issued by a dispatch of an already-seen bucket
    (the shapes escape the buckets: the ``fc[:n]`` family).
    """
    cfg, params, _, _ = probe_model(spec, device, generator, params)
    srv = dispatcher(cfg, params, length_buckets=(32, 64), batch_buckets=(1, 8),
                     device=params["hw"].alpha_logit.device)
    budget, launch_budget = srv.compile_budget, srv.launch_shape_budget
    violations: List[Finding] = []
    wave_shapes = []
    for _ in range(waves):
        before = srv.stats.launch_shapes
        reqs = synthetic_request_stream(cfg, requests, n_known=PROBE_SERIES, seed=0,
                                        len_range=(20, 60))
        out = srv.forecast_batch(reqs)
        if not all(np.isfinite(o).all() for o in out):
            raise RuntimeError("the audited dispatcher served a non-finite forecast")
        wave_shapes.append(srv.stats.launch_shapes - before)
    s = srv.stats
    if s.compiles > budget:
        violations.append(Finding(
            "recompile",
            f"serving dispatched {s.compiles} distinct bucket shapes over {waves} waves, "
            f"above the declared bucket-grid budget of {budget}"))
    if s.launch_shapes > launch_budget:
        violations.append(Finding(
            "recompile",
            f"serving issued {s.launch_shapes} distinct kernel launch shapes over "
            f"{waves} waves, above the grid's {launch_budget} ({budget} buckets x "
            f"{launch_budget // max(budget, 1)} kernel shapes a bucket)"))
    if waves > 1 and wave_shapes[-1] > 0:
        violations.append(Finding(
            "recompile",
            f"warm wave still issued {wave_shapes[-1]} new kernel launch shapes: an "
            f"unbounded shape family on the serving hot path"))
    if s.repeat_launch_shapes:
        violations.append(Finding(
            "recompile",
            f"dispatches of already-seen bucket shapes issued {s.repeat_launch_shapes} "
            f"new kernel launch shapes: the kernels' shapes escape the buckets (the "
            f"reference's fc[:n] class)"))
    return AuditSection("serve", violations, {
        "device": str(srv.device), "compile_budget": budget,
        "launch_shape_budget": launch_budget, "launch_shapes": s.launch_shapes,
        "bucket_compiles": s.compiles, "cache_hits": s.cache_hits,
        "wave_launch_shapes": wave_shapes, "repeat_launch_shapes": s.repeat_launch_shapes,
        "kernel_launches": {k: v for k, v in s.kernel_launches.items() if v}})


def audit_collectives(spec, devices: int = 2, *, device=None,
                      loss_fn=S.esrnn_loss_dp) -> AuditSection:
    """The documented collectives of sharded predict and the sharded loss
    gradient, on ``devices`` ranks (``loss_fn`` as in
    :func:`~repro_torch.analysis.collectives.collective_audit`)."""
    counts = collective_audit(spec.model, devices, device=device, loss_fn=loss_fn)
    findings, metrics = collective_findings(counts)
    return AuditSection("collectives", findings,
                        {**metrics, "backend": counts["backend"], "counts": counts})


_ENTRY_POINTS = {
    "fit": audit_fit,
    "predict": audit_predict,
    "serve": audit_serve,
}


def run_audit(spec, entries: Sequence[str] = ("fit", "predict", "serve"),
              devices: Optional[int] = None, device=None) -> AuditReport:
    """Audit the requested entry points of one ``ForecastSpec`` on ``device``
    (default the card), each section's params drawn from a generator seeded
    0. ``devices`` > 1 (or the entry ``"collectives"``) adds the
    collective audit on that many ranks (default 2)."""
    unknown = [e for e in entries if e not in _ENTRY_POINTS and e != "collectives"]
    if unknown:
        raise ValueError(
            f"unknown audit entry point {unknown[0]!r}; "
            f"pick from {sorted(_ENTRY_POINTS)} + ['collectives']")
    sections = [_ENTRY_POINTS[name](spec, device=device,
                                    generator=torch.Generator().manual_seed(0))
                for name in entries if name != "collectives"]
    if (devices and devices > 1) or "collectives" in entries:
        sections.append(audit_collectives(spec, devices or 2, device=device))
    return AuditReport(spec.name, sections)
