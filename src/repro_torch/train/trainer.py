"""ES-RNN trainer: joint per-series + shared-weight optimization loop.

PyTorch port of ``repro.train.trainer`` for one device with the whole
per-series table resident on it:

* the superstep engine (``scan_steps`` = K steps, one host sync at the end
  of each); the per-step engine is its K = 1 case. Both read the same
  stateless batch schedule (``repro_torch.data.pipeline``), so both walk
  the same trajectory;
* dense or sparse two-group Adam (``sparse_adam``);
* validation sMAPE on the held-out window at every ``eval_every`` boundary
  and at the end (paper section 5.1);
* checkpoint/restart (``ckpt_dir``): atomic checkpoints of ``(params,
  opt_state)`` in the JAX package's format
  (:mod:`repro_torch.checkpoint`), at every eval boundary (with the
  validation sMAPE as the metric), every ``ckpt_every`` boundary and on
  preemption; a run with checkpoints in its ``ckpt_dir`` resumes from the
  latest one. The batch schedule is stateless in the step, so a resumed
  run walks the unbroken run's trajectory;
* a SIGTERM/SIGINT handler that checkpoints and stops at the next boundary;
* a wall-time EWMA per step that records stragglers.

Series data parallelism, gradient compression and the chunked out-of-core
fit belong to later slices of the port (ROADMAP.md, section 1); asking for
them raises :class:`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import copy_params
from repro_torch.core import losses as L
from repro_torch.core.esrnn import ESRNNConfig, esrnn_forecast, esrnn_init
from repro_torch.core.heads import frozen_param_groups
from repro_torch.data.pipeline import PreparedData, batch_schedule
from repro_torch.device import resolve_device
from repro_torch.train.engine import (
    make_step_fn, make_superstep_fn, segment_steps, split_frozen,
)
from repro_torch.train.optimizer import AdamConfig, adam_init, adam_init_sparse

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 256
    n_steps: int = 300
    lr: float = 1e-3
    per_series_lr_mult: float = 10.0    # HW params learn faster (Smyl setup)
    clip_norm: Optional[float] = 20.0
    seed: int = 0
    eval_every: int = 50
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None      # checkpoint/restart directory
    keep: int = 3
    straggler_factor: float = 3.0
    data_parallel: int = 0              # > 1: a later slice
    scan_steps: int = 1                 # steps per superstep (1 = per-step)
    sparse_adam: bool = False           # segment per-series Adam
    compress_grads: bool = False        # a later slice
    series_chunk: int = 0               # > 0 (chunked fit): a later slice

    @classmethod
    def from_spec(cls, spec, *, ckpt_dir: Optional[str] = None,
                  n_steps: Optional[int] = None) -> "TrainConfig":
        """Build from a forecast spec (``rnn_lr`` for the shared weights,
        ``hw_lr`` for the per-series group), as the reference does."""
        return cls(
            batch_size=spec.batch_size,
            n_steps=spec.n_steps if n_steps is None else n_steps,
            lr=spec.rnn_lr,
            per_series_lr_mult=spec.hw_lr / spec.rnn_lr,
            clip_norm=spec.clip_norm,
            seed=spec.seed,
            eval_every=spec.eval_every,
            ckpt_every=spec.ckpt_every,
            ckpt_dir=ckpt_dir,
            keep=spec.keep,
            data_parallel=spec.data_parallel,
            scan_steps=spec.scan_steps,
            sparse_adam=spec.sparse_adam,
            compress_grads=getattr(spec, "compress_grads", False),
            series_chunk=getattr(spec, "series_chunk", 0),
        )


class PreemptionHandler:
    """Converts SIGTERM/SIGINT into a cooperative stop flag."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum, frame):
        self.requested = True

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


def _refuse_unported(cfg: TrainConfig, mesh) -> None:
    later = {
        "data_parallel > 1 / mesh": ((cfg.data_parallel or 0) > 1 or mesh is not None,
                                     "the series data parallelism"),
        "compress_grads": (cfg.compress_grads, "the series data parallelism"),
        "series_chunk > 0": ((cfg.series_chunk or 0) > 0, "the out-of-core chunked fit"),
    }
    for what, (asked, slice_name) in later.items():
        if asked:
            raise NotImplementedError(
                f"TrainConfig {what}: comes with {slice_name} slice of the "
                f"port (ROADMAP.md, section 1)")


def train_esrnn(
    model: ESRNNConfig,
    data: PreparedData,
    cfg: TrainConfig,
    *,
    params=None,
    hooks: Optional[Dict[str, Callable]] = None,
    mesh=None,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> Dict:
    """Train; returns ``dict(params, opt_state, history, resumed_from)``.

    Runs on ``device`` (default: the card). ``params``, if given, is copied
    there (the caller's tensors are not touched); otherwise they are drawn
    from ``generator`` (default: a CPU generator seeded with ``cfg.seed``),
    so the same seed gives the same init on every device. ``scan_steps > 1``
    selects the superstep engine; ``sparse_adam`` the segment update of the
    per-series table. The ``on_step`` hook gets ``(last_step, loss, params)``
    -- a float per step, or the segment's loss array under supersteps.
    When ``cfg.ckpt_dir`` holds a checkpoint, the run restores ``(params,
    opt_state)`` from the latest one onto ``device`` and continues from its
    step (``resumed_from``); ``history`` then covers the resumed steps only.
    """
    _refuse_unported(cfg, mesh)
    mcfg = model
    dev = resolve_device(device)
    cfg_adam = AdamConfig(
        lr=cfg.lr,
        clip_norm=cfg.clip_norm,
        group_lr={"per_series": cfg.per_series_lr_mult, "default": 1.0},
    )
    n = data.n_series
    if params is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
        params = esrnn_init(gen, mcfg, n, device=dev)
    else:
        params = copy_params(params, dev)
    frozen = frozen_param_groups(mcfg)
    trainable, _ = split_frozen(params, frozen)
    opt_state = (adam_init_sparse(trainable) if cfg.sparse_adam
                 else adam_init(trainable))
    start_step = 0

    ckpt = (Checkpointer(cfg.ckpt_dir, keep=cfg.keep, frozen=frozen)
            if cfg.ckpt_dir else None)
    if ckpt is not None and ckpt.latest_step() is not None:
        try:
            start_step, (params, opt_state) = ckpt.restore((params, opt_state))
        except ValueError as e:
            # checkpoints are engine-portable (scan_steps), but the sparse
            # optimizer state carries an extra per-row clock: flipping
            # sparse_adam across a resume is a real state mismatch. Other
            # restore failures (shape drift etc.) pass through untouched.
            if "tree structure mismatch" not in str(e):
                raise
            raise ValueError(
                f"cannot resume from {cfg.ckpt_dir}: {e}. If this run was "
                f"checkpointed with a different sparse_adam setting "
                f"(currently {cfg.sparse_adam}), resume with the original "
                "setting -- the dense and sparse Adam states are not "
                "interchangeable") from e
        log.info("resumed from step %d", start_step)

    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    y_all, cats_all, mask_all = to_dev(data.train), to_dev(data.cats), to_dev(data.mask)
    h_val = min(mcfg.output_size, data.val_target.shape[1])
    val_target = to_dev(data.val_target)[:, :h_val]
    bs = min(cfg.batch_size, n)
    step_fn = make_step_fn(mcfg, cfg_adam, y_all, cats_all, mask_all,
                           sparse=cfg.sparse_adam, frozen=frozen)

    def val_smape(params) -> float:
        fc = esrnn_forecast(mcfg, params, y_all, cats_all)
        return float(L.smape(fc[:, :h_val], val_target))

    pre = PreemptionHandler()
    pre.install()
    history = {"loss": [], "val_smape": [], "stragglers": []}
    ewma = None
    fused = cfg.scan_steps > 1          # the hook gets the segment's losses

    def boundary_work(reached: int, losses: np.ndarray) -> bool:
        """Host work at a step boundary; True when the trainer should stop."""
        history["loss"].extend(float(v) for v in losses)
        if reached % cfg.eval_every == 0 or reached == cfg.n_steps:
            vs = val_smape(params)
            history["val_smape"].append((reached, vs))
            if ckpt is not None:
                ckpt.save(reached, (params, opt_state), metric=vs)
        elif ckpt is not None and reached % cfg.ckpt_every == 0:
            ckpt.save(reached, (params, opt_state))
        if hooks and "on_step" in hooks:
            hooks["on_step"](reached - 1, losses if fused else float(losses[0]),
                             params)
        if pre.requested:
            log.warning("preemption requested at step %d; checkpointing", reached)
            if ckpt is not None:
                ckpt.save(reached, (params, opt_state))
            return True
        return False

    def track_time(first_step: int, dt_per_step: float, k: int):
        nonlocal ewma
        ewma = dt_per_step if ewma is None else 0.9 * ewma + 0.1 * dt_per_step
        if first_step > 5 and dt_per_step > cfg.straggler_factor * ewma:
            history["stragglers"].append((first_step, dt_per_step, ewma))
            log.warning("straggler step %d (x%d): %.3fs/step vs ewma %.3fs",
                        first_step, k, dt_per_step, ewma)

    # one loop for both engines: the per-step engine is the superstep at
    # K = 1 (segments of one step, one host sync each)
    superstep_fn = make_superstep_fn(step_fn)
    if fused:
        log.info("superstep engine: scan_steps=%d%s", cfg.scan_steps,
                 ", sparse per-series adam" if cfg.sparse_adam else "")
    try:
        for step, k in segment_steps(start_step, cfg.n_steps, max(1, cfg.scan_steps),
                                     cfg.eval_every, cfg.ckpt_every):
            sched = to_dev(batch_schedule(n, bs, step, k, seed=cfg.seed))
            t0 = time.perf_counter()
            params, opt_state, losses = superstep_fn(params, opt_state, sched)
            losses = losses.cpu().numpy()           # the one host sync per segment
            track_time(step, (time.perf_counter() - t0) / k, k)
            if boundary_work(step + k, losses):
                break
    finally:
        pre.uninstall()

    return {"params": params, "opt_state": opt_state, "history": history,
            "resumed_from": start_step}


def train_from_spec(
    spec,
    data: PreparedData,
    *,
    ckpt_dir: Optional[str] = None,
    n_steps: Optional[int] = None,
    params=None,
    hooks: Optional[Dict[str, Callable]] = None,
    mesh=None,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> Dict:
    """Spec-driven entry point: a ``ForecastSpec`` in, trained params out.

    The path ``repro_torch.forecast.ESRNNForecaster.fit`` and the
    ``repro_torch.launch.forecast`` CLI take; the two-group learning rates
    come from the spec's ``rnn_lr`` / ``hw_lr``. ``device`` and
    ``generator`` as in :func:`train_esrnn`.
    """
    cfg = TrainConfig.from_spec(spec, ckpt_dir=ckpt_dir, n_steps=n_steps)
    return train_esrnn(spec.model, data, cfg, params=params, hooks=hooks,
                       mesh=mesh, device=device, generator=generator)
