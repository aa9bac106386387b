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
* a wall-time EWMA per step that records stragglers;
* the out-of-core chunked fit (``series_chunk > 0``,
  :func:`_train_chunked`): the per-series table and its sparse-Adam state
  live in a host :class:`~repro_torch.train.host_table.HostStateTable`
  (pinned on the card) and stream through the device one chunk of rows at
  a time on a copy stream, while the shared weights stay on the device;
  ``chunk_resident=True`` walks the same chunk-major schedule with the
  whole table on the device, the trajectory the streamed fit reproduces
  bit for bit;
* series data parallelism (``mesh=``, or ``data_parallel > 1`` over an
  initialized process group, :mod:`repro_torch.sharding`): every rank holds
  the whole replicated state, computes its block of each batch's rows and
  takes the same update, so the ranks stay bit-identical; a 1-rank mesh
  is the single-device path. The batch (each chunk's batch, chunked) must
  divide the mesh. Rank 0 alone writes checkpoints;
* int8 error-feedback compression of the shared-weight gradients
  (``compress_grads``, dense Adam only), its residuals carried in the
  optimizer state and in checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, is_table_path
from repro_torch.convert import copy_params
from repro_torch.core import losses as L
from repro_torch.core.esrnn import ESRNNConfig, esrnn_forecast, esrnn_init, param_leaves
from repro_torch.core.heads import frozen_param_groups
from repro_torch.core.holt_winters import HWParams
from repro_torch.data.pipeline import (
    PreparedData, batch_schedule, chunk_batch_schedule, chunk_layout,
    chunk_visit_plan,
)
from repro_torch.device import resolve_device
from repro_torch.train.engine import (
    make_chunk_step_fn, make_chunk_superstep_fn, make_step_fn,
    make_superstep_fn, segment_steps, split_frozen,
)
from repro_torch.train.host_table import (
    HostStateTable, StagedRows, copy_ms, pinned_copy, stream_chunks, to_device,
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
    data_parallel: int = 0              # > 1: ranks of a series mesh
    scan_steps: int = 1                 # steps per superstep (1 = per-step)
    sparse_adam: bool = False           # segment per-series Adam
    compress_grads: bool = False        # int8 error-feedback compression
                                        # of the shared-weight gradients
    series_chunk: int = 0               # > 0: the out-of-core chunked fit,
                                        # the table streamed in K-row chunks
    chunk_resident: bool = False        # debug reference: the chunk-major
                                        # schedule with the whole table on
                                        # the device (not spec-exposed)

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


def _resolve_train_mesh(cfg: TrainConfig, mesh, dev: torch.device):
    """The series mesh of a fit: ``mesh``, else one over the process group
    when ``cfg.data_parallel > 1`` (raising when none of that size is
    initialized); a 1-rank mesh is the single-device path."""
    if mesh is None and cfg.data_parallel and cfg.data_parallel > 1:
        from repro_torch.sharding.series import make_series_mesh

        mesh = make_series_mesh(cfg.data_parallel, device=dev)
    if mesh is not None and mesh.size == 1:
        mesh = None
    if mesh is not None and mesh.device != dev:
        raise ValueError(f"the series mesh puts this rank on {mesh.device}, the fit on {dev}")
    return mesh


def _shared_leaves(trainable) -> List[torch.Tensor]:
    """The trainable shared-weight leaves (``param_leaves`` order, no ``hw``):
    what gradient compression and its residuals cover."""
    return [t for path, t in param_leaves(trainable) if path[0] != "hw"]


def _chunked_config(cfg: TrainConfig) -> TrainConfig:
    """The reference's entry rules of a chunked fit: no gradient compression
    (it needs the dense optimizer), and sparse Adam implied."""
    if cfg.compress_grads:
        raise ValueError(
            "series_chunk > 0 requires the sparse optimizer path and "
            "compress_grads requires the dense one: the chunked fit "
            "never materializes a shared-gradient exchange to compress")
    if not cfg.sparse_adam:
        log.info("series_chunk=%d: enabling sparse per-series Adam "
                 "(the chunked path only ever holds the batch's rows)",
                 cfg.series_chunk)
        cfg = dataclasses.replace(cfg, sparse_adam=True)
    return cfg


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

    ``series_chunk > 0`` implies ``sparse_adam`` and runs the streamed
    chunked fit (:func:`_train_chunked`), whose returned ``params["hw"]``
    stays on the host; with ``chunk_resident`` the same chunk-major
    schedule runs over the whole table on ``device``.

    ``mesh`` (or ``data_parallel > 1``) trains series-data-parallel: the
    same trajectory as one device up to float summation order, the ranks
    bit-identical (:mod:`repro_torch.sharding.series`). ``compress_grads``
    sends the shared-weight gradients through int8 error-feedback
    compression (dense Adam only); ``opt_state`` is then ``(adam_state,
    residuals)``.
    """
    chunked = (cfg.series_chunk or 0) > 0
    if chunked:
        cfg = _chunked_config(cfg)
    if chunked and not cfg.chunk_resident:
        return _train_chunked(model, data, cfg, params=params, hooks=hooks,
                              mesh=mesh, device=device, generator=generator)
    mcfg = model
    dev = resolve_device(device)
    mesh = _resolve_train_mesh(cfg, mesh, dev)
    if mesh is not None:
        from repro_torch.sharding.series import check_series_divisible

        if chunked:
            for _, _, bs_c, _ in chunk_layout(data.n_series, cfg.series_chunk,
                                              cfg.batch_size)[0]:
                check_series_divisible(bs_c, mesh)
        else:
            check_series_divisible(min(cfg.batch_size, data.n_series), mesh)
        log.info("series-data-parallel training: rank %d of %d (%s)", mesh.rank,
                 mesh.size, mesh.backend)
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
    if cfg.compress_grads:
        if cfg.sparse_adam:
            raise ValueError(
                "compress_grads requires dense Adam (sparse_adam=False): "
                "the sparse path has no shared-gradient exchange to compress")
        from repro_torch.train.grad_compression import init_error_state

        opt_state = (opt_state, init_error_state(_shared_leaves(trainable)))
        log.info("error-feedback int8 compression of shared grads enabled")
    start_step = 0

    ckpt = (Checkpointer(cfg.ckpt_dir, keep=cfg.keep, frozen=frozen, mesh=mesh)
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
    step_fn = make_step_fn(mcfg, cfg_adam, y_all, cats_all, mask_all, mesh=mesh,
                           sparse=cfg.sparse_adam, frozen=frozen,
                           compress=cfg.compress_grads)

    def val_smape(params) -> float:
        if mesh is None:
            fc = esrnn_forecast(mcfg, params, y_all, cats_all)
            return float(L.smape(fc[:, :h_val], val_target))
        # each rank scores its block of the rows; one all-reduce of the terms
        lo, hi = mesh.block(0, n)
        fc = esrnn_forecast(mcfg, {**params, "hw": params["hw"].map(lambda a: a[lo:hi])},
                            y_all[lo:hi], cats_all[lo:hi])
        s, c = mesh.all_reduce(torch.stack(
            L.smape_terms(fc[:, :h_val], val_target[lo:hi])).float())
        return float(200.0 * s / torch.clamp_min(c, 1.0))

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
    if chunked:
        # the chunk-resident reference engine: the chunk-major schedule
        # (chunk-pure batches, permuted visit order) over the whole table,
        # fed global rows (lo + local index) -- the trajectory the streamed
        # fit must reproduce
        fused = True
        log.info("chunk-resident reference engine: series_chunk=%d", cfg.series_chunk)
        segments = ((step, k, v.lo + chunk_batch_schedule(
            v.hi - v.lo, v.batch_size, v.epoch, v.chunk_id, v.start_k + (step - v.step),
            k, seed=cfg.seed))
            for v in chunk_visit_plan(n, cfg.series_chunk, cfg.batch_size, start_step,
                                      cfg.n_steps, seed=cfg.seed)
            for step, k in segment_steps(v.step, v.step + v.n_steps, max(1, cfg.scan_steps),
                                         cfg.eval_every, cfg.ckpt_every))
    else:
        if fused:
            log.info("superstep engine: scan_steps=%d%s", cfg.scan_steps,
                     ", sparse per-series adam" if cfg.sparse_adam else "")
        segments = ((step, k, batch_schedule(n, bs, step, k, seed=cfg.seed))
                    for step, k in segment_steps(start_step, cfg.n_steps,
                                                 max(1, cfg.scan_steps),
                                                 cfg.eval_every, cfg.ckpt_every))
    try:
        for step, k, sched in segments:
            sched = to_dev(sched)
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


def _hw_slots(trainable) -> List[bool]:
    """Per leaf of ``param_leaves(trainable)``: True where it is an ``hw`` leaf."""
    return [path[0] == "hw" for path, _ in param_leaves(trainable)]


def _merge_moments(slots: List[bool], hw: HWParams, shared: List) -> List:
    """One moment list in ``param_leaves`` order: the ``hw`` leaves from
    ``hw`` (field order), the others from ``shared`` (their order)."""
    hw_it = iter([getattr(hw, f.name) for f in dataclasses.fields(HWParams)
                  if getattr(hw, f.name) is not None])
    sh_it = iter(shared)
    return [next(hw_it) if is_hw else next(sh_it) for is_hw in slots]


def _shared_moments(slots: List[bool], moments: List) -> List:
    return [m for is_hw, m in zip(slots, moments) if not is_hw]


def _hw_moments(slots: List[bool], moments: List, like: HWParams) -> HWParams:
    it = iter([m for is_hw, m in zip(slots, moments) if is_hw])
    return like.map(lambda _: next(it))


def _train_chunked(
    mcfg: ESRNNConfig,
    data: PreparedData,
    cfg: TrainConfig,
    *,
    params=None,
    hooks: Optional[Dict[str, Callable]] = None,
    mesh=None,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> Dict:
    """The streaming chunked fit: out-of-core HW table, resident head.

    The N-series state -- HW rows, their sparse-Adam moments, the ``t_hw``
    clocks -- lives in a :class:`HostStateTable` (pinned host tensors on
    the card), and the training tensors stay the caller's (each visit pins
    a copy of its own rows); only one ``series_chunk``-row slice of them is
    on the device at a time. The
    shared weights, their moments and the global Adam step count stay on
    the device across chunks. Epochs visit the chunks in permuted order with
    chunk-pure batches (:func:`chunk_visit_plan`); within a visit the
    chunk superstep runs the ordinary segments. The next visit's rows are
    copied on the table's copy stream while the current visit computes,
    unless they are the same rows, whose device state is handed straight
    across; a visit's rows are written back when they change hands, and at
    every checkpoint, eval and preemption boundary.

    ``t_hw`` carries global last-touch steps and the Adam step count is
    global, so the per-chunk sparse updates are exact: the fit walks the
    trajectory of ``chunk_resident=True`` bit for bit. The validation sMAPE
    accumulates each chunk's ``smape_terms`` in float64 on the host.
    Checkpoints hold the tree of a resident sparse fit (table leaves
    row-sharded), so the two resume into each other. The returned
    ``params["hw"]`` and the table's moments and clocks stay on the host.

    Over a series mesh every rank holds the whole host table and stages
    each visit's chunk whole: the steps split each batch's rows and reduce
    the gradients (every chunk's batch must divide the mesh), every rank
    absorbs the same rows, and the streamed val scores each rank's block of
    every chunk, reduced once.
    """
    dev = resolve_device(device)
    mesh = _resolve_train_mesh(cfg, mesh, dev)
    n = data.n_series
    per_chunk, _ = chunk_layout(n, cfg.series_chunk, cfg.batch_size)
    if mesh is not None:
        from repro_torch.sharding.series import check_series_divisible

        for _, _, bs_c, _ in per_chunk:
            check_series_divisible(bs_c, mesh)
        log.info("chunked + series-data-parallel: %d chunks, rank %d of %d",
                 len(per_chunk), mesh.rank, mesh.size)
    cfg_adam = AdamConfig(
        lr=cfg.lr,
        clip_norm=cfg.clip_norm,
        group_lr={"per_series": cfg.per_series_lr_mult, "default": 1.0},
    )
    frozen = frozen_param_groups(mcfg)

    if params is not None:
        # warm start: the caller's rows copied into the table, its shared
        # weights copied to the device
        table = HostStateTable.from_state(params, with_moments=True, device=dev)
        shared = copy_params({k: v for k, v in params.items() if k != "hw"}, dev)
    else:
        # the HW primer draws nothing from the generator, so a 1-row init
        # gives the shared weights of the resident esrnn_init(gen, mcfg, n)
        gen = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
        shared = {k: v for k, v in esrnn_init(gen, mcfg, 1, device=dev).items() if k != "hw"}
        table = HostStateTable.init(n, mcfg.seasonality, seasonality2=mcfg.seasonality2,
                                    dtype=np.dtype(mcfg.dtype), device=dev)
    shared_train, _ = split_frozen(shared, frozen)
    sh_opt = adam_init(shared_train)
    mu_sh, nu_sh, step_count = sh_opt["mu"], sh_opt["nu"], sh_opt["step"]
    slots = _hw_slots({"hw": table.hw, **shared_train})
    log.info("streaming chunked fit: N=%d series_chunk=%d (%d chunks), host table "
             "%.1f MB%s", n, cfg.series_chunk, len(per_chunk), table.nbytes() / 1e6,
             ", pinned" if dev.type == "cuda" else "")

    def full_state():
        """The checkpoint and return tree: a resident sparse fit's."""
        return ({"hw": table.hw, **shared},
                {"mu": _merge_moments(slots, table.mu_hw, mu_sh),
                 "nu": _merge_moments(slots, table.nu_hw, nu_sh),
                 "step": step_count, "t_hw": table.t_hw})

    start_step = 0
    ckpt = (Checkpointer(cfg.ckpt_dir, keep=cfg.keep, frozen=frozen, mesh=mesh)
            if cfg.ckpt_dir else None)
    if ckpt is not None and ckpt.latest_step() is not None:
        try:
            start_step, (p_full, o_full) = ckpt.restore(full_state(),
                                                        host_paths=is_table_path)
        except ValueError as e:
            if "tree structure mismatch" not in str(e):
                raise
            raise ValueError(
                f"cannot resume from {cfg.ckpt_dir}: {e}. Chunked fits "
                "carry the sparse-Adam state; a checkpoint written with "
                "sparse_adam=False (dense moments) is not interchangeable "
                "-- resume with the original setting") from e
        table = HostStateTable.adopt(
            p_full["hw"], mu_hw=_hw_moments(slots, o_full["mu"], table.hw),
            nu_hw=_hw_moments(slots, o_full["nu"], table.hw), t_hw=o_full["t_hw"],
            device=dev)
        shared = {k: v for k, v in p_full.items() if k != "hw"}
        mu_sh = _shared_moments(slots, o_full["mu"])
        nu_sh = _shared_moments(slots, o_full["nu"])
        step_count = o_full["step"]
        log.info("resumed from step %d", start_step)

    def data_rows(arrays, lo, hi):
        """Pinned copies of rows [lo, hi) of the training arrays. Only a
        chunk's rows are pinned at a time: a pinned copy of the whole set
        would hold a second copy of the caller's data in host memory (the
        pinned-host allocator caches the chunk-sized blocks for reuse)."""
        return [pinned_copy(np.ascontiguousarray(a[lo:hi]), dev) for a in arrays]

    h_val = min(mcfg.output_size, data.val_target.shape[1])

    superstep_fn = make_chunk_superstep_fn(make_chunk_step_fn(mcfg, cfg_adam, mesh=mesh,
                                                              frozen=frozen))

    def streamed_val_smape() -> float:
        """Validation sMAPE with no full-table residency: every chunk's
        forecast scored as exact sum and count terms, added in float64 on
        the host in chunk order (:func:`stream_chunks`); over a mesh each
        rank streams its block of every chunk and the sums are reduced once."""
        acc = [0.0, 0.0]
        ranges = [(lo, hi) for lo, hi, _, _ in per_chunk]
        if mesh is not None:
            ranges = [mesh.block(lo, hi) for lo, hi in ranges]

        def compute(rows):
            y_c, cats_c, tgt_c = rows.extra
            fc = esrnn_forecast(mcfg, {"hw": rows.state["hw"], **shared}, y_c, cats_c)
            return L.smape_terms(fc[:, :h_val], tgt_c[:, :h_val])

        def finish(lo, hi, terms):
            acc[0] += float(terms[0])
            acc[1] += float(terms[1])

        stream_chunks(table, [r for r in ranges if r[1] > r[0]],
                      lambda lo, hi: data_rows((data.train, data.cats, data.val_target),
                                               lo, hi),
                      compute, finish)
        if mesh is not None:
            acc = mesh.all_reduce(torch.tensor(acc, dtype=torch.float64,
                                               device=mesh.device)).tolist()
        return 200.0 * acc[0] / max(acc[1], 1.0)

    def stage(v):
        """Issue the copies of one visit's rows: table rows and data."""
        return table.device_slice(v.lo, v.hi, data_rows((data.train, data.cats, data.mask),
                                                        v.lo, v.hi))

    pre = PreemptionHandler()
    pre.install()
    history = {"loss": [], "val_smape": [], "stragglers": []}
    copies = []                 # the visits' copy events and readiness, read at the end
    ewma = None
    stop = False

    def track_time(first_step: int, dt_per_step: float, k: int):
        nonlocal ewma
        ewma = dt_per_step if ewma is None else 0.9 * ewma + 0.1 * dt_per_step
        if first_step > 5 and dt_per_step > cfg.straggler_factor * ewma:
            history["stragglers"].append((first_step, dt_per_step, ewma))
            log.warning("straggler step %d (x%d): %.3fs/step vs ewma %.3fs",
                        first_step, k, dt_per_step, ewma)

    def sync_shared(copt):
        nonlocal mu_sh, nu_sh, step_count
        mu_sh = _shared_moments(slots, copt["mu"])
        nu_sh = _shared_moments(slots, copt["nu"])
        step_count = copt["step"]

    def chunk_rows(cparams, copt):
        return {"hw": cparams["hw"], "mu": _hw_moments(slots, copt["mu"], cparams["hw"]),
                "nu": _hw_moments(slots, copt["nu"], cparams["hw"]), "t_hw": copt["t_hw"]}

    def retire(v, cparams, copt):
        """Write the visit's rows back into the host table; sync the shared
        state."""
        sync_shared(copt)
        table.absorb(v.lo, v.hi, chunk_rows(cparams, copt))

    def chunk_boundary(v, reached, losses, cparams, copt):
        nonlocal stop
        history["loss"].extend(float(x) for x in losses)
        do_eval = reached % cfg.eval_every == 0 or reached == cfg.n_steps
        do_ckpt = ckpt is not None and (do_eval or reached % cfg.ckpt_every == 0)
        if do_eval or do_ckpt or pre.requested:
            # eval and checkpoints read the chunk's latest rows in the table
            retire(v, cparams, copt)
        if do_eval:
            vs = streamed_val_smape()
            history["val_smape"].append((reached, vs))
            if ckpt is not None:
                ckpt.save(reached, full_state(), metric=vs, shard_rows=cfg.series_chunk)
        elif do_ckpt:
            ckpt.save(reached, full_state(), shard_rows=cfg.series_chunk)
        if hooks and "on_step" in hooks:
            hooks["on_step"](reached - 1, losses, cparams)
        if pre.requested:
            log.warning("preemption requested at step %d; checkpointing", reached)
            if ckpt is not None:
                ckpt.save(reached, full_state(), shard_rows=cfg.series_chunk)
            stop = True

    visits = list(chunk_visit_plan(n, cfg.series_chunk, cfg.batch_size, start_step,
                                   cfg.n_steps, seed=cfg.seed))
    staged = stage(visits[0]) if visits else None
    try:
        for i, v in enumerate(visits):
            cur, staged = staged.wait(), None
            if cur.done is not None:
                copies.append((cur.start, cur.done, cur.ready))
            y_c, cats_c, mask_c = cur.extra
            cparams = {"hw": cur.state["hw"], **shared}
            copt = {"mu": _merge_moments(slots, cur.state["mu"], mu_sh),
                    "nu": _merge_moments(slots, cur.state["nu"], nu_sh),
                    "step": step_count, "t_hw": cur.state["t_hw"]}
            nxt = visits[i + 1] if i + 1 < len(visits) else None
            same_rows = nxt is not None and (nxt.lo, nxt.hi) == (v.lo, v.hi)
            if nxt is not None and not same_rows:
                # the next visit's copies run while this visit computes; a
                # same-rows next visit takes this one's device state instead
                # (the table's copy of its rows would be stale)
                staged = stage(nxt)
            for step, k in segment_steps(v.step, v.step + v.n_steps, max(1, cfg.scan_steps),
                                         cfg.eval_every, cfg.ckpt_every):
                sched = to_device(chunk_batch_schedule(
                    v.hi - v.lo, v.batch_size, v.epoch, v.chunk_id,
                    v.start_k + (step - v.step), k, seed=cfg.seed), dev)
                t0 = time.perf_counter()
                cparams, copt, losses = superstep_fn(cparams, copt, y_c, cats_c, mask_c,
                                                     sched)
                losses = losses.cpu().numpy()       # the one host sync per segment
                track_time(step, (time.perf_counter() - t0) / k, k)
                chunk_boundary(v, step + k, losses, cparams, copt)
                if stop:
                    break
            if stop:
                break
            if same_rows:
                staged = StagedRows(chunk_rows(cparams, copt), [y_c, cats_c, mask_c])
                sync_shared(copt)
            else:
                retire(v, cparams, copt)
    finally:
        pre.uninstall()

    if copies:
        # each streamed visit's copies: device milliseconds, and whether
        # they had finished before the visit's first step was enqueued
        history["h2d"] = [{"ms": copy_ms(start, done), "ready": ready}
                          for start, done, ready in copies]
    p_full, o_full = full_state()
    return {"params": p_full, "opt_state": o_full, "history": history,
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
