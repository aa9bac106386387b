"""LM training launcher: synthetic tokens, fp32 masters, checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --smoke \\
        --device cpu --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 4 --batch 8 --seq 2048 --microbatch 2

The port of the JAX package's ``launch/train.py``. The token stream is
synthetic and stateless (:func:`synthetic_batch`: step -> batch from
``np.random.SeedSequence([seed, step])``, the reference's bits). Weights are
random, from a ``torch.Generator`` seeded with ``seed`` on the training
device, and kept as fp32 masters; each step runs
:func:`repro_torch.launch.steps.make_train_step` (bf16 compute casts,
gradient accumulation over ``batch // microbatch`` microbatches, AdamW with
``clip_norm=1.0``). A checkpoint (the reference's on-disk layout:
:class:`repro_torch.checkpoint.checkpointer.Checkpointer`) is written every
50 steps and at the end, and a run resumes from the directory's latest; a
step over 3x the running mean after step 5 is logged as a straggler; SIGTERM
or SIGINT checkpoints and stops (``PreemptionHandler``). On the card every
attention of a train step needs a gradient and takes the plain path
(:func:`repro_torch.models.attention.grad_route_calls` counts them), so K6
is not launched. Runs on the card unless ``--device cpu``.

``--model-parallel N`` (``train(model_parallel=N)``) trains sharded
(:func:`train_on_mesh`): FSDP on ``data``, tensor and expert parallelism on
``model`` (:mod:`repro_torch.sharding.fsdp`), inside an initialized process
group on ``make_host_mesh(N)`` over every rank, else on ``N`` ranks it
starts itself. The losses are the one-device step's within the rounding of
partial sums; a checkpoint from any mesh resumes on any other, or on one
device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --device cpu --steps 4 --batch 4 --seq 16 --model-parallel 2
"""

from __future__ import annotations

import argparse
import functools
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ShapeCell, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import ctx, fsdp
from repro_torch.sharding.ranks import run_ranks
from repro_torch.train.optimizer import AdamConfig, adam_init
from repro_torch.train.trainer import PreemptionHandler

log = logging.getLogger("repro_torch.launch.train")

CKPT_EVERY = 50
STRAGGLER_FACTOR, STRAGGLER_AFTER = 3.0, 5


def synthetic_batch(cfg, cell, step, seed=0, device=None):
    """The batch of ``step``: zipf(1.3) tokens clipped to the vocabulary,
    the labels the tokens shifted by one; a vlm's ``image_embeds`` and an
    encdec model's ``frames`` bf16 from float64 normals (rounded through
    float32, as ``jnp.asarray(..., jnp.bfloat16)`` does). The reference's
    bits, on ``device`` (default the CPU)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    b, s = cell.global_batch, cell.seq_len
    s_text = s - (cfg.n_patches if cfg.family == "vlm" else 0)
    # zipf-ish marginals make the CE landscape non-trivial
    toks = rng.zipf(1.3, (b, s_text + 1)).clip(max=cfg.vocab_size - 1).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    for family, key, n in (("vlm", "image_embeds", cfg.n_patches),
                           ("encdec", "frames", cfg.n_frames)):
        if cfg.family == family:
            batch[key] = torch.from_numpy(
                rng.normal(0, 1, (b, n, cfg.d_model))).to(torch.bfloat16)
    return {k: v.to(device) for k, v in batch.items()} if device is not None else batch


def train(arch: str, *, smoke: bool, steps: int, batch: int, seq: int,
          lr: float = 3e-4, microbatch=None, ckpt_dir=None, seed=0,
          model_parallel: int = 1, log_every: int = 10, device=None):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint). Returns ``{"losses": [...], "params": ...,
    "step_s": [...]}``: the losses of the steps this call ran, the fp32
    masters, and each step's seconds (host clock, the step's loss read
    back, so the device has finished it).

    Inside an initialized process group every rank calls it and trains on
    :func:`~repro_torch.launch.mesh.make_host_mesh` (``model_parallel``)
    over the world (:func:`train_on_mesh`); without one, ``model_parallel >
    1`` starts that many ranks (:func:`repro_torch.sharding.run_ranks`:
    NCCL where each has a card, else gloo) on a ``(1, model_parallel)`` mesh
    and returns rank 0's result, ``params`` gathered to one device's layout.
    A layout the plan cannot cut makes every rank raise, and the call: it
    does not fall back to one rank."""
    dev = resolve_device(device)
    kw = dict(arch=arch, smoke=smoke, steps=steps, batch=batch, seq=seq, lr=lr,
              microbatch=microbatch, ckpt_dir=ckpt_dir, seed=seed, log_every=log_every)
    if dist.is_available() and dist.is_initialized():
        mesh = make_host_mesh(model_parallel, device=None if dev.type == "cuda" else dev)
        log.info("training %s on %s", arch, mesh)
        return train_on_mesh(mesh, **kw)
    if model_parallel != 1:
        out = run_ranks(_train_rank, model_parallel, device=dev, args=(kw,),
                        mesh_factory=functools.partial(make_host_mesh, model_parallel))[0]
        log.info("trained %s on a (%d, %d) mesh, backend %s", arch, out["mesh"]["data"],
                 out["mesh"]["model"], out["mesh"]["backend"])
        out["params"] = fsdp.tree_map(torch.from_numpy, out["params"])
        return out
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cell = ShapeCell("custom", "train", seq, batch, microbatch=microbatch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    params = fp32_masters(params)
    opt_state = adam_init(params)
    step_fn = S.make_train_step(model, cell, adam=AdamConfig(lr=lr, clip_norm=1.0))

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start, (params, opt_state) = ckpt.restore((params, opt_state))
        log.info("resumed from step %d", start)

    def save(step, metric=None):
        ckpt.save(step, (params, opt_state), metric=metric)

    def run(step):
        nonlocal params, opt_state
        b = synthetic_batch(cfg, cell, step, seed, dev)
        params, opt_state, loss = step_fn(params, opt_state, b)
        return float(loss)

    losses, step_s = _loop(run, start, steps, log_every, save if ckpt else None,
                           lambda requested: requested)
    return {"losses": losses, "params": params, "step_s": step_s}


def _loop(run, start, steps, log_every, save, stop, logs=True):
    """The launcher's loop: ``run(step) -> loss`` from ``start`` to
    ``steps``, the straggler watchdog and the log (``logs``), a checkpoint
    (``save(step, metric)``) every ``CKPT_EVERY`` steps, on preemption and
    at the end; ``stop(requested)`` says whether a SIGTERM or SIGINT seen by
    this process (``requested``) stops the run after this step. Returns the
    losses and each step's seconds."""
    pre = PreemptionHandler()
    pre.install()
    losses, step_s, ewma = [], [], None
    try:
        for step in range(start, steps):
            t0 = time.perf_counter()
            loss = run(step)
            losses.append(loss)
            dt = time.perf_counter() - t0
            step_s.append(dt)
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if logs and step > STRAGGLER_AFTER and dt > STRAGGLER_FACTOR * ewma:
                log.warning("straggler step %d: %.2fs (ewma %.2fs)", step, dt, ewma)
            if logs and (step + 1) % log_every == 0:
                log.info("step %d loss %.4f (%.2fs/step)", step + 1, loss, ewma)
            if save and (step + 1) % CKPT_EVERY == 0:
                save(step + 1, loss)
            if stop(pre.requested):
                if save:
                    save(step + 1)
                if logs:
                    log.warning("preempted; checkpointed at %d", step + 1)
                break
    finally:
        pre.uninstall()
    if save:
        save(steps, losses[-1] if losses else None)
    return losses, step_s


def train_on_mesh(mesh, arch: str, *, smoke: bool, steps: int, batch: int, seq: int,
                  lr: float = 3e-4, microbatch=None, ckpt_dir=None, seed=0, log_every: int = 10,
                  gather_params: bool = True):
    """One rank's part of :func:`train` on a host ``mesh``: the whole model
    drawn from the seed on the rank's device as fp32 masters (or restored
    from ``ckpt_dir``'s latest checkpoint, the reference's whole-leaf
    layout, whatever mesh wrote it), cut to the rank's shards by the
    training plan (:mod:`repro_torch.sharding.fsdp`), with Adam's state;
    then the sharded step (:func:`repro_torch.launch.steps.make_train_step`
    under the mesh's context) on each step's global batch, the reference's
    bits, of which the rank takes its rows. Rank 0 logs (the straggler
    warning too); a SIGTERM or SIGINT seen by any rank stops every rank
    after the same step (one all-reduce of the flags on each axis a step).
    A checkpoint gathers every leaf (rank 0 writes, the others wait). Returns
    the losses, each step's seconds, the mesh, the rank's collectives by
    (axis, op) over the steps, its bytes of masters and Adam state, and
    with ``gather_params`` the masters gathered to one device's layout."""
    dev = mesh.device
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cell = ShapeCell("custom", "train", seq, batch, microbatch=microbatch)
    model = build_model(cfg)
    with ctx.activation_sharding(mesh, dp="data", tp="model"):
        step_fn = S.make_train_step(model, cell, adam=AdamConfig(lr=lr, clip_norm=1.0))
    plan = step_fn.plan
    full = fp32_masters(model.init(torch.Generator(device=dev).manual_seed(seed)))
    ckpt = Checkpointer(ckpt_dir, mesh=mesh) if ckpt_dir else None
    start, opt_full = 0, None
    if ckpt and ckpt.latest_step() is not None:
        start, (full, opt_full) = ckpt.restore((full, adam_init(full)))
        if mesh.rank == 0:
            log.info("resumed from step %d", start)
    masters = plan.shard(full)
    if opt_full is None:
        opt_state = adam_init(masters)
    else:
        opt_state = dict(opt_full, mu=plan.shard_list(opt_full["mu"]),
                         nu=plan.shard_list(opt_full["nu"]))
    del full, opt_full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    state_bytes = plan.local_bytes(masters) + sum(
        t.numel() * t.element_size() for t in opt_state["mu"] + opt_state["nu"])

    def save(step, metric=None):
        whole = (plan.gather(masters), dict(opt_state, mu=plan.gather_list(opt_state["mu"]),
                                            nu=plan.gather_list(opt_state["nu"])))
        ckpt.save(step, whole, metric=metric)

    def run(step):
        nonlocal masters, opt_state
        b = synthetic_batch(cfg, cell, step, seed, dev)
        masters, opt_state, loss = step_fn(masters, opt_state, b)
        return float(loss)

    def stop(requested):
        flag = torch.tensor([float(requested)], device=dev)
        for name in ("model", "data"):
            if mesh.shape[name] > 1:
                mesh.axis(name).all_reduce(flag)
        return bool(flag.item())

    mesh.reset_counts()
    losses, step_s = _loop(run, start, steps, log_every, save if ckpt else None, stop,
                           logs=mesh.rank == 0)
    out = {"losses": losses, "step_s": step_s, "mesh": dict(mesh.shape, backend=mesh.backend),
           "collectives": mesh.collective_counts(), "state_bytes": state_bytes,
           "params": plan.gather(masters) if gather_params else None}
    if mesh.rank and gather_params:
        out["params"] = None
    return out


def _train_rank(mesh, kw):
    """A spawned rank of :func:`train` (``run_ranks``'s target); the params
    come back as numpy (a tensor shared with the parent would outlive its
    process)."""
    out = train_on_mesh(mesh, **kw)
    if out["params"] is not None:
        out["params"] = fsdp.tree_map(lambda t: t.cpu().numpy(), out["params"])
    return out


def fp32_masters(params):
    """bf16 leaves as fp32 masters; other leaves as they are."""
    if isinstance(params, dict):
        return {k: fp32_masters(v) for k, v in params.items()}
    if isinstance(params, list):
        return [fp32_masters(v) for v in params]
    return params.float() if params.dtype == torch.bfloat16 else params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatch", type=int)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, microbatch=args.microbatch,
                lr=args.lr, ckpt_dir=args.ckpt_dir,
                model_parallel=args.model_parallel, device=args.device)
    if out["losses"]:
        print(f"first loss {out['losses'][0]:.4f} -> last {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
