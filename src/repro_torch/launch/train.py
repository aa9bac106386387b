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
is not launched. Runs on the card unless ``--device cpu``; one device only.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ShapeCell, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models.model import build_model
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
    back, so the device has finished it)."""
    if model_parallel != 1:
        raise NotImplementedError(
            "model_parallel > 1: sharded LM training (FSDP on data, TP on model) is the "
            "last part of ROADMAP.md, section 1, item 7; serving runs tensor-parallel "
            "(repro_torch.launch.serve.serve(model_parallel=N))")
    dev = resolve_device(device)
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

    pre = PreemptionHandler()
    pre.install()
    losses, step_s, ewma = [], [], None
    try:
        for step in range(start, steps):
            t0 = time.perf_counter()
            b = synthetic_batch(cfg, cell, step, seed, dev)
            params, opt_state, loss = step_fn(params, opt_state, b)
            loss = float(loss)
            losses.append(loss)
            dt = time.perf_counter() - t0
            step_s.append(dt)
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if step > STRAGGLER_AFTER and dt > STRAGGLER_FACTOR * ewma:
                log.warning("straggler step %d: %.2fs (ewma %.2fs)", step, dt, ewma)
            if (step + 1) % log_every == 0:
                log.info("step %d loss %.4f (%.2fs/step)", step + 1, loss, ewma)
            if ckpt and (step + 1) % CKPT_EVERY == 0:
                ckpt.save(step + 1, (params, opt_state), metric=loss)
            if pre.requested:
                if ckpt:
                    ckpt.save(step + 1, (params, opt_state))
                log.warning("preempted; checkpointed at %d", step + 1)
                break
    finally:
        pre.uninstall()
    if ckpt:
        ckpt.save(steps, (params, opt_state), metric=losses[-1] if losses else None)
    return {"losses": losses, "params": params, "step_s": step_s}


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
