"""Serving launcher: batched prefill + greedy decode with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
        --device cpu --batch 2 --prompt-len 8 --gen 4

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
        --batch 8 --prompt-len 2048 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
        --batch 8 --prompt-len 2048 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --batch 8 --prompt-len 2048 --gen 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
        --batch 8 --prompt-len 2048 --gen 32

The port of the JAX package's ``launch/serve.py``, for every family: dense
and MoE (GQA or MLA), vlm, ssm (mamba2), hybrid (zamba2) and encdec
(whisper). Weights are random, from a ``torch.Generator`` seeded with
``seed`` on the serving device; prompts come from
``np.random.default_rng(seed)`` as in the reference, and a vlm's image
embeddings (B, n_patches, d_model) or an encdec model's frames (B,
n_frames, d_model) from the same generator after them, so one seed gives
the reference's inputs; a vlm's cache grows by the patches and its decode
positions start after them. The first token comes from the prefill, then
``gen - 1`` greedy decode steps. On the card the prefill runs K6 once per
attention layer (a MoE model's expert products, dispatch and router are
PyTorch calls, as in the reference; under MLA at q . k 192 and v 128 for
deepseek-v2-lite), once per application of a hybrid's shared block
(zamba2-2.7b: D = DV = 80), once per encoder layer and twice per decoder
layer of an encdec model (self and cross; whisper-base: 18) and never in an
ssm model, whose SSD is PyTorch calls as in the reference. Decode runs K6
only in an encdec model's cross-attention, once per decoder layer and step
(whisper-base: 6, at Tq = 1 over the 1,500 frames); every other family's
decode runs no kernel of the port (MLA's absorbed decode is plain einsums
in the latent space). Runs on the card unless ``--device cpu``; one device
only.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.model import Model, build_model


def _launches_between(before, after):
    return {name: after[name] - before[name] for name in after}


def generate(model: Model, params, prompts: torch.Tensor, gen: int, image_embeds=None,
             frames=None):
    """Prefill ``prompts`` (B, P) and decode ``gen - 1`` more tokens greedily.

    ``image_embeds`` (B, n_patches, d_model), a vlm's, go in front of the
    prompt: the cache holds them too and the decode positions start at
    ``P + n_patches``. ``frames`` (B, n_frames, d_model), an encdec
    model's, go to its encoder. Returns ``generated`` (B, gen) int32, ``prefill_s`` and
    ``decode_s_per_tok`` (host clock around work that ends in a device
    synchronize), ``kernel_launches`` of the prefill and of all decode steps,
    and ``logits_finite`` (every step's logits).
    """
    batch, prompt_len = prompts.shape
    dev = prompts.device
    batch_in = {"tokens": prompts}
    offset = 0
    if image_embeds is not None:
        batch_in["image_embeds"] = image_embeds
        offset = image_embeds.shape[1]
    if frames is not None:
        batch_in["frames"] = frames

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        before = kernel_ops.launch_counts()
        sync()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, batch_in, prompt_len + offset + gen)
        sync()
        t_prefill = time.perf_counter() - t0
        after_prefill = kernel_ops.launch_counts()

        finite = torch.isfinite(logits).all()
        tokens = [logits[:, -1, :].argmax(dim=-1)]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            pos = torch.full((batch, 1), prompt_len + offset + i, dtype=torch.int64,
                             device=dev)
            logits, caches = model.decode(
                params, {"tokens": tokens[-1][:, None], "positions": pos}, caches)
            finite &= torch.isfinite(logits).all()
            tokens.append(logits[:, -1, :].argmax(dim=-1))
        sync()
        t_decode = time.perf_counter() - t0
        after = kernel_ops.launch_counts()

    return {
        "generated": torch.stack(tokens, dim=1).to(torch.int32).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s_per_tok": t_decode / max(gen - 1, 1),
        "kernel_launches": {"prefill": _launches_between(before, after_prefill),
                            "decode": _launches_between(after_prefill, after)},
        "logits_finite": bool(finite),
    }


def draw_inputs(cfg, batch: int, prompt_len: int, seed: int, device=None):
    """The prompts (B, P) int64 from ``np.random.default_rng(seed)`` and the
    model's other inputs, as ``generate``'s keyword arguments: a vlm's image
    embeddings (B, n_patches, d_model) or an encdec model's frames (B,
    n_frames, d_model), in the config's dtype, drawn after the prompts from
    the same generator (else none), on ``device``: one seed gives the
    reference's inputs."""
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len)))
    extra = {}
    for family, key, n in (("vlm", "image_embeds", cfg.n_patches),
                           ("encdec", "frames", cfg.n_frames)):
        if cfg.family == family:
            extra[key] = torch.from_numpy(
                rng.normal(0, 1, (batch, n, cfg.d_model))).to(device, cfg.tdtype)
    return prompts.to(device), extra


def serve(arch: str, *, smoke: bool, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device=None, model_parallel: int = 1):
    if model_parallel != 1:
        raise NotImplementedError(
            "model_parallel > 1: sharded LM serving comes with the rest of the "
            "LM stack (ROADMAP.md, section 1, item 7)")
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    prompts, extra = draw_inputs(cfg, batch, prompt_len, seed, dev)
    return generate(model, params, prompts, gen, **extra)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--model-parallel", type=int, default=1)
    args = ap.parse_args()
    out = serve(args.arch, smoke=args.smoke, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen, device=args.device,
                model_parallel=args.model_parallel)
    print(f"prefill {out['prefill_s']*1e3:.1f} ms; "
          f"decode {out['decode_s_per_tok']*1e3:.2f} ms/token")
    print("sample:", out["generated"][0][:16])


if __name__ == "__main__":
    main()
