"""Train a ~100M-parameter transformer through the PyTorch port's launcher.

The Torch version of ``examples/train_lm.py``: the same llama-style dense
config, trained by ``repro_torch.launch.train.train`` -- gradient
accumulation over microbatches, fp32 masters with bf16 compute, AdamW,
checkpointing, the straggler watchdog -- on the card unless told otherwise.

    PYTHONPATH=src python examples/train_lm_torch.py                  # on the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu     # on the CPU
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300      # full run
"""

import argparse
import logging
import time

from repro_torch.models.config import ArchConfig

# ~100M params: 2*32000*512 embed/head + 12 layers (attn 4*512^2 + swiglu
# 3*512*2048) -- llama-style dense.
LM_100M = ArchConfig(
    name="lm-100m", family="dense",
    n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048,
    vocab_size=32000, dtype="float32", remat=False,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)

    import repro_torch.launch.train as T

    # the launcher looks the config up by name: answer "lm-100m" with this one
    orig_get, orig_smoke = T.get_config, T.get_smoke_config
    T.get_config = lambda a: LM_100M if a == "lm-100m" else orig_get(a)
    T.get_smoke_config = lambda a: LM_100M if a == "lm-100m" else orig_smoke(a)

    print(f"params ~= {LM_100M.param_count()/1e6:.0f}M")
    t0 = time.perf_counter()
    out = T.train("lm-100m", smoke=False, steps=args.steps, batch=args.batch,
                  seq=args.seq, microbatch=max(args.batch // 4, 1),
                  lr=3e-4, ckpt_dir=args.ckpt_dir, device=args.device)
    losses = out["losses"]
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps "
          f"in {time.perf_counter() - t0:.1f} s")
    assert losses[-1] < losses[0], "loss should decrease"


if __name__ == "__main__":
    main()
