"""End-to-end M4 forecasting driver through the PyTorch port (the paper's
full workflow).

The Torch version of ``examples/forecast_m4.py``. Per frequency: fit with
checkpoint/restart (kill it any time and run again -- it resumes from the
latest checkpoint), then report test sMAPE/MASE/OWA against the Comb and
Naive2 benchmarks, on the card unless told otherwise:

    PYTHONPATH=src python examples/forecast_m4_torch.py [--freq quarterly] [--steps 150]
    PYTHONPATH=src python examples/forecast_m4_torch.py --device cpu --steps 25

Checkpoints go under ``--ckpt-root`` (default: ``esrnn_torch_ckpts`` in the
temporary directory).
"""

import argparse
import os
import tempfile

from repro_torch.forecast import ESRNNForecaster


def run_frequency(freq: str, steps: int, ckpt_root: str, device=None):
    print(f"\n=== {freq} ===")
    f = ESRNNForecaster(f"esrnn-{freq}", device=device, n_steps=steps, batch_size=64,
                        rnn_lr=4e-3, hw_lr=4e-2, data_scale=0.004,
                        eval_every=max(steps // 5, 1))
    f.fit(ckpt_dir=os.path.join(ckpt_root, freq))
    if not f.history_["loss"]:
        print("(resumed from a finished checkpoint)")

    scores = f.evaluate(split="test")  # forecast from train+val, score on test
    print(f"test sMAPE: esrnn {scores['smape']:.3f} | "
          f"comb {scores['smape_comb']:.3f} | "
          f"naive2 {scores['smape_naive2']:.3f}")
    print(f"test OWA:   esrnn {scores['owa']:.3f} | comb {scores['owa_comb']:.3f}")
    return scores["smape"], scores["smape_comb"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--freq", default="all",
                    choices=["all", "yearly", "quarterly", "monthly"])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--ckpt-root", default=os.path.join(tempfile.gettempdir(),
                                                        "esrnn_torch_ckpts"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    freqs = ["yearly", "quarterly", "monthly"] if args.freq == "all" else [args.freq]
    results = {f: run_frequency(f, args.steps, args.ckpt_root, args.device) for f in freqs}
    print("\nsummary (test sMAPE, esrnn vs comb):")
    for f, (es, cb) in results.items():
        marker = "BEATS" if es < cb else "trails"
        print(f"  {f:10s} {es:7.3f} vs {cb:7.3f}  ({marker} Comb)")


if __name__ == "__main__":
    main()
