"""Quickstart through the PyTorch port: the unified Forecaster API on
synthetic M4-quarterly data.

The Torch version of ``examples/quickstart.py``: one estimator, five verbs
-- fit / predict / predict_quantiles / evaluate / save -- over the paper's
vectorized ES-RNN, on the card unless told otherwise:

    PYTHONPATH=src python examples/quickstart_torch.py                 # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu    # on the CPU
    PYTHONPATH=src python examples/quickstart_torch.py --steps 10      # a shorter fit

The same surface drives the CLI (`python -m repro_torch.launch.forecast ...`).
"""

import argparse

from repro_torch.forecast import ESRNNForecaster


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    # one registry name resolves model + data + two-group training recipe
    f = ESRNNForecaster("esrnn-quarterly", device=args.device, n_steps=args.steps,
                        batch_size=64, rnn_lr=4e-3, hw_lr=4e-2, data_scale=0.005)
    f.fit()  # spec-driven synthetic M4 (Tables 2/3 profile)

    losses = f.history_["loss"]
    print(f"{f.n_series_} series, horizon {f.horizon}; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    # point + quantile forecasts from the end of the training window
    fc = f.predict()
    bands = f.predict_quantiles(taus=(0.1, 0.5, 0.9))
    print("first series forecast:", [f"{v:.1f}" for v in fc[0][:4]])
    print("80% band (h=1):",
          f"[{bands[0.1][0, 0]:.1f}, {bands[0.9][0, 0]:.1f}]")

    # M4-style scoring against the competition benchmarks
    scores = f.evaluate(split="val")
    print(f"val sMAPE  ES-RNN: {scores['smape']:.3f}   "
          f"comb: {scores['smape_comb']:.3f}   "
          f"naive2: {scores['smape_naive2']:.3f}   OWA: {scores['owa']:.3f}")


if __name__ == "__main__":
    main()
