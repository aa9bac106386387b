"""The hybrid ES-RNN model (paper section 3, Eqs. 5-6): the port's public API.

PyTorch counterpart of ``repro.core.esrnn``, the forecast side:

  ``esrnn_init(generator, cfg, n_series, device=...)`` -> params
  ``esrnn_forecast(cfg, params, y, cats)``         -> (N, H) forecast
  ``esrnn_forecast_at(cfg, params, y, cats, origins)`` -> (N, K, H)
  ``esrnn_predict_stats(cfg, params, y, cats)``    -> (forecast, sigma)

``params`` is ``{"hw": HWParams, "rnn": ..., "head": ...(, "attn": ...)}``:
the per-series table as a dataclass of tensors and the shared weights as
``nn.Module``s, with the JAX package's keys and orientation. Everything runs
on the device of the tensors it is given; on the card the HW scan and the
LSTM cell are the CUDA kernels K1 and K3. The forecast entry points run
under ``torch.no_grad()``: this slice serves, training comes later.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import forward as F
from repro_torch.core import heads as H
from repro_torch.core.holt_winters import hw_init_params
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ESRNNConfig:
    """Frequency-specific ES-RNN hyperparameters (paper Tables 1 and text).

    Field for field the JAX package's config, so one config describes both.
    ``use_pallas`` is kept for that reason only: the port dispatches by
    device (a tensor on the card runs the CUDA kernels, a CPU tensor their
    plain versions), never by this flag.
    """

    name: str = "quarterly"
    seasonality: int = 4
    seasonality2: int = 0          # section 8.2 (e.g. hourly: 24 and 168)
    input_size: int = 8            # input window W (heuristic, section 3.1)
    output_size: int = 8           # forecast horizon H
    hidden_size: int = 40          # Table 1
    dilations: Tuple[Tuple[int, ...], ...] = ((1, 2), (4, 8))  # Table 1
    n_categories: int = 6          # M4: Demographic..Other, one-hot appended
    tau: float = 0.49              # pinball quantile
    level_penalty: float = 0.0     # section 8.4
    cstate_penalty: float = 0.0    # section 8.4
    attention: bool = False        # causal dot-product attention over the
                                   # LSTM hidden sequence (section 7/8.5)
    use_pallas: bool = False       # JAX-only switch; ignored by the port
    head: str = "lstm"             # repro_torch.core.heads registry name
    dtype: str = "float32"
    precision: str = "fp32"        # "fp32" only in this slice of the port

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        """Dtype activations and shared weights compute in."""
        if self.precision == "fp32":
            return self.tdtype
        if self.precision == "bf16":
            raise NotImplementedError(
                "the bf16 policy is not ported yet; use precision='fp32'")
        raise ValueError(
            f"unknown precision policy {self.precision!r} (want fp32|bf16)")


# Table 1 presets + the monthly/yearly rows.
PRESETS = {
    "yearly": dict(seasonality=1, input_size=4, output_size=6, hidden_size=30,
                   dilations=((1, 2), (2, 6))),
    "quarterly": dict(seasonality=4, input_size=8, output_size=8, hidden_size=40,
                      dilations=((1, 2), (4, 8))),
    "monthly": dict(seasonality=12, input_size=12, output_size=18, hidden_size=50,
                    dilations=((1, 3), (6, 12))),
    "hourly": dict(seasonality=24, seasonality2=168, input_size=24,
                   output_size=48, hidden_size=40, dilations=((1, 4), (24, 168))),
}


def make_config(name: str, **overrides) -> ESRNNConfig:
    base = dict(PRESETS[name], name=name)
    base.update(overrides)
    return ESRNNConfig(**base)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def esrnn_init(generator: torch.Generator, cfg: ESRNNConfig, n_series: int,
               *, device=None):
    """Initialize the params: ``{"hw": HWParams, <head subtrees>}``.

    The ``hw`` table is the section-3.3 primer (constant); the shared
    weights are drawn from ``generator``. ``device`` defaults to the card.
    """
    dev = resolve_device(device)
    hw = hw_init_params(n_series, cfg.seasonality,
                        seasonality2=cfg.seasonality2, dtype=cfg.tdtype,
                        device=dev)
    return {"hw": hw, **H.get_head(cfg.head).init(cfg, generator, dev)}


# ---------------------------------------------------------------------------
# Forecast entry points (all read the one forward pass)
# ---------------------------------------------------------------------------


@torch.no_grad()
def esrnn_forecast(cfg: ESRNNConfig, params, y, cats):
    """h-step forecast from the end of y: (N, H), de-normalized (3.4)."""
    states = F.esrnn_states(cfg, params, y, cats)
    return F.forecast_from_states(cfg, states, y.shape[1])


@torch.no_grad()
def esrnn_forecast_at(cfg: ESRNNConfig, params, y, cats,
                      origins: Tuple[int, ...]):
    """Rolling-origin forecasts (the backtest workhorse): (N, K, H).

    The k-th forecast equals ``esrnn_forecast(cfg, params, y[:, :o], cats)``
    for ``o = origins[k]``, all from one forward pass.
    """
    states = F.esrnn_states(cfg, params, y, cats)
    return F.forecast_at_origins(cfg, states, tuple(origins), y.shape[1])


@torch.no_grad()
def esrnn_predict_stats(cfg: ESRNNConfig, params, y, cats):
    """Point forecast + per-series quantile sigma off one forward pass.

    Returns ``(fc (N, H), sigma (N, 1))``.
    """
    states = F.esrnn_states(cfg, params, y, cats)
    return (F.forecast_from_states(cfg, states, y.shape[1]),
            F.quantile_sigma(states, y))


def gather_series(params, idx):
    """Per-series row gather: hw rows at ``idx``, shared weights untouched."""
    return {k: (v.map(lambda a: a[idx]) if k == "hw" else v)
            for k, v in params.items()}
