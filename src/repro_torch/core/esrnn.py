"""The hybrid ES-RNN model (paper section 3, Eqs. 5-6): the port's public API.

PyTorch counterpart of ``repro.core.esrnn``:

  ``esrnn_init(generator, cfg, n_series, device=...)`` -> params
  ``esrnn_loss(cfg, params, y, cats, mask=None)``  -> scalar training loss
  ``esrnn_loss_and_grad(cfg, params, y, cats)``    -> (loss, grads)
  ``esrnn_forecast(cfg, params, y, cats)``         -> (N, H) forecast
  ``esrnn_forecast_at(cfg, params, y, cats, origins)`` -> (N, K, H)
  ``esrnn_predict_stats(cfg, params, y, cats)``    -> (forecast, sigma)

``params`` is ``{"hw": HWParams, "rnn": ..., "head": ...(, "attn": ...)}``:
the per-series table as a dataclass of tensors and the shared weights as
``nn.Module``s, with the JAX package's keys and orientation. Everything runs
on the device of the tensors it is given. On the card the forecast entry
points (under ``torch.no_grad()``) run the CUDA kernels K1 and K3; the loss,
differentiated, runs K1 + K2 for the HW scan and K4 + K5 for every LSTM
cell step. The per-series table and the shared weights are trained jointly
(``repro_torch.train``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch import nn

from repro_torch.core import forward as F
from repro_torch.core import heads as H
from repro_torch.core.holt_winters import HWParams, hw_init_params
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
    precision: str = "fp32"        # compute policy: "fp32" | "bf16". Master
                                   # params, the per-series HW table, levels
                                   # and seasonality stay in ``dtype``; "bf16"
                                   # streams y into the HW scan, and the
                                   # features, the recurrent stack and the
                                   # readout's hidden activations, in bf16
                                   # with fp32 accumulation, in serving,
                                   # training and the fine-tune alike.

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        """Dtype activations and shared weights are cast to in the forward."""
        if self.precision == "bf16":
            return torch.bfloat16
        if self.precision == "fp32":
            return self.tdtype
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


def _module_leaves(prefix: Tuple, mod: nn.Module) -> List[Tuple[Tuple, torch.Tensor]]:
    if isinstance(mod, nn.ModuleList):
        return [leaf for i, sub in enumerate(mod)
                for leaf in _module_leaves(prefix + (i,), sub)]
    return [(prefix + (name,), p)
            for name, p in sorted(mod.named_parameters(recurse=False))]


def _nest_leaves(prefix: Tuple, value) -> List[Tuple[Tuple, torch.Tensor]]:
    if isinstance(value, torch.Tensor):
        return [(prefix, value)]
    if isinstance(value, dict):
        return [leaf for k in sorted(value) for leaf in _nest_leaves(prefix + (k,), value[k])]
    if isinstance(value, (list, tuple)):
        return [leaf for i, v in enumerate(value) for leaf in _nest_leaves(prefix + (i,), v)]
    raise TypeError(f"not a params node at {prefix}: {type(value).__name__}")


def param_leaves(params) -> List[Tuple[Tuple, torch.Tensor]]:
    """``[(path, tensor), ...]`` in the JAX tree's flatten order.

    Sorted top-level keys, ``HWParams`` fields in declaration order (``None``
    fields are not leaves), module parameters by name; a nest of dicts and
    lists of tensors (the LM's params) by sorted keys, then list order. Paths read like the
    JAX tree paths: ``("hw", "alpha_logit")``, ``("rnn", 0, 1, "wx")``,
    ``("head", "out_w")``, ``("layers", 3, "attn", "wq")``. Gradients,
    optimizer moments and converted parameters line up with the reference
    leaf for leaf in this order (an LM's per-layer leaves with its stacked
    ones through :mod:`repro_torch.convert`).
    """
    out: List[Tuple[Tuple, torch.Tensor]] = []
    for key in sorted(params):
        value = params[key]
        if isinstance(value, HWParams):
            out += [((key, f.name), getattr(value, f.name))
                    for f in dataclasses.fields(value)
                    if getattr(value, f.name) is not None]
        elif isinstance(value, nn.Module):
            out += _module_leaves((key,), value)
        else:
            out += _nest_leaves((key,), value)
    return out


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
    """Per-series row gather: hw rows at ``idx``, shared weights untouched.

    Differentiated, the gather scatters the gradient back over the full
    (N, ...) table; the training steps take per-row gradients through
    :func:`partition_series` instead.
    """
    return {k: (v.map(lambda a: a[idx]) if k == "hw" else v)
            for k, v in params.items()}


def partition_series(params, idx):
    """Split params into (gathered per-series rows, shared weights).

    ``hw_rows`` holds the rows at ``idx`` as new leaf tensors (B, ...) that
    require a gradient, so differentiating a loss with respect to them gives
    per-row gradients with no zero-padded scatter over the table -- what
    the sparse segment optimizer consumes. ``shared`` is everything else.
    """
    hw_rows = params["hw"].map(lambda a: a[idx].detach().requires_grad_(True))
    shared = {k: v for k, v in params.items() if k != "hw"}
    return hw_rows, shared


def combine_series(hw_rows, shared):
    """Inverse of :func:`partition_series` (batch-rows params tree)."""
    return {"hw": hw_rows, **shared}


# ---------------------------------------------------------------------------
# The training loss (the same forward pass, scored)
# ---------------------------------------------------------------------------


def esrnn_loss_terms_fn(cfg: ESRNNConfig, params, y, cats, mask=None):
    """Per-batch loss terms ``(pinball_sum, valid_count, penalties)``.

    One :func:`repro_torch.core.forward.esrnn_states` pass scored by
    :func:`repro_torch.core.forward.loss_terms`; the decomposed form lets a
    masked mean be reduced exactly across shards (divide once).
    """
    states = F.esrnn_states(cfg, params, y, cats)
    return F.loss_terms(cfg, states, y, mask)


def esrnn_loss_fn(cfg: ESRNNConfig, params, y, cats, mask=None):
    """Training loss on series y (N, T) with category one-hots (N, C):
    masked mean pin-ball plus the section-8.4 terms.

    ``mask`` (N, T), optional: 1 where y is a real observation, 0 on the
    left-padding of variable-length series; windows that overlap padding
    are excluded. ``None`` is the same as an all-ones mask.
    """
    pin_sum, pin_cnt, penalties = esrnn_loss_terms_fn(cfg, params, y, cats, mask)
    return pin_sum / torch.clamp_min(pin_cnt, 1.0) + penalties


# the JAX package's jitted entry point; PyTorch runs eagerly, so it is the same
esrnn_loss = esrnn_loss_fn


def esrnn_loss_loop_reference(cfg: ESRNNConfig, params, y, cats) -> torch.Tensor:
    """The same loss one series at a time (a batch of 1 each), then the mean.

    The per-series loop of Smyl's original C++ that the paper vectorized
    away: the slow baseline of the Table-5 speedup benchmark.
    """
    losses = [esrnn_loss_fn(cfg, gather_series(params, slice(i, i + 1)), y[i:i + 1],
                            cats[i:i + 1])
              for i in range(y.shape[0])]
    return torch.stack(losses).mean()


def value_and_grad(loss_fn, leaves: List[torch.Tensor]):
    """``(loss, grads)`` of ``loss_fn()`` with respect to ``leaves``, tensors
    that require a gradient. A leaf the loss does not reach (the seasonality
    of an m == 1 model) gets zeros, as in JAX."""
    with torch.enable_grad():
        loss = loss_fn()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def esrnn_loss_and_grad(cfg: ESRNNConfig, params, y, cats, mask=None):
    """``(loss, grads)``: ``grads[i]`` is the gradient of the loss with
    respect to ``param_leaves(params)[i]`` (:func:`param_leaves`, the JAX
    tree's leaf order). Every leaf must be a tensor that requires a
    gradient."""
    return value_and_grad(lambda: esrnn_loss_fn(cfg, params, y, cats, mask),
                          [t for _, t in param_leaves(params)])
