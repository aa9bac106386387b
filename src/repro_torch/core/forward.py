"""The ES-RNN state-space forward core (PyTorch port of ``repro.core.forward``).

One pass computes everything the model derives from a batch of series --
Holt-Winters levels/seasonality, the normalized input windows (Eq. 6) and
the head outputs at every valid window position -- as an
:class:`ESRNNStates`. The forecast reads the last position
(:func:`forecast_from_states`); because the whole recurrence is causal,
:func:`forecast_at_origins` reads the forecast from any earlier origin of
the same pass (rolling-origin backtesting without a re-run).

The same pass feeds the training loss: :func:`target_windows` builds the
normalized output windows and their validity mask, and :func:`loss_terms`
scores the head outputs against them (masked pin-ball sum and count, plus
the section-8.4 penalties).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import heads as H
from repro_torch.core import losses as L
from repro_torch.core.holt_winters import hw_smooth, hw_step

__all__ = [
    "ESRNNStates", "esrnn_states", "smooth", "hw_step", "window_positions",
    "future_seasonal_idx", "input_windows", "target_windows", "features",
    "rnn_head", "loss_terms", "forecast_from_states", "quantile_sigma",
    "forecast_at_origins",
]


@dataclasses.dataclass(frozen=True)
class ESRNNStates:
    """Everything one forward pass derives from a batch ``y`` (N, T).

    levels: (N, T)    HW level l_t after observing y_t
    seas:   (N, T+m)  multiplicative seasonality; [:, T:] are future factors
    pos:    (P,)      valid window positions t = W-1 .. T-1
    x_in:   (N, P, W) normalized/de-seasonalized/log input windows (Eq. 6)
    yhat_n: (N, P, H) head outputs (normalized log-space predictions)
    c_sq:   ()        mean squared LSTM cell state (section-8.4 penalty term)
    """

    levels: torch.Tensor
    seas: torch.Tensor
    pos: torch.Tensor
    x_in: torch.Tensor
    yhat_n: torch.Tensor
    c_sq: torch.Tensor


# ---------------------------------------------------------------------------
# The single smoothing / window / seasonal-extension implementation
# ---------------------------------------------------------------------------


def smooth(cfg, params, y):
    """HW smoothing of ``y`` (N, T) with the per-series table ``params["hw"]``.

    Under the bf16 policy y streams into the scan in bf16; the recurrence,
    the table and the returned levels and seasonality stay in the table's
    dtype (float32).
    """
    if y.dtype != cfg.compute_dtype:
        y = y.to(cfg.compute_dtype)
    return hw_smooth(y, params["hw"], seasonality=cfg.seasonality,
                     seasonality2=cfg.seasonality2)


def window_positions(cfg, t_len: int, device=None):
    """Valid window positions t = W-1 .. T-1 (input window fully observed)."""
    return torch.arange(cfg.input_size - 1, t_len, device=device)


def future_seasonal_idx(out_idx, t_len: int, m: int):
    """Seasonality indices for targets t+1..t+H, cyclically clamped.

    ``seas`` has ``t_len + m`` valid entries for ``t_len`` observations;
    indices beyond that wrap into the last smoothed season. One rule for the
    end-of-series forecast and every backtest origin.
    """
    return torch.where(out_idx < t_len + m, out_idx,
                       t_len + torch.remainder(out_idx - t_len, m))


def input_windows(cfg, y, levels, seas):
    """Normalized + de-seasonalized + log input windows (Eq. 6).

    Returns feats (N, P, W) and the position vector (P,).
    """
    w = cfg.input_size
    t_len = y.shape[1]
    pos = window_positions(cfg, t_len, y.device)                        # (P,)
    in_idx = pos[:, None] + torch.arange(-w + 1, 1, device=y.device)[None, :]
    y_in = y[:, in_idx]                                                 # (N, P, W)
    s_in = seas[:, in_idx]
    lvl = levels[:, pos]                                                # (N, P)
    x_in = torch.log(torch.clamp_min(y_in / (lvl[:, :, None] * s_in), 1e-8))
    return x_in, pos


def target_windows(cfg, y, levels, seas, pos):
    """Normalized output windows + the position-validity mask.

    Output windows need y up to t+H, so the last H positions have no
    complete target; ``out_mask`` (N, P, H) in {0,1} marks real targets.
    Clamped (out-of-range) entries are masked out of the loss.
    """
    n, t_len = y.shape
    h = cfg.output_size
    out_idx = pos[:, None] + torch.arange(1, h + 1, device=y.device)[None, :]   # (P, H)
    out_valid = out_idx < t_len
    out_idx_c = torch.clamp_max(out_idx, t_len - 1)
    lvl = levels[:, pos]                                                # (N, P)
    y_out = y[:, out_idx_c]                                             # (N, P, H)
    m = max(cfg.seasonality, 1)
    s_out = seas[:, future_seasonal_idx(out_idx, t_len, m)]
    y_out_n = torch.log(torch.clamp_min(y_out / (lvl[:, :, None] * s_out), 1e-8))
    out_mask = out_valid[None, :, :].to(y.dtype).expand(n, -1, -1)
    return y_out_n, out_mask


def features(x_in, cats):
    """Input windows + broadcast one-hot category features (N, P, W + C)."""
    n, p, _ = x_in.shape
    cat_feat = cats[:, None, :].expand(n, p, cats.shape[-1]).to(x_in.dtype)
    return torch.cat([x_in, cat_feat], dim=-1)


# ---------------------------------------------------------------------------
# The one forward pass
# ---------------------------------------------------------------------------


def esrnn_states(cfg, params, y, cats) -> ESRNNStates:
    """Run the full forward pass once: smoothing, windows, head.

    ``y`` (N, T) strictly positive, ``cats`` (N, C) one-hot, both on the
    device of ``params``; the kernels run wherever the tensors are. The head
    computes in the policy's dtype (bf16 halves the tensors it streams) and
    re-emits ``yhat_n`` in float32, so the loss and the forecasts' ``exp``
    never see bf16 rounding.
    """
    levels, seas = smooth(cfg, params, y)
    x_in, pos = input_windows(cfg, y, levels, seas)
    feats = features(x_in, cats)
    if feats.dtype != cfg.compute_dtype:
        feats = feats.to(cfg.compute_dtype)
    yhat_n, c_sq = H.get_head(cfg.head).apply(cfg, params, feats)
    return ESRNNStates(levels=levels, seas=seas, pos=pos, x_in=x_in,
                       yhat_n=yhat_n, c_sq=c_sq)


# ---------------------------------------------------------------------------
# Consumers: forecasts, rolling origins, quantile spread
# ---------------------------------------------------------------------------


def rnn_head(cfg, params, feats):
    """Dilated residual LSTM -> (attention) -> tanh dense -> linear head.

    The public name of the paper's head; the implementation is the ``lstm``
    entry of the head registry, :func:`repro_torch.core.heads.lstm_head_apply`.
    """
    return H.lstm_head_apply(cfg, params, feats)


def loss_terms(cfg, states: ESRNNStates, y, mask=None):
    """Decomposed training-loss terms ``(pinball_sum, valid_count, penalties)``.

    The target windows are scored against the head outputs of the pass;
    ``mask`` (N, T) excludes window positions whose input overlaps the
    left-padding of variable-length series.
    """
    y_out_n, out_mask = target_windows(cfg, y, states.levels, states.seas,
                                       states.pos)
    if mask is not None:
        valid_in = mask[:, states.pos - cfg.input_size + 1]           # (N, P)
        out_mask = out_mask * valid_in[:, :, None]
    pin_sum, pin_cnt = L.pinball_terms(states.yhat_n, y_out_n, tau=cfg.tau,
                                       mask=out_mask)
    penalties = (L.level_variability_penalty(states.levels, cfg.level_penalty)
                 + L.cstate_penalty(states.c_sq, cfg.cstate_penalty))
    return pin_sum, pin_cnt, penalties


def forecast_from_states(cfg, states: ESRNNStates, t_len: int):
    """h-step forecast from the end of the series: (N, H), de-normalized.

    Eq. 5: ``yhat_{T+1..T+h} = exp(rnn_last) * l_T * s_{T+1..T+h}``.
    """
    last = states.yhat_n[:, -1, :]                       # (N, H) log-space
    m = max(cfg.seasonality, 1)
    fut_idx = t_len + torch.arange(cfg.output_size, device=last.device)
    s_fut = states.seas[:, future_seasonal_idx(fut_idx, t_len, m)]
    return torch.exp(last) * states.levels[:, -1:] * s_fut


def quantile_sigma(states: ESRNNStates, y):
    """Per-series log-residual spread sigma (N, 1) for quantile bands.

    The std (population, ddof 0) of ``log(y) - log(l * s)`` over the
    in-sample window.
    """
    t_len = y.shape[1]
    fitted = states.levels * states.seas[:, :t_len]
    log_resid = (torch.log(torch.clamp_min(y, 1e-8))
                 - torch.log(torch.clamp_min(fitted, 1e-8)))
    return torch.std(log_resid, dim=1, keepdim=True, correction=0)


def forecast_at_origins(cfg, states: ESRNNStates,
                        origins: Tuple[int, ...], t_len: int):
    """Rolling-origin forecasts off one forward pass: (N, K, H).

    ``origins[k]`` is an observation count ``o``: the k-th forecast equals
    the forecast of ``y[:, :o]``. Each origin must satisfy
    ``cfg.input_size <= o <= t_len``.
    """
    w, h = cfg.input_size, cfg.output_size
    m = max(cfg.seasonality, 1)
    for o in origins:
        if not w <= o <= t_len:
            raise ValueError(
                f"backtest origin {o} outside [{w}, {t_len}]: the input "
                f"window needs {w} observations and the series has {t_len}")
    outs = []
    for o in origins:
        last = states.yhat_n[:, o - w, :]                # position o-1
        fut_idx = o + torch.arange(h, device=last.device)
        s_fut = states.seas[:, future_seasonal_idx(fut_idx, o, m)]
        outs.append(torch.exp(last) * states.levels[:, o - 1 : o] * s_fut)
    return torch.stack(outs, dim=1)                      # (N, K, H)
