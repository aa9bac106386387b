"""Loss and metric functions (paper sections 3.5 and 8.4), PyTorch port.

Counterpart of ``repro.core.losses``, function for function:

* pin-ball (quantile) loss -- the differentiable surrogate used for
  training (Takeuchi et al. 2006; Smyl used tau slightly below 0.5);
* sMAPE / MASE -- the M4 competition metrics, plus OWA;
* the section-8.4 penalties: level variability and the cell-state
  magnitude penalty (Krueger & Memisevic).

The ``*_terms`` functions return ``(sum, count)`` pairs so that a masked
mean can be reduced exactly across batches or devices (divide once).
"""

from __future__ import annotations

import torch


def _as_tensor(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def pinball_loss(pred, target, tau: float = 0.49, mask=None):
    """Mean pin-ball loss. pred/target broadcastable; mask 1=keep."""
    diff = target - pred
    loss = torch.maximum(tau * diff, (tau - 1.0) * diff)
    if mask is None:
        return torch.mean(loss)
    num, den = pinball_terms(pred, target, tau=tau, mask=mask)
    return num / torch.clamp_min(den, 1.0)


def pinball_terms(pred, target, tau: float = 0.49, mask=None):
    """Masked pin-ball numerator and denominator: ``(sum, valid_count)``.

    ``pinball_loss(mask=...)`` is exactly ``sum / max(count, 1)``.
    """
    diff = target - pred
    loss = torch.maximum(tau * diff, (tau - 1.0) * diff)
    if mask is None:
        return torch.sum(loss), _as_tensor(loss.numel(), loss)
    mask = torch.broadcast_to(mask, loss.shape)
    return torch.sum(loss * mask), torch.sum(mask)


def _smape_ratio(pred, target):
    num = torch.abs(target - pred)
    den = torch.abs(target) + torch.abs(pred)
    return torch.where(den > 0, num / den, torch.zeros_like(den))


def smape(pred, target, mask=None, axis=None):
    """Symmetric MAPE in percent, the M4 headline metric.

    sMAPE = 200/h * sum |y - yhat| / (|y| + |yhat|)
    """
    ratio = _smape_ratio(pred, target)
    dim = () if axis is None else axis
    if mask is not None:
        mask = torch.broadcast_to(mask, ratio.shape)
        return 200.0 * torch.sum(ratio * mask, dim=dim) / torch.clamp_min(
            torch.sum(mask, dim=dim), 1.0)
    return 200.0 * torch.mean(ratio, dim=dim)


def smape_terms(pred, target, mask=None):
    """sMAPE numerator and denominator: ``(ratio_sum, valid_count)``.

    ``smape == 200 * ratio_sum / max(valid_count, 1)``.
    """
    ratio = _smape_ratio(pred, target)
    if mask is None:
        return torch.sum(ratio), _as_tensor(ratio.numel(), ratio)
    mask = torch.broadcast_to(mask, ratio.shape)
    return torch.sum(ratio * mask), torch.sum(mask)


def _mase_lag(insample, seasonality: int) -> int:
    """Scale lag for MASE: the seasonal lag, or 1 when the insample is too
    short for one seasonal difference (the standard short-series rule)."""
    m = max(seasonality, 1)
    return m if insample.shape[1] > m else 1


def _mase_scaled(pred, target, insample, seasonality: int):
    m = _mase_lag(insample, seasonality)
    scale = torch.mean(torch.abs(insample[:, m:] - insample[:, :-m]), dim=1)
    return torch.abs(target - pred) / torch.clamp_min(scale[:, None], 1e-8)


def mase_terms(pred, target, insample, seasonality: int, mask=None):
    """MASE numerator and denominator: ``(scaled_err_sum, valid_count)``."""
    scaled = _mase_scaled(pred, target, insample, seasonality)
    if mask is None:
        return torch.sum(scaled), _as_tensor(scaled.numel(), scaled)
    mask = torch.broadcast_to(mask, scaled.shape)
    return torch.sum(scaled * mask), torch.sum(mask)


def mase(pred, target, insample, seasonality: int, mask=None):
    """Mean Absolute Scaled Error against the seasonal-naive in-sample MAE.

    pred/target: (N, H); insample: (N, T) history used for the scale.
    """
    scaled = _mase_scaled(pred, target, insample, seasonality)
    if mask is not None:
        mask = torch.broadcast_to(mask, scaled.shape)
        return torch.sum(scaled * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(scaled)


def rolling_metric_terms(fc, target, tmask, y, origins, seasonality: int):
    """Per-origin sMAPE/MASE terms for rolling-origin backtests.

    fc/target/tmask: (N, K, H); y: (N, T). Returns ``(s_sum, s_cnt, m_sum,
    m_cnt)``, each (K,); the MASE scale at origin ``o`` uses ``y[:, :o]``.
    """
    s_sums, s_cnts, m_sums, m_cnts = [], [], [], []
    for k, o in enumerate(origins):
        ss, sc = smape_terms(fc[:, k], target[:, k], mask=tmask[:, k])
        ms, mc = mase_terms(fc[:, k], target[:, k], y[:, :o], seasonality,
                            mask=tmask[:, k])
        s_sums.append(ss)
        s_cnts.append(sc)
        m_sums.append(ms)
        m_cnts.append(mc)
    return (torch.stack(s_sums), torch.stack(s_cnts),
            torch.stack(m_sums), torch.stack(m_cnts))


def owa(smape_model, mase_model, smape_naive2, mase_naive2):
    """Overall Weighted Average relative to Naive2 (the M4 ranking metric)."""
    return 0.5 * (smape_model / smape_naive2 + mase_model / mase_naive2)


def level_variability_penalty(levels, weight: float):
    """Section 8.4: penalize abrupt changes in the log-level trend.

    d_t = log(l_{t+1} / l_t); penalty = weight * mean (d_{t+1} - d_t)^2.
    """
    if weight == 0.0:
        return torch.zeros((), dtype=levels.dtype, device=levels.device)
    log_l = torch.log(torch.clamp_min(levels, 1e-8))
    d = log_l[:, 1:] - log_l[:, :-1]
    dd = d[:, 1:] - d[:, :-1]
    return weight * torch.mean(torch.square(dd))


def cstate_penalty(mean_cstate_sq, weight: float):
    """Section 8.4: Krueger & Memisevic hidden-state stabilization."""
    return weight * mean_cstate_sq
