"""Vectorized Holt-Winters exponential smoothing (paper Eqs. 1-4, Smyl variant).

PyTorch counterpart of ``repro.core.holt_winters``. The per-series smoothing
parameters live as batched tensors (an :class:`HWParams` dataclass, one row
per series, so a server can gather and swap rows per request), and the
recurrence runs vectorized across series:

    l_t = alpha * y_t / s_t      + (1 - alpha) * l_{t-1}          (level)
    s_{t+m} = gamma * y_t / l_t  + (1 - gamma) * s_t              (seasonality)

with multiplicative seasonality of period ``m`` and an optional second
seasonal ring (paper section 8.2).

:func:`hw_smooth` sends the single-ring case to ``kernels.ops.hw_scan`` --
the CUDA kernel K1 for a tensor on the card, its plain version on the CPU --
and the dual ring (hourly) to the plain scan here, because K1 does not cover
it. That is the JAX package's own rule (``holt_winters.py:183``), not a
fallback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class HWParams:
    """Per-series Holt-Winters parameters (the paper's N*(2+S) parameters).

    All leaves have a leading series axis ``(N, ...)`` and hold unconstrained
    logits; :meth:`constrained` maps them to

      alpha = sigmoid(alpha_logit)          in (0, 1)
      gamma = sigmoid(gamma_logit)          in (0, 1)
      init_seas = exp(init_seas_logit)      > 0   (multiplicative)

    ``init_seas_logit2`` is the optional second seasonality (section 8.2);
    ``None`` when single-seasonal.
    """

    alpha_logit: torch.Tensor           # (N,)
    gamma_logit: torch.Tensor           # (N,)
    init_seas_logit: torch.Tensor       # (N, m)
    gamma2_logit: Optional[torch.Tensor] = None       # (N,)
    init_seas_logit2: Optional[torch.Tensor] = None   # (N, m2)

    def constrained(self):
        out = dict(
            alpha=torch.sigmoid(self.alpha_logit),
            gamma=torch.sigmoid(self.gamma_logit),
            init_seas=torch.exp(self.init_seas_logit),
        )
        if self.init_seas_logit2 is not None:
            out["gamma2"] = torch.sigmoid(self.gamma2_logit)
            out["init_seas2"] = torch.exp(self.init_seas_logit2)
        return out

    def map(self, fn) -> "HWParams":
        """Apply ``fn`` to every present leaf (``None`` leaves stay None)."""
        return HWParams(**{
            f.name: (None if getattr(self, f.name) is None
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)})

    def to(self, device) -> "HWParams":
        return self.map(lambda a: a.to(device))


def hw_init_params(
    n_series: int,
    seasonality: int,
    *,
    seasonality2: int = 0,
    alpha0: float = 0.5,
    gamma0: float = 0.5,
    dtype=torch.float32,
    device=None,
) -> HWParams:
    """Primer initialization (paper section 3.3): neutral smoothing
    coefficients and flat (== 1.0) initial seasonality. ``device`` must be
    given by the caller (see :func:`repro_torch.device.resolve_device`)."""
    dev = resolve_device(device)

    def logit(p):
        return float(math.log(p / (1.0 - p)))

    m = max(seasonality, 1)
    params = HWParams(
        alpha_logit=torch.full((n_series,), logit(alpha0), dtype=dtype, device=dev),
        gamma_logit=torch.full((n_series,), logit(gamma0), dtype=dtype, device=dev),
        init_seas_logit=torch.zeros((n_series, m), dtype=dtype, device=dev),
    )
    if seasonality2:
        params = dataclasses.replace(
            params,
            gamma2_logit=torch.full((n_series,), logit(gamma0), dtype=dtype, device=dev),
            init_seas_logit2=torch.zeros((n_series, seasonality2), dtype=dtype, device=dev),
        )
    return params


# ---------------------------------------------------------------------------
# The one-step recurrence (shared by the scan and the online serving path)
# ---------------------------------------------------------------------------


def hw_step(
    y_t,
    level,
    s_t,
    s2_t,
    alpha,
    gamma,
    gamma2=None,
    *,
    seasonal: bool = True,
    dual: bool = False,
):
    """One Holt-Winters update: ``(l_t, s_new, s2_new)`` from observation y_t.

        l_t     = alpha * y_t / (s_t * s2_t) + (1 - alpha) * l_{t-1}
        s_{t+m} = gamma * y_t / (l_t * s2_t) + (1 - gamma) * s_t
        s2_{t+m2} = gamma2 * y_t / (l_t * s_t) + (1 - gamma2) * s2_t

    Pure arithmetic, so it runs on tensors inside :func:`hw_smooth`'s scan
    and on host numpy for the server's online ``observe`` path.
    ``seasonal=False`` holds the seasonal factor fixed (m == 1 series);
    ``dual`` enables the second ring. Ring rotation is the caller's job.
    """
    s_all = s_t * s2_t
    l_t = alpha * y_t / s_all + (1.0 - alpha) * level
    s_new = (gamma * y_t / (l_t * s2_t) + (1.0 - gamma) * s_t
             if seasonal else s_t)
    s2_new = (gamma2 * y_t / (l_t * s_t) + (1.0 - gamma2) * s2_t
              if dual else s2_t)
    return l_t, s_new, s2_new


# ---------------------------------------------------------------------------
# Vectorized scan
# ---------------------------------------------------------------------------


def hw_smooth(
    y: torch.Tensor,
    params: HWParams,
    *,
    seasonality: int,
    seasonality2: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the batched Holt-Winters recurrence.

    Args:
      y: ``(N, T)`` strictly-positive series values (multiplicative model).
      params: per-series :class:`HWParams` on ``y``'s device.
      seasonality: period ``m`` (1 => non-seasonal; seasonality fixed at 1.0).
      seasonality2: optional second period (0 => disabled).

    Returns:
      levels: ``(N, T)`` level l_t after observing y_t.
      seas:   ``(N, T + m)``; ``seas[:, t]`` is s_t, the factor applied to
        y_t, and positions ``T .. T+m-1`` are the smoothed future factors.
        For ``seasonality2`` the product of both rings is returned.
    """
    if seasonality2 == 0:
        from repro_torch.kernels import ops as kernel_ops

        return kernel_ops.hw_scan(y, params, seasonality=seasonality)
    return _hw_smooth_scan(y, params, seasonality, seasonality2)


def _hw_smooth_scan(y, params, seasonality, seasonality2):
    n, t_len = y.shape
    c = params.constrained()
    alpha, gamma = c["alpha"], c["gamma"]
    m = max(seasonality, 1)
    seasonal = seasonality > 1
    ones = lambda k: torch.ones((n, k), dtype=alpha.dtype, device=alpha.device)

    # rings as python lists of (N,) columns; index 0 is the current s_t
    seas0 = c["init_seas"] if seasonal else ones(m)
    dual = seasonality2 > 1
    if dual:
        m2 = seasonality2
        gamma2 = c["gamma2"]
        seas20 = c["init_seas2"]
    else:
        m2 = 1
        gamma2 = torch.zeros_like(gamma)
        seas20 = ones(1)
    s_ring = list(seas0.unbind(1))
    s2_ring = list(seas20.unbind(1))

    # initial level: first de-seasonalized observation (primer estimate)
    l_prev = y[:, 0] / (s_ring[0] * s2_ring[0])
    levels, seas_used = [], []
    for t in range(t_len):
        s_t = s_ring.pop(0)
        s2_t = s2_ring.pop(0)
        l_t, s_new, s2_new = hw_step(
            y[:, t], l_prev, s_t, s2_t, alpha, gamma, gamma2,
            seasonal=seasonal, dual=dual)
        s_ring.append(s_new)
        s2_ring.append(s2_new)
        levels.append(l_t)
        seas_used.append(s_t * s2_t)
        l_prev = l_t

    # future factors s_T .. s_{T+m-1}; the dual ring tiles the shorter one
    if dual:
        reps = (m + m2 - 1) // m2
        tiled = (s2_ring * reps)[:m]
        future = [a * b for a, b in zip(s_ring, tiled)]
    else:
        future = s_ring
    return torch.stack(levels, dim=1), torch.stack(seas_used + future, dim=1)


# ---------------------------------------------------------------------------
# Per-series loop reference (Smyl's original CPU structure)
# ---------------------------------------------------------------------------


def hw_smooth_loop_reference(
    y, params: HWParams, *, seasonality: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-ring smoothing in float64 numpy, an outer loop over series and
    an inner one over time: the structure the paper vectorized, kept as the
    oracle of the equivalence tests and the slow baseline of the Table-5
    speedup benchmark. ``y`` (N, T) and ``params``' leaves may be tensors
    (on any device) or arrays. Returns levels (N, T) and seasonality (N, T + m).
    """
    f64 = lambda a: np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, np.float64)
    y = f64(y)
    n, t_len = y.shape
    m = max(seasonality, 1)
    seasonal = seasonality > 1
    alpha = 1.0 / (1.0 + np.exp(-f64(params.alpha_logit)))
    gamma = 1.0 / (1.0 + np.exp(-f64(params.gamma_logit)))
    init_seas = np.exp(f64(params.init_seas_logit))

    levels = np.empty((n, t_len))
    seas = np.empty((n, t_len + m))
    for i in range(n):  # <- the loop the paper removes
        ring = list(init_seas[i] if seasonal else np.ones(m))
        l_prev = y[i, 0] / ring[0]
        for t in range(t_len):
            s_t = ring[0]
            l_t = alpha[i] * y[i, t] / s_t + (1 - alpha[i]) * l_prev
            s_new = gamma[i] * y[i, t] / l_t + (1 - gamma[i]) * s_t if seasonal else s_t
            ring = ring[1:] + [s_new]
            levels[i, t] = l_t
            seas[i, t] = s_t
            l_prev = l_t
        seas[i, t_len:] = ring
    return levels, seas


# ---------------------------------------------------------------------------
# Classic HW forecast (Eq. 4) and the seasonal extension
# ---------------------------------------------------------------------------


def hw_forecast(
    levels: torch.Tensor, seas: torch.Tensor, horizon: int, *, seasonality: int
) -> torch.Tensor:
    """h-step forecast y_hat_{T+h} = l_T * s_{T+h} (Eq. 4 with b_t == 1).

    ``seas`` is the ``(N, T+m)`` array from :func:`hw_smooth`; future factors
    beyond T+m tile the last season cyclically.
    """
    m = max(seasonality, 1)
    last_level = levels[:, -1]
    last_season = seas[:, -m:]
    reps = -(-horizon // m)
    future = last_season.repeat(1, reps)[:, :horizon]
    return last_level[:, None] * future


def extend_seasonality(seas: torch.Tensor, t_len: int, horizon: int, seasonality: int):
    """Seasonality factors s_{T+1} .. s_{T+h} for de-normalizing forecasts.

    ``seas`` has valid entries up to index T+m-1; beyond that the last season
    is tiled cyclically (horizon can exceed m, e.g. quarterly h=8 > m=4).
    """
    m = max(seasonality, 1)
    if horizon <= m:
        return seas[:, t_len : t_len + horizon]
    last_season = seas[:, t_len : t_len + m]
    reps = -(-horizon // m)
    return last_season.repeat(1, reps)[:, :horizon]
