"""The M4 ``Comb`` benchmark (paper section 6) + Naive baselines (numpy).

The port's own copy of ``repro.core.comb`` (the port imports nothing of the
JAX package, not even its numpy-only modules); ``tests/test_torch_bf16_train.py``
holds the two equal on seeded series. Naive2 is the denominator of M4's OWA,
which ``chip_smoke.py``'s ``owa_bf16`` phase scores the port's forecasts
with.

Comb = the arithmetic mean of Simple, Holt, and Damped exponential smoothing
forecasts -- "a tough-to-beat benchmark, with a Rank of 19 in the M4
competition" (Makridakis et al. 2018). As in M4, seasonal series are
deseasonalized by classical multiplicative decomposition (ratio to centered
moving average), forecast, and re-seasonalized.

Everything is vectorized across series (grid-search parameter fitting
included) -- the same batching idea the paper applies to ES-RNN.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _ses_sse(y, alpha):
    """One-step in-sample SSE of simple ES, vectorized over (N, grid)."""
    n, t = y.shape
    g = alpha.shape[0]
    l = np.broadcast_to(y[:, 0][:, None], (n, g)).copy()
    sse = np.zeros((n, g))
    for i in range(1, t):
        err = y[:, i][:, None] - l
        sse += err**2
        l = l + alpha[None, :] * err
    return sse, l


def ses_forecast(y: np.ndarray, horizon: int) -> np.ndarray:
    alphas = np.linspace(0.05, 0.95, 10)
    sse, levels = _ses_sse(y, alphas)
    best = np.argmin(sse, axis=1)
    l = levels[np.arange(y.shape[0]), best]
    return np.repeat(l[:, None], horizon, axis=1)


def _holt_fit(y, alphas, betas, phi=1.0):
    """Damped Holt, vectorized over series x (alpha, beta) grid."""
    n, t = y.shape
    ga, gb = len(alphas), len(betas)
    a = alphas[None, :, None]
    b = betas[None, None, :]
    l = np.broadcast_to(y[:, 0][:, None, None], (n, ga, gb)).copy()
    tr = np.broadcast_to((y[:, 1] - y[:, 0])[:, None, None], (n, ga, gb)).copy()
    sse = np.zeros((n, ga, gb))
    for i in range(1, t):
        pred = l + phi * tr
        err = y[:, i][:, None, None] - pred
        sse += err**2
        l_new = pred + a * err
        tr = phi * tr + a * b * err
        l = l_new
    return sse, l, tr


def holt_forecast(y: np.ndarray, horizon: int, phi: float = 1.0) -> np.ndarray:
    alphas = np.linspace(0.1, 0.9, 6)
    betas = np.linspace(0.05, 0.5, 4)
    sse, l, tr = _holt_fit(y, alphas, betas, phi)
    n = y.shape[0]
    flat = sse.reshape(n, -1).argmin(axis=1)
    ia, ib = np.unravel_index(flat, sse.shape[1:])
    l_b = l[np.arange(n), ia, ib]
    t_b = tr[np.arange(n), ia, ib]
    if phi == 1.0:
        steps = np.arange(1, horizon + 1)
    else:
        steps = np.cumsum(phi ** np.arange(1, horizon + 1))
    return l_b[:, None] + t_b[:, None] * steps[None, :]


def classical_seasonal_factors(y: np.ndarray, m: int) -> np.ndarray:
    """Multiplicative ratio-to-moving-average decomposition. y: (N, T)."""
    n, t = y.shape
    if m <= 1 or t < 2 * m:
        return np.ones((n, m))
    k = m
    kernel = np.ones(k) / k
    # centered MA (even periods: average of two offset MAs)
    ma = np.apply_along_axis(lambda r: np.convolve(r, kernel, "valid"), 1, y)
    if m % 2 == 0:
        ma = 0.5 * (ma[:, :-1] + ma[:, 1:])
        offset = m // 2
    else:
        offset = (m - 1) // 2
    ratios = y[:, offset : offset + ma.shape[1]] / np.maximum(ma, 1e-8)
    factors = np.ones((n, m))
    for ph in range(m):
        idx = (np.arange(ratios.shape[1]) + offset) % m == ph
        if idx.any():
            factors[:, ph] = np.median(ratios[:, idx], axis=1)
    factors /= factors.mean(axis=1, keepdims=True)
    return factors


def deseasonalize(y: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    factors = classical_seasonal_factors(y, m)
    t = y.shape[1]
    tiled = np.tile(factors, (1, t // m + 1))[:, :t]
    return y / np.maximum(tiled, 1e-8), factors


def reseasonalize(fc: np.ndarray, factors: np.ndarray, t_start: int) -> np.ndarray:
    h = fc.shape[1]
    m = factors.shape[1]
    idx = (t_start + np.arange(h)) % m
    return fc * factors[:, idx]


def comb_forecast(y: np.ndarray, horizon: int, seasonality: int) -> np.ndarray:
    """The M4 benchmark: mean(SES, Holt, Damped) on deseasonalized data."""
    y = np.asarray(y, np.float64)
    ydes, factors = deseasonalize(y, seasonality)
    f1 = ses_forecast(ydes, horizon)
    f2 = holt_forecast(ydes, horizon, phi=1.0)
    f3 = holt_forecast(ydes, horizon, phi=0.9)
    fc = (f1 + f2 + f3) / 3.0
    if seasonality > 1:
        fc = reseasonalize(fc, factors, y.shape[1])
    return np.maximum(fc, 1e-8)


def naive_forecast(y: np.ndarray, horizon: int) -> np.ndarray:
    return np.repeat(y[:, -1:], horizon, axis=1)


def seasonal_naive_forecast(y: np.ndarray, horizon: int, m: int) -> np.ndarray:
    if m <= 1:
        return naive_forecast(y, horizon)
    reps = -(-horizon // m)
    return np.tile(y[:, -m:], (1, reps))[:, :horizon]


def naive2_forecast(y: np.ndarray, horizon: int, m: int) -> np.ndarray:
    """Naive on deseasonalized data (the M4 OWA denominator)."""
    ydes, factors = deseasonalize(np.asarray(y, np.float64), m)
    fc = naive_forecast(ydes, horizon)
    if m > 1:
        fc = reseasonalize(fc, factors, y.shape[1])
    return fc
