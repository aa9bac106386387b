"""Synthetic M4-like dataset generator.

The real M4 CSVs are not available offline, so experiments run on synthetic
series whose *statistical profile* matches the paper's Tables 2 and 3:

* Table 2: series counts per (frequency x category); we keep the category
  proportions and allow scaling the totals down.
* Table 3: per-frequency length distributions (mean/std/min/max); lengths are
  sampled from a clipped lognormal fit to those moments.

Series are generated from the same family the Holt-Winters model assumes --
multiplicative level x seasonality x noise with occasional trend changes --
plus per-category flavor (Finance: heavier noise; Demographic: smoother;
Industry: stronger trend; etc.) so the category one-hot feature carries
signal, as in the real M4.

A numpy copy of ``repro.data.synthetic_m4`` for the port: the same seed
gives the same series, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

CATEGORIES = ["Demographic", "Finance", "Industry", "Macro", "Micro", "Other"]

# Table 2 (paper) counts per frequency x category.
TABLE2_COUNTS = {
    "yearly": [1088, 6519, 3716, 3903, 6538, 1236],
    "quarterly": [1858, 5305, 4637, 5315, 6020, 865],
    "monthly": [5728, 10987, 10017, 10016, 10975, 277],
    "weekly": [24, 164, 6, 41, 112, 12],
    "daily": [10, 1559, 422, 127, 1476, 633],
    "hourly": [0, 0, 0, 0, 0, 414],
}

# Table 3 (paper) length stats: mean, std, min, max.
TABLE3_LEN_STATS = {
    "yearly": (25, 24, 7, 829),
    "quarterly": (84, 51, 8, 858),
    "monthly": (198, 137, 24, 2776),
    "weekly": (1009, 707, 67, 2584),
    "daily": (2343, 1756, 79, 9905),
    "hourly": (805, 127, 652, 912),
}

SEASONALITY = {"yearly": 1, "quarterly": 4, "monthly": 12, "weekly": 1,
               "daily": 1, "hourly": 24}
HORIZON = {"yearly": 6, "quarterly": 8, "monthly": 18, "weekly": 13,
           "daily": 14, "hourly": 48}

# per-category generator flavor: (noise_sigma, trend_sigma, seas_strength)
_CATEGORY_FLAVOR = {
    "Demographic": (0.015, 0.002, 0.08),
    "Finance": (0.06, 0.004, 0.05),
    "Industry": (0.03, 0.006, 0.15),
    "Macro": (0.02, 0.003, 0.10),
    "Micro": (0.04, 0.004, 0.12),
    "Other": (0.05, 0.005, 0.10),
}


@dataclasses.dataclass
class M4Dataset:
    """A bag of variable-length series for one frequency."""

    frequency: str
    series: List[np.ndarray]          # each (T_i,), float32, strictly > 0
    categories: np.ndarray            # (N,) int in [0, 6)
    seasonality: int
    horizon: int

    @property
    def n_series(self) -> int:
        return len(self.series)

    def category_onehot(self) -> np.ndarray:
        eye = np.eye(len(CATEGORIES), dtype=np.float32)
        return eye[self.categories]


def _sample_lengths(rng, n, freq):
    mean, std, lo, hi = TABLE3_LEN_STATS[freq]
    # lognormal matching the first two moments, clipped to [lo, hi]
    var = std**2
    sigma2 = np.log(1.0 + var / mean**2)
    mu = np.log(mean) - 0.5 * sigma2
    lengths = rng.lognormal(mu, np.sqrt(sigma2), n)
    return np.clip(lengths.astype(int), lo, hi)


def _gen_one(rng, length, seasonality, flavor):
    noise_sigma, trend_sigma, seas_strength = flavor
    base = rng.uniform(50.0, 5000.0)
    # log-level random walk with slowly-varying drift
    drift = rng.normal(0.0, trend_sigma)
    eps = rng.normal(0.0, trend_sigma, length).cumsum()
    log_level = np.log(base) + drift * np.arange(length) + eps
    if seasonality > 1:
        profile = rng.normal(0.0, seas_strength, seasonality)
        profile -= profile.mean()
        seas = np.exp(np.tile(profile, length // seasonality + 1)[:length])
    else:
        seas = 1.0
    noise = np.exp(rng.normal(0.0, noise_sigma, length))
    y = np.exp(log_level) * seas * noise
    return np.maximum(y, 1e-3).astype(np.float32)


def generate(
    frequency: str, *, scale: float = 0.01, seed: int = 0, min_series: int = 8
) -> M4Dataset:
    """Generate a synthetic M4 slice.

    ``scale`` multiplies the Table-2 counts (1.0 == full 100k-series M4;
    default 1% keeps CPU runs fast).
    """
    rng = np.random.default_rng(seed)
    counts = [max(min_series, int(c * scale)) if c else 0 for c in TABLE2_COUNTS[frequency]]
    m = SEASONALITY[frequency]
    series, cats = [], []
    for ci, (cat, cnt) in enumerate(zip(CATEGORIES, counts)):
        flavor = _CATEGORY_FLAVOR[cat]
        lengths = _sample_lengths(rng, cnt, frequency)
        for ln in lengths:
            series.append(_gen_one(rng, int(ln), m, flavor))
            cats.append(ci)
    return M4Dataset(
        frequency=frequency,
        series=series,
        categories=np.asarray(cats, np.int32),
        seasonality=m,
        horizon=HORIZON[frequency],
    )
