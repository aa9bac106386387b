"""Parity of the port's losses and metrics with ``repro.core.losses`` (CPU).

Every function runs on the same numpy inputs in both packages; float32,
rtol 1e-6 (elementwise maps and one reduction each, summed in another
order at most).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro_torch.core import losses as tl

RTOL = 1e-6


def _case(seed, shape=(6, 9)):
    rng = np.random.default_rng(seed)
    pred = rng.lognormal(2.0, 0.3, shape).astype(np.float32)
    target = rng.lognormal(2.0, 0.3, shape).astype(np.float32)
    mask = (rng.random(shape) > 0.3).astype(np.float32)
    return pred, target, mask


def _both(name, *args, **kw):
    to_t = lambda a: torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
    to_j = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    got = getattr(tl, name)(*map(to_t, args), **{k: to_t(v) for k, v in kw.items()})
    want = getattr(jl, name)(*map(to_j, args), **{k: to_j(v) for k, v in kw.items()})
    return got, want


def _close(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want, strict=True):
            _close(g, w)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("masked", [False, True])
def test_pinball_and_smape_match_jax(seed, masked):
    pred, target, mask = _case(seed)
    m = mask if masked else None
    for tau in (0.49, 0.9):
        _close(*_both("pinball_loss", pred, target, tau=tau, mask=m))
        _close(*_both("pinball_terms", pred, target, tau=tau, mask=m))
    _close(*_both("smape", pred, target, mask=m))
    _close(*_both("smape", pred, target, mask=m, axis=1))
    _close(*_both("smape_terms", pred, target, mask=m))


@pytest.mark.parametrize("seasonality,t_len", [(4, 20), (12, 10), (1, 7)])
def test_mase_matches_jax(seasonality, t_len):
    pred, target, mask = _case(seasonality, (5, 8))
    insample = _case(seasonality + 1, (5, t_len))[0]
    for m in (None, mask):
        _close(*_both("mase", pred, target, insample, seasonality, mask=m))
        _close(*_both("mase_terms", pred, target, insample, seasonality, mask=m))


def test_rolling_terms_and_owa_match_jax():
    rng = np.random.default_rng(3)
    y = rng.lognormal(2, 0.2, (4, 30)).astype(np.float32)
    fc = rng.lognormal(2, 0.2, (4, 3, 6)).astype(np.float32)
    tgt = rng.lognormal(2, 0.2, (4, 3, 6)).astype(np.float32)
    tmask = (rng.random((4, 3, 6)) > 0.2).astype(np.float32)
    _close(*_both("rolling_metric_terms", fc, tgt, tmask, y, (12, 20, 24), 4))
    assert float(tl.owa(torch.tensor(10.0), torch.tensor(1.2), 12.0, 1.5)) == pytest.approx(
        float(jl.owa(10.0, 1.2, 12.0, 1.5)))


@pytest.mark.parametrize("weight", [0.0, 0.7])
def test_penalties_match_jax(weight):
    levels = _case(5, (4, 12))[0]
    _close(*_both("level_variability_penalty", levels, weight))
    _close(*_both("cstate_penalty", np.asarray(0.37, np.float32), weight))
