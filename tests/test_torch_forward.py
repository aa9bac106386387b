"""Parity of the port's forecast entry points with the JAX reference (CPU).

``esrnn_forecast``, ``esrnn_predict_stats`` and ``esrnn_forecast_at`` run on
the same numpy batch and the same weights (the JAX params pytree converted
leaf by leaf) in both packages; rtol 1e-4, atol 1e-5 in float32 (the whole
pass: sums in other orders, then through ``exp``).

JAX with ``use_pallas=True`` runs its LSTM-cell Pallas kernel in interpret
mode; its HW-scan Pallas kernel cannot run on the installed JAX (no
``pl.load``), so that one call is routed through the kernel's plain JAX
reference, and the JAX jit caches are cleared afterwards so no other test
sees the routed trace.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esrnn as jes
from repro.kernels import hw_scan as jhw_kernel
from repro.kernels import ref as jref
from repro_torch.convert import params_from_numpy
from repro_torch.core import esrnn as tes

RTOL, ATOL = 1e-4, 1e-5


def _batch(cfg, n, t, seed=0):
    rng = np.random.default_rng(seed)
    m = max(cfg.seasonality, 1)
    seas = np.tile(np.exp(rng.normal(0, 0.1, (n, m))), (1, t // m + 1))[:, :t]
    y = 50.0 * np.exp(rng.normal(0, 0.03, (n, t)).cumsum(axis=1)) * seas
    cats = np.eye(cfg.n_categories, dtype=np.float32)[rng.integers(0, cfg.n_categories, n)]
    return y.astype(np.float32), cats


def _jax_params(cfg, n, seed=0):
    """JAX init with per-series HW logits perturbed (numpy, from a seed)."""
    params = jes.esrnn_init(jax.random.PRNGKey(seed), cfg, n)
    rng = np.random.default_rng(seed + 100)
    hw = params["hw"]
    params["hw"] = dataclasses.replace(
        hw,
        alpha_logit=jnp.asarray(rng.normal(0, 1, n).astype(np.float32)),
        gamma_logit=jnp.asarray(rng.normal(-1, 1, n).astype(np.float32)),
        init_seas_logit=jnp.asarray(
            rng.normal(0, 0.1, hw.init_seas_logit.shape).astype(np.float32)))
    return jax.tree_util.tree_map(np.asarray, params)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture
def jax_hw_scan_via_reference(monkeypatch):
    def hw_scan_tm(y_tm, alpha, gamma, init_seas_tm, *, interpret=False):
        levels, seas = jref.hw_scan_ref(y_tm.T, alpha, gamma, init_seas_tm.T)
        return levels.T, seas.T

    monkeypatch.setattr(jhw_kernel, "hw_scan_tm", hw_scan_tm)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _compare(preset, n, t, origins, **overrides):
    jcfg = jes.make_config(preset, **overrides)
    tcfg = tes.make_config(preset, **overrides)
    y, cats = _batch(jcfg, n, t)
    jp = _jax_params(jcfg, n)
    tp = params_from_numpy(jp, "cpu")
    jy, jc = jnp.asarray(y), jnp.asarray(cats)
    ty, tc = torch.from_numpy(y), torch.from_numpy(cats)

    fc = tes.esrnn_forecast(tcfg, tp, ty, tc)
    assert fc.shape == (n, tcfg.output_size)
    _close(fc, jes.esrnn_forecast(jcfg, jp, jy, jc))
    got_fc, got_sigma = tes.esrnn_predict_stats(tcfg, tp, ty, tc)
    want_fc, want_sigma = jes.esrnn_predict_stats(jcfg, jp, jy, jc)
    _close(got_fc, want_fc)
    _close(got_sigma, want_sigma)
    _close(tes.esrnn_forecast_at(tcfg, tp, ty, tc, origins),
           jes.esrnn_forecast_at(jcfg, jp, jy, jc, origins))


@pytest.mark.parametrize("preset,attention", [
    ("quarterly", False), ("quarterly", True), ("yearly", False), ("monthly", False),
])
def test_forecasts_match_jax_plain(preset, attention):
    _compare(preset, 6, 40, (20, 33, 40), hidden_size=8, attention=attention)


@pytest.mark.parametrize("preset", ["quarterly", "yearly"])
def test_forecasts_match_jax_pallas(preset, jax_hw_scan_via_reference):
    _compare(preset, 3, 20, (12, 20), hidden_size=8, use_pallas=True)


def test_forecasts_match_jax_full_quarterly_width():
    _compare("quarterly", 4, 48, (24, 48))     # hidden 40, dilations ((1,2),(4,8))


def test_hourly_dual_ring_forecast_matches_jax():
    _compare("hourly", 2, 60, (48, 60), hidden_size=8, dilations=((1, 4), (24,)))


@pytest.mark.parametrize("origin", [8, 17, 30])
def test_backtest_origin_equals_truncated_predict(origin):
    cfg = tes.make_config("quarterly", hidden_size=8, attention=True)
    y, cats = _batch(cfg, 5, 36, seed=3)
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 5, device="cpu")
    ty, tc = torch.from_numpy(y), torch.from_numpy(cats)
    at = tes.esrnn_forecast_at(cfg, params, ty, tc, (origin,))[:, 0]
    trunc = tes.esrnn_forecast(cfg, params, ty[:, :origin].contiguous(), tc)
    torch.testing.assert_close(at, trunc, rtol=1e-6, atol=1e-6)


def test_forecast_at_rejects_bad_origins():
    cfg = tes.make_config("quarterly", hidden_size=8)
    y, cats = _batch(cfg, 2, 20)
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 2, device="cpu")
    for bad in (cfg.input_size - 1, 21):
        with pytest.raises(ValueError, match="outside"):
            tes.esrnn_forecast_at(cfg, params, torch.from_numpy(y),
                                  torch.from_numpy(cats), (bad,))


def test_config_matches_jax_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(jes.ESRNNConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tes.ESRNNConfig)]
    assert jf == tf
    assert jes.PRESETS == tes.PRESETS
    for precision in ("fp32", "bf16"):        # the compute dtype of both policies
        got = tes.make_config("quarterly", precision=precision).compute_dtype
        want = jes.make_config("quarterly", precision=precision).compute_dtype
        assert str(got).removeprefix("torch.") == str(want)


def test_init_structure_matches_jax():
    cfg = tes.make_config("quarterly", attention=True)
    jp = jes.esrnn_init(jax.random.PRNGKey(0), jes.make_config("quarterly", attention=True), 7)
    tp = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 7, device="cpu")
    assert sorted(jp) == sorted(tp)
    for k in ("head", "attn"):
        for name, leaf in jp[k].items():
            assert tuple(getattr(tp[k], name).shape) == leaf.shape
    np.testing.assert_array_equal(tp["hw"].alpha_logit.numpy(), np.asarray(jp["hw"].alpha_logit))


def test_rnn_head_is_the_lstm_head():
    """``forward.rnn_head``, the paper head's public name, in ``__all__`` of
    both packages: the reference's ``rnn_head`` on the same features and
    weights, and the registry's lstm head bit for bit."""
    from repro.core import forward as jfwd
    from repro_torch.core import forward as tfwd
    from repro_torch.core import heads as theads

    assert "rnn_head" in tfwd.__all__ and "rnn_head" in jfwd.__all__
    jcfg = jes.make_config("quarterly", hidden_size=8)
    tcfg = tes.make_config("quarterly", hidden_size=8)
    jp = _jax_params(jcfg, 5)
    tp = params_from_numpy(jp, "cpu")
    width = jcfg.input_size + jcfg.n_categories
    feats = np.random.default_rng(4).normal(0, 1, (5, 9, width)).astype(np.float32)
    with torch.no_grad():
        got, got_c = tfwd.rnn_head(tcfg, tp, torch.from_numpy(feats))
        same, same_c = theads.lstm_head_apply(tcfg, tp, torch.from_numpy(feats))
    want, want_c = jfwd.rnn_head(jcfg, jp, jnp.asarray(feats))
    assert torch.equal(got, same) and torch.equal(got_c, same_c)
    _close(got, want)
    _close(got_c, want_c)
