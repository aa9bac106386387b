"""Parity of the port's Holt-Winters layer with the JAX reference, on the CPU.

The same numpy inputs and HW logits go through ``repro.core.holt_winters``
and ``repro_torch.core.holt_winters``; everything is compared in float32
with rtol 1e-5 (the two run the same operations in the same order, so the
only slack is for library-level differences in sigmoid/exp).

The JAX kernel path (``use_pallas=True`` -> ``repro.kernels.ops.hw_scan`` ->
the Pallas kernel) cannot run in interpret mode on the installed JAX, which
no longer has ``pl.load``; the JAX package's own kernel tests fail there. So
the port's ``kernels.ops.hw_scan`` is held against JAX's ``ops.hw_scan``
with the Pallas call routed through the kernel's plain JAX reference
(``repro.kernels.ref.hw_scan_ref``) -- the wrapper's constrained
transforms, m == 1 convention and lane padding all still run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import holt_winters as jhw
from repro.kernels import hw_scan as jhw_kernel
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import holt_winters as thw
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL = 1e-5


def _logits(n, m, m2=0, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(0.0, 0.7, shape).astype(np.float32)
    kw = dict(alpha_logit=f(n), gamma_logit=f(n),
              init_seas_logit=0.2 * f(n, max(m, 1)))
    if m2:
        kw.update(gamma2_logit=f(n), init_seas_logit2=0.2 * f(n, m2))
    return kw


def _series(n, t, m, seed=1):
    rng = np.random.default_rng(seed)
    seas = np.exp(rng.normal(0, 0.15, (n, max(m, 1))))
    seas = np.tile(seas, (1, t // max(m, 1) + 1))[:, :t]
    level = 100.0 * np.exp(rng.normal(0, 0.03, (n, t)).cumsum(axis=1))
    return (level * seas * np.exp(rng.normal(0, 0.05, (n, t)))).astype(np.float32)


def _jax_params(kw):
    return jhw.HWParams(**{k: jnp.asarray(v) for k, v in kw.items()})


def _torch_params(kw):
    return thw.HWParams(**{k: torch.from_numpy(v) for k, v in kw.items()})


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


@pytest.fixture
def jax_hw_scan_via_reference(monkeypatch):
    """Route JAX's Pallas HW-scan call through its plain reference."""
    def hw_scan_tm(y_tm, alpha, gamma, init_seas_tm, *, interpret=False):
        levels, seas = jref.hw_scan_ref(y_tm.T, alpha, gamma, init_seas_tm.T)
        return levels.T, seas.T

    monkeypatch.setattr(jhw_kernel, "hw_scan_tm", hw_scan_tm)


@pytest.mark.parametrize("m,t_len", [(1, 30), (4, 37), (12, 50), (4, 3), (12, 7)])
def test_hw_smooth_matches_jax_scan(m, t_len):
    kw, y = _logits(6, m), _series(6, t_len, m)
    want = jhw.hw_smooth(jnp.asarray(y), _jax_params(kw), seasonality=m,
                         use_pallas=False)
    got = thw.hw_smooth(torch.from_numpy(y), _torch_params(kw), seasonality=m)
    assert got[0].shape == (6, t_len) and got[1].shape == (6, t_len + max(m, 1))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("m,t_len", [(1, 30), (4, 37), (12, 50), (4, 3)])
def test_hw_scan_matches_jax_ops_path(m, t_len, jax_hw_scan_via_reference):
    # N = 130 crosses JAX's 128-lane padding edge
    kw, y = _logits(130, m, seed=2), _series(130, t_len, m, seed=3)
    want = jops.hw_scan(jnp.asarray(y), _jax_params(kw), seasonality=m)
    got = tops.hw_scan(torch.from_numpy(y), _torch_params(kw), seasonality=m)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("m", [1, 4, 12])
def test_plain_kernel_version_matches_jax_reference(m):
    rng = np.random.default_rng(m)
    n, t = 9, 41
    y = _series(n, t, m, seed=4)
    alpha = rng.uniform(0.05, 0.95, n).astype(np.float32)
    gamma = rng.uniform(0.05, 0.95, n).astype(np.float32)
    init_seas = rng.uniform(0.7, 1.3, (n, m)).astype(np.float32)
    want = jref.hw_scan_ref(*(jnp.asarray(a) for a in (y, alpha, gamma, init_seas)))
    got = tref.hw_scan_ref(*(torch.from_numpy(a) for a in (y, alpha, gamma, init_seas)))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_kernel_path_equals_plain_scan_bitwise():
    """Single ring: ops.hw_scan on the CPU == the hw_step scan, bit for bit."""
    kw, y = _logits(7, 4, seed=5), _series(7, 33, 4, seed=6)
    yt, p = torch.from_numpy(y), _torch_params(kw)
    a = tops.hw_scan(yt, p, seasonality=4)
    b = thw._hw_smooth_scan(yt, p, 4, 0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("m,m2,t_len", [(24, 168, 60), (4, 6, 40), (2, 3, 2)])
def test_dual_ring_matches_jax_plain_scan(m, m2, t_len):
    kw, y = _logits(5, m, m2, seed=7), _series(5, t_len, m, seed=8)
    want = jhw.hw_smooth(jnp.asarray(y), _jax_params(kw), seasonality=m,
                         seasonality2=m2, use_pallas=True)   # dual: plain scan
    got = thw.hw_smooth(torch.from_numpy(y), _torch_params(kw), seasonality=m,
                        seasonality2=m2)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("seasonal,dual", [(True, False), (False, False), (True, True)])
def test_hw_step_matches_jax(seasonal, dual):
    rng = np.random.default_rng(9)
    args = [rng.uniform(0.5, 2.0, 11).astype(np.float32) for _ in range(7)]
    want = jhw.hw_step(*args, seasonal=seasonal, dual=dual)
    # numpy in (the server's observe path): the same expression, bit for bit
    got_np = thw.hw_step(*args, seasonal=seasonal, dual=dual)
    got_t = thw.hw_step(*(torch.from_numpy(a) for a in args),
                        seasonal=seasonal, dual=dual)
    for w, g_np, g_t in zip(want, got_np, got_t):
        np.testing.assert_array_equal(np.asarray(g_np), np.asarray(w))
        _close(g_t.numpy(), w)


def test_params_init_and_constrained_match_jax():
    want = jhw.hw_init_params(5, 12, seasonality2=24)
    got = thw.hw_init_params(5, 12, seasonality2=24, device="cpu")
    for f in dataclasses.fields(jhw.HWParams):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)))
    kw = _logits(8, 4, 6, seed=10)
    want_c = _jax_params(kw).constrained()
    got_c = _torch_params(kw).constrained()
    assert sorted(want_c) == sorted(got_c)
    for k in want_c:
        _close(got_c[k].numpy(), want_c[k])


@pytest.mark.parametrize("horizon", [3, 4, 8, 13])
def test_forecast_and_seasonal_extension_match_jax(horizon):
    kw, y = _logits(4, 4, seed=11), _series(4, 20, 4, seed=12)
    lev, seas = thw.hw_smooth(torch.from_numpy(y), _torch_params(kw), seasonality=4)
    lev_j, seas_j = jnp.asarray(lev.numpy()), jnp.asarray(seas.numpy())
    _close(thw.hw_forecast(lev, seas, horizon, seasonality=4).numpy(),
           jhw.hw_forecast(lev_j, seas_j, horizon, seasonality=4))
    _close(thw.extend_seasonality(seas, 20, horizon, 4).numpy(),
           jhw.extend_seasonality(seas_j, 20, horizon, 4))


@pytest.mark.parametrize("m,t_len", [(1, 12), (4, 21)])
def test_loop_reference_matches_jax_loop_and_scan(m, t_len):
    """``hw_smooth_loop_reference``, the per-series float64 loop: the
    reference's loop on the same numpy inputs (both float64) and, within
    float32's rounding, the vectorized scan."""
    kw = _logits(5, m, seed=m)
    y = _series(5, t_len, m, seed=t_len)
    got = thw.hw_smooth_loop_reference(torch.from_numpy(y), _torch_params(kw), seasonality=m)
    want = jhw.hw_smooth_loop_reference(y, _jax_params(kw), seasonality=m)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    scan = thw.hw_smooth(torch.from_numpy(y), _torch_params(kw), seasonality=m)
    for g, s in zip(got, scan):
        _close(s, g)
