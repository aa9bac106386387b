"""The bf16 compute policy on the port's serving path, against the JAX package (CPU).

Under ``precision="bf16"`` the master weights, the per-series HW table, the
levels and the seasonality stay float32; y streams into the HW scan in bf16,
the features, the recurrent stack and the readout's hidden activations are
bf16, every product accumulates in float32 and the readout re-emits
``yhat_n`` in float32 (``src/repro/core/esrnn.py:75-95``).

The JAX package has two bf16 contracts for the LSTM cell: its Pallas
kernel's (float32 gates and activations, one rounding of h' and c') and its
plain path's ``_gates_lowp`` (the gates round to bf16 before the
activations). The port dispatches by device, not by flag, and follows the
kernel's contract on both devices, so every parity here is held against the
JAX package with ``use_pallas=True``: its LSTM-cell kernel in interpret
mode, its HW-scan kernel routed through the kernel's plain JAX reference
(it cannot run in interpret mode on the installed JAX, which has no
``pl.load``). The gap to ``use_pallas=False`` is only reported.

Tolerances and their reasons:

* the plain K1 with a bf16 y: rtol 1e-6 against the JAX scan (the same
  float32 operations on the same widened y) and bit for bit against the
  plain K1 on y widened first (torch's promotion widens y_t exactly);
* the plain K3 in bf16: at most 1 bf16 ulp from the JAX kernel (both sum the
  gates in float32 in another order; one rounding to bf16 can then fall on
  either side);
* the dilated stack, the readout, the states, the forecasts, the
  dispatcher and the server: rtol 2e-2, atol 1e-3 (a 1-ulp bf16 difference
  is 2**-8 relative, and it travels through 229 cell steps and the exp);
* the bf16 forecast against the port's own fp32 forecast: rtol 0.05, atol
  1e-3, as ``tests/core/test_precision.py`` holds the reference.

bf16 training and the bf16 fine-tune are held against the JAX package in
``test_torch_bf16_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import drnn as jdrnn
from repro.core import esrnn as jes
from repro.core import forward as jforward
from repro.core import heads as jheads
from repro.core import holt_winters as jhw
from repro.forecast import serving as jserving
from repro.forecast.server import ForecastServer as JServer
from repro.forecast.server import ServerConfig as JServerConfig
from repro.kernels import hw_scan as jhw_kernel
from repro.kernels import lstm_cell as jlstm
from repro.kernels import ref as jref
from repro_torch.convert import params_from_numpy
from repro_torch.core import drnn as tdrnn
from repro_torch.core import esrnn as tes
from repro_torch.core import forward as tforward
from repro_torch.core import heads as theads
from repro_torch.core import holt_winters as thw
from repro_torch.forecast import BucketDispatcher, synthetic_request_stream
from repro_torch.forecast.server import ForecastServer, ServerConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BF16 = dict(precision="bf16", use_pallas=True)
RTOL, ATOL = 2e-2, 1e-3            # bf16 paths against the JAX package
FP32_RTOL, FP32_ATOL = 0.05, 1e-3  # the bf16 forecast against the fp32 one


@pytest.fixture
def jax_hw_scan_via_reference(monkeypatch):
    """The JAX K1 call routed through its plain JAX reference (see above)."""
    def hw_scan_tm(y_tm, alpha, gamma, init_seas_tm, *, interpret=False):
        levels, seas = jref.hw_scan_ref(y_tm.T, alpha, gamma, init_seas_tm.T)
        return levels.T, seas.T

    monkeypatch.setattr(jhw_kernel, "hw_scan_tm", hw_scan_tm)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return float(np.abs(got - want).max())


def _bf16_np(a):
    """A float32 array rounded to bf16 (round to nearest even), as numpy."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _t(a):
    """A numpy array (bf16 included) as a CPU tensor of its dtype."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


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


# ---------------------------------------------------------------------------
# the policy


def test_compute_dtype_follows_the_reference():
    for precision, want in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tcfg = tes.make_config("quarterly", precision=precision)
        jcfg = jes.make_config("quarterly", precision=precision)
        assert tcfg.compute_dtype == want
        assert str(want).removeprefix("torch.") == str(jcfg.compute_dtype)
        assert tcfg.tdtype == torch.float32          # master dtype unchanged
    with pytest.raises(ValueError, match="unknown precision"):
        _ = tes.make_config("quarterly", precision="fp16").compute_dtype


# ---------------------------------------------------------------------------
# the plain kernels


def _scan_inputs(n, t, m, seed):
    rng = np.random.default_rng(seed)
    y = _bf16_np(rng.uniform(20, 400, (n, t)))
    alpha = rng.uniform(0.05, 0.95, n).astype(np.float32)
    gamma = rng.uniform(0.05, 0.95, n).astype(np.float32)
    init_seas = rng.uniform(0.6, 1.4, (n, m)).astype(np.float32)
    return y, alpha, gamma, init_seas


@pytest.mark.parametrize("n,t,m", [(5, 24, 4), (3, 30, 1), (4, 40, 12)])
def test_plain_hw_scan_with_bf16_y_matches_jax_and_widens_exactly(n, t, m):
    y, alpha, gamma, init_seas = _scan_inputs(n, t, m, seed=n + t)
    ty, ta, tg, ts = (_t(a) for a in (y, alpha, gamma, init_seas))
    assert ty.dtype == torch.bfloat16
    lev, seas = tref.hw_scan_ref(ty, ta, tg, ts)
    # the state and the outputs stay in the parameters' dtype ...
    assert lev.dtype == seas.dtype == torch.float32
    # ... and promoting each y_t is the same as widening y first, bit for bit
    lev32, seas32 = tref.hw_scan_ref(ty.float(), ta, tg, ts)
    assert torch.equal(lev, lev32) and torch.equal(seas, seas32)
    want_lev, want_seas = jref.hw_scan_ref(jnp.asarray(y), jnp.asarray(alpha),
                                           jnp.asarray(gamma), jnp.asarray(init_seas))
    assert want_lev.dtype == jnp.float32
    _close(lev, want_lev, rtol=1e-6, atol=0)
    _close(seas, want_seas, rtol=1e-6, atol=0)


def test_kernel_route_hw_scan_takes_a_bf16_y_on_the_cpu(jax_hw_scan_via_reference):
    n, t = 6, 28
    rng = np.random.default_rng(3)
    y = _bf16_np(rng.uniform(20, 400, (n, t)))
    kw = dict(alpha_logit=rng.normal(0, 0.7, n).astype(np.float32),
              gamma_logit=rng.normal(0, 0.7, n).astype(np.float32),
              init_seas_logit=rng.normal(0, 0.15, (n, 4)).astype(np.float32))
    tops.reset_launch_counts()
    lev, seas = tops.hw_scan(_t(y), thw.HWParams(**{k: _t(v) for k, v in kw.items()}),
                             seasonality=4)
    from repro.kernels import ops as jops
    want = jops.hw_scan(jnp.asarray(y), jhw.HWParams(**{k: jnp.asarray(v) for k, v in kw.items()}),
                        seasonality=4)
    assert lev.dtype == torch.float32
    # the constrained-space transforms (sigmoid, exp) differ at float32's last bit
    _close(lev, want[0], rtol=1e-5, atol=0)
    _close(seas, want[1], rtol=1e-5, atol=0)
    assert tops.launch_counts()["hw_scan_bf16"] == 0        # the plain version ran


def _cell_inputs(rows, in_size, hidden, seed):
    rng = np.random.default_rng(seed)
    u = lambda *s, scale=1.0: _bf16_np(rng.uniform(-scale, scale, s))
    return [u(in_size, 4 * hidden, scale=in_size ** -0.5), u(hidden, 4 * hidden, scale=hidden ** -0.5),
            u(4 * hidden, scale=0.1), u(rows, in_size), u(rows, hidden), u(rows, hidden, scale=2.0)]


@pytest.mark.parametrize("rows,in_size,hidden", [(128, 14, 40), (256, 40, 40), (128, 7, 50)])
def test_plain_lstm_cell_in_bf16_within_one_ulp_of_the_jax_kernel(rows, in_size, hidden):
    args = _cell_inputs(rows, in_size, hidden, seed=rows + hidden)
    got = tref.lstm_cell_ref(*(_t(a) for a in args))
    want = jlstm.lstm_cell_padded(*(jnp.asarray(a) for a in args), interpret=True,
                                  block_b=jlstm.BLOCK_B)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        ulps = tref.bf16_ulps(g, _t(np.asarray(w)))
        assert int(ulps.max()) <= 1, f"{int(ulps.max())} bf16 ulps"


def test_plain_lstm_cell_in_bf16_accumulates_in_float32():
    # a bf16 matmul would round x @ wx and h @ wh to bf16 before adding them;
    # the plain K3 rounds once, after the float32 state update
    args = [_t(a) for a in _cell_inputs(64, 14, 40, seed=1)]
    got = tref.lstm_cell_ref(*args)
    wide = tref.lstm_cell_ref(*(a.float() for a in args))
    for g, w in zip(got, wide):
        assert torch.equal(g, w.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the layers


def _rnn_tree(in_size, hidden, dilations, seed=0):
    rng = np.random.default_rng(seed)
    u = lambda *shape, s: rng.uniform(-s, s, shape).astype(np.float32)
    tree, fan_in = [], in_size
    for block in dilations:
        cells = []
        for _ in block:
            cells.append({"wx": u(fan_in, 4 * hidden, s=fan_in ** -0.5),
                          "wh": u(hidden, 4 * hidden, s=hidden ** -0.5),
                          "b": u(4 * hidden, s=0.1)})
            fan_in = hidden
        tree.append(cells)
    return tree


def _port_tree(tree, key):
    return params_from_numpy({"hw": {"alpha_logit": np.zeros(1, np.float32),
                                     "gamma_logit": np.zeros(1, np.float32),
                                     "init_seas_logit": np.zeros((1, 1), np.float32)},
                              key: tree}, "cpu")[key]


def _bf16_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


@pytest.mark.parametrize("dilations", [((1, 2), (4, 8)), ((1, 3), (6,))])
def test_drnn_in_bf16_matches_jax_kernel_path(dilations):
    b, t, in_size, hidden = 3, 17, 14, 40
    tree = _rnn_tree(in_size, hidden, dilations, seed=5)
    xs = _bf16_np(np.random.default_rng(6).normal(0, 1, (b, t, in_size)))
    want, want_sq = jdrnn.drnn_apply(_bf16_tree(tree), jnp.asarray(xs),
                                     dilations=dilations, use_pallas=True)
    plain, _ = jdrnn.drnn_apply(_bf16_tree(tree), jnp.asarray(xs),
                                dilations=dilations, use_pallas=False)
    with torch.no_grad():       # serving: K3, not the differentiable K4/K5 pair
        rnn = theads._policy_cast(_port_tree(tree, "rnn"), torch.bfloat16)
        got, got_sq = tdrnn.drnn_apply(rnn, _t(xs), dilations=dilations)
    assert got.dtype == torch.bfloat16 and got_sq.dtype == torch.float32
    err = _close(got, want)
    _close(got_sq, want_sq)
    gap = float(np.abs(got.float().numpy() - np.asarray(plain, np.float32)).max())
    print(f"drnn bf16 {dilations}: max err {err:.3g} against use_pallas=True, "
          f"{gap:.3g} against use_pallas=False")


def test_readout_in_bf16_matches_jax():
    hidden, out = 40, 8
    rng = np.random.default_rng(9)
    head = {"dense_w": rng.uniform(-0.2, 0.2, (hidden, hidden)).astype(np.float32),
            "dense_b": rng.uniform(-0.1, 0.1, hidden).astype(np.float32),
            "out_w": rng.uniform(-0.2, 0.2, (hidden, out)).astype(np.float32),
            "out_b": rng.uniform(-0.1, 0.1, out).astype(np.float32)}
    hid = _bf16_np(rng.normal(0, 1, (4, 9, hidden)))
    want = jheads._readout_apply({"head": head}, jnp.asarray(hid))
    with torch.no_grad():
        got = theads._readout_apply({"head": _port_tree(head, "head")}, _t(hid))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32   # re-emitted in fp32
    _close(got, want)


# ---------------------------------------------------------------------------
# the forward pass and the forecasts


_CASES = {                    # name: (preset, n, t, overrides)
    "quarterly": ("quarterly", 4, 32, {}),
    "quarterly_attention": ("quarterly", 3, 24, dict(hidden_size=16, attention=True)),
    "hourly": ("hourly", 2, 60, dict(hidden_size=8, dilations=((1, 4), (24,)))),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_states_and_forecasts_in_bf16_match_jax(case, jax_hw_scan_via_reference):
    preset, n, t, over = _CASES[case]
    jcfg = jes.make_config(preset, **over, **BF16)
    tcfg = tes.make_config(preset, **over, precision="bf16")
    y, cats = _batch(jcfg, n, t)
    jp = _jax_params(jcfg, n)
    tp = params_from_numpy(jp, "cpu")
    jy, jc = jnp.asarray(y), jnp.asarray(cats)
    ty, tc = torch.from_numpy(y), torch.from_numpy(cats)

    with torch.no_grad():
        got = tforward.esrnn_states(tcfg, tp, ty, tc)
    want = jforward.esrnn_states(jcfg, jp, jy, jc)
    assert got.levels.dtype == got.seas.dtype == got.yhat_n.dtype == torch.float32
    errs = {name: _close(getattr(got, name), getattr(want, name))
            for name in ("levels", "seas", "x_in", "yhat_n", "c_sq")}
    fc = tes.esrnn_forecast(tcfg, tp, ty, tc)
    assert fc.dtype == torch.float32 and fc.shape == (n, tcfg.output_size)
    errs["forecast"] = _close(fc, jes.esrnn_forecast(jcfg, jp, jy, jc))
    origins = (t // 2, t)
    errs["forecast_at"] = _close(tes.esrnn_forecast_at(tcfg, tp, ty, tc, origins),
                                 jes.esrnn_forecast_at(jcfg, jp, jy, jc, origins))
    plain = jes.esrnn_forecast(dataclasses.replace(jcfg, use_pallas=False), jp, jy, jc)
    gap = float(np.abs(fc.numpy() - np.asarray(plain)).max())
    print(f"{case} bf16: max abs err {errs} against use_pallas=True; "
          f"forecast {gap:.3g} from use_pallas=False")


@pytest.mark.parametrize("preset,over", [("quarterly", {}),
                                         ("hourly", dict(hidden_size=8, dilations=((1, 4), (24,))))])
def test_bf16_forecast_tracks_the_ports_fp32_forecast(preset, over):
    cfg32 = tes.make_config(preset, **over)
    cfg16 = dataclasses.replace(cfg32, precision="bf16")
    y, cats = _batch(cfg32, 5, 48, seed=2)
    jp = _jax_params(jes.make_config(preset, **over), 5, seed=2)
    tp = params_from_numpy(jp, "cpu")             # one conversion for both policies
    ty, tc = torch.from_numpy(y), torch.from_numpy(cats)
    fc32 = tes.esrnn_forecast(cfg32, tp, ty, tc)
    fc16 = tes.esrnn_forecast(cfg16, tp, ty, tc)
    assert fc16.dtype == torch.float32 and torch.isfinite(fc16).all()
    _close(fc16, fc32.numpy(), rtol=FP32_RTOL, atol=FP32_ATOL)
    mean, sigma = tes.esrnn_predict_stats(cfg16, tp, ty, tc)
    assert torch.isfinite(mean).all() and torch.isfinite(sigma).all()


def test_one_conversion_serves_both_policies(jax_hw_scan_via_reference):
    """A JAX params tree converted once gives parity under fp32 and bf16,
    and serving under bf16 leaves the float32 master weights as they were."""
    over = dict(hidden_size=8, dilations=((1, 2), (4,)))
    jcfg = jes.make_config("quarterly", **over)
    y, cats = _batch(jcfg, 3, 20, seed=4)
    jp = _jax_params(jcfg, 3, seed=4)
    tp = params_from_numpy(jp, "cpu")
    before = [(path, t.clone()) for path, t in tes.param_leaves(tp)]
    ty, tc = torch.from_numpy(y), torch.from_numpy(cats)
    for precision, rtol, atol in (("bf16", RTOL, ATOL), ("fp32", 1e-4, 1e-5)):
        jc = dataclasses.replace(jcfg, precision=precision, use_pallas=True)
        tcfg = tes.make_config("quarterly", **over, precision=precision)
        _close(tes.esrnn_forecast(tcfg, tp, ty, tc),
               jes.esrnn_forecast(jc, jp, jnp.asarray(y), jnp.asarray(cats)),
               rtol=rtol, atol=atol)
    for (path, old), (_, new) in zip(before, tes.param_leaves(tp)):
        assert new.dtype == torch.float32 and torch.equal(old, new), path


# ---------------------------------------------------------------------------
# serving


N_KNOWN = 6
LENGTHS, BATCHES = (16, 32), (2, 4)


@pytest.fixture(scope="module")
def model():
    over = dict(hidden_size=8, dilations=((1, 2), (4,)))
    cfg = jes.make_config("quarterly", **over, **BF16)
    params = jes.esrnn_init(jax.random.PRNGKey(0), cfg, N_KNOWN)
    rng = np.random.default_rng(4)
    params["hw"] = jhw.HWParams(
        alpha_logit=rng.normal(0, 1, N_KNOWN).astype(np.float32),
        gamma_logit=rng.normal(-1, 1, N_KNOWN).astype(np.float32),
        init_seas_logit=rng.normal(0, 0.1, (N_KNOWN, 4)).astype(np.float32))
    jp = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tes.make_config("quarterly", **over, precision="bf16")
    return cfg, jp, tcfg, params_from_numpy(jp, "cpu")


def test_dispatcher_in_bf16_matches_jax(model, jax_hw_scan_via_reference):
    cfg, jp, tcfg, tp = model
    reqs = synthetic_request_stream(tcfg, 9, n_known=N_KNOWN, seed=5, len_range=(9, 40))
    want_d = jserving.BucketDispatcher(cfg, jp, length_buckets=LENGTHS, batch_buckets=BATCHES)
    got_d = BucketDispatcher(tcfg, tp, length_buckets=LENGTHS, batch_buckets=BATCHES,
                             device="cpu")
    want, got = want_d.forecast_batch(reqs), got_d.forecast_batch(reqs)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.float32 and g.shape == (tcfg.output_size,)
        _close(g, w)
    assert got_d.stats.requests == want_d.stats.requests == len(reqs)
    assert got_d.stats.batches == want_d.stats.batches
    assert not any(got_d.stats.kernel_launches.values())        # the CPU: plain versions


def test_server_in_bf16_observe_and_submit_match_jax(model, jax_hw_scan_via_reference):
    cfg, jp, tcfg, tp = model
    buckets = dict(length_buckets=LENGTHS, batch_buckets=BATCHES)
    jsrv = JServer(cfg, jp, server_config=JServerConfig(), **buckets)
    tsrv = ForecastServer(tcfg, tp, server_config=ServerConfig(), device="cpu", **buckets)
    hist = (80.0 * np.exp(np.random.default_rng(2).normal(0, 0.02, 30).cumsum())).astype(np.float32)
    for srv in (jsrv, tsrv):
        for v in hist:
            srv.observe(1, float(v), category=2)
    reqs = synthetic_request_stream(tcfg, 5, n_known=N_KNOWN, seed=8, len_range=(9, 40))
    from repro.forecast import ForecastRequest as JRequest
    from repro_torch.forecast import ForecastRequest

    want_f = [jsrv.submit(JRequest(series_id=1, category=2))] + [
        jsrv.submit(JRequest(y=r.y, category=r.category, series_id=r.series_id)) for r in reqs]
    got_f = [tsrv.submit(ForecastRequest(series_id=1, category=2))] + [
        tsrv.submit(r) for r in reqs]
    jsrv.step(force=True)
    tsrv.step(force=True)
    for g, w in zip(got_f, want_f, strict=True):
        _close(g.result(timeout=0), w.result(timeout=0))
    assert tsrv.stats.observes == jsrv.stats.observes == len(hist)
    assert tsrv.store.get(1).t == len(hist)
