"""Parity of the port's serving stack with the JAX reference, on the CPU.

The same params (the JAX tree converted leaf by leaf) and the same requests
go through ``repro.forecast`` and ``repro_torch.forecast``: the request
stream must be bitwise the same, every forecast must agree to rtol 1e-4 /
atol 1e-5, and the serving counters both packages keep must be equal. The
JAX server's XLA compile counter has no counterpart; the port records
kernel launches instead, which stay 0 on the CPU. The idle fine-tune
(a few sparse-Adam steps when the queue drains) must move the same HW rows
to the same values (atol 1e-5: two sign-like Adam steps from float32
gradients summed in other orders) and leave the same forecasts.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import esrnn as jes
from repro.core import holt_winters as jhw
from repro.forecast import serving as jserving
from repro.forecast.server import ForecastServer as JServer
from repro.forecast.server import ServerConfig as JServerConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import esrnn as tes
from repro_torch.core import holt_winters as thw
from repro_torch.forecast import (
    BucketDispatcher, ForecastRequest, synthetic_request_stream,
)
from repro_torch.forecast.server import (
    ForecastServer, IdleFineTuner, ObserveWrite, OnlineStateStore, QueueFull,
    ServerConfig,
)

RTOL, ATOL = 1e-4, 1e-5
N_KNOWN = 6
LENGTHS, BATCHES = (16, 32), (2, 4)
SHARED_COUNTERS = ("requests", "batches", "compiles", "cache_hits",
                   "padded_series", "truncated_series", "observes",
                   "write_batches", "finetunes", "compile_budget")
NO_LAUNCHES = {"hw_scan": 0, "hw_scan_bf16": 0, "hw_scan_bwd": 0, "hw_scan_bwd_bf16": 0,
               "lstm_cell": 0, "lstm_cell_bf16": 0, "lstm_cell_fwd": 0,
               "lstm_cell_fwd_bf16": 0, "lstm_cell_bwd": 0, "lstm_cell_bwd_bf16": 0,
               "lstm_cell_bwd_dx": 0, "lstm_cell_bwd_dx_bf16": 0,
               "flash_attention": 0, "flash_attention_decode": 0}


@pytest.fixture(scope="module")
def model():
    cfg = jes.make_config("quarterly", hidden_size=8, dilations=((1, 2), (4,)))
    params = jes.esrnn_init(jax.random.PRNGKey(0), cfg, N_KNOWN)
    rng = np.random.default_rng(4)
    params["hw"] = jhw.HWParams(
        alpha_logit=rng.normal(0, 1, N_KNOWN).astype(np.float32),
        gamma_logit=rng.normal(-1, 1, N_KNOWN).astype(np.float32),
        init_seas_logit=rng.normal(0, 0.1, (N_KNOWN, 4)).astype(np.float32))
    jp = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tes.make_config("quarterly", hidden_size=8, dilations=((1, 2), (4,)))
    return cfg, jp, tcfg, params_from_numpy(jp, "cpu")


def _servers(model, **server_kw):
    """The JAX and the port's server on the same params and knobs."""
    cfg, jp, tcfg, tp = model
    buckets = dict(length_buckets=LENGTHS, batch_buckets=BATCHES)
    return (JServer(cfg, jp, server_config=JServerConfig(**server_kw), **buckets),
            ForecastServer(tcfg, tp, server_config=ServerConfig(**server_kw),
                           device="cpu", **buckets))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _same_counters(a, b):
    for name in SHARED_COUNTERS:
        assert getattr(a, name) == getattr(b, name), name


def _series(t, seed):
    rng = np.random.default_rng(seed)
    return (80.0 * np.exp(rng.normal(0, 0.02, t).cumsum())).astype(np.float32)


@pytest.mark.parametrize("n_known,seed", [(0, 0), (6, 3), (1000, 7)])
def test_request_stream_bitwise_equal(n_known, seed):
    cfg = jes.make_config("monthly")
    want = jserving.synthetic_request_stream(cfg, 12, n_known=n_known, seed=seed)
    got = synthetic_request_stream(tes.make_config("monthly"), 12,
                                   n_known=n_known, seed=seed)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.y, w.y)
        assert (g.category, g.series_id) == (w.category, w.series_id)


def test_dispatcher_forecast_batch_matches_jax(model):
    cfg, jp, tcfg, tp = model
    reqs = synthetic_request_stream(tcfg, 9, n_known=N_KNOWN, seed=5, len_range=(9, 40))
    reqs.append(ForecastRequest(y=_series(20, 1), category=99, series_id=-3))
    want_d = jserving.BucketDispatcher(cfg, jp, length_buckets=LENGTHS,
                                       batch_buckets=BATCHES)
    got_d = BucketDispatcher(tcfg, tp, length_buckets=LENGTHS,
                             batch_buckets=BATCHES, device="cpu")
    for _ in range(2):                         # second wave: bucket-shape hits
        want, got = want_d.forecast_batch(reqs), got_d.forecast_batch(reqs)
        for g, w in zip(got, want, strict=True):
            assert g.shape == (tcfg.output_size,)
            _close(g, w)
    _same_counters(got_d.stats, want_d.stats)
    assert got_d.stats.cache_hits > 0
    assert got_d.stats.compiles <= got_d.compile_budget == len(LENGTHS) * len(BATCHES)
    assert got_d.stats.kernel_launches == NO_LAUNCHES


def test_server_submit_observe_step_matches_jax(model):
    jsrv, tsrv = _servers(model)
    cold = N_KNOWN + 40                         # unknown id: the primer row
    for srv in (jsrv, tsrv):
        for k, v in enumerate(_series(30, 2)):
            srv.observe(1, float(v), category=2)
            if k < 12:
                srv.observe(cold, float(v) * 0.5)
        srv.observe(cold, 55.0)
    asks = [ForecastRequest(series_id=1, category=2),
            ForecastRequest(series_id=cold, category=4),
            ForecastRequest(y=_series(11, 3), series_id=0, category=1),
            ForecastRequest(y=_series(25, 4))]
    j_fut = [jsrv.submit(r) for r in asks]
    t_fut = [tsrv.submit(r) for r in asks]
    assert jsrv.step(force=True)[0] == tsrv.step(force=True)[0] == len(asks)
    for g, w in zip(t_fut, j_fut):
        _close(g.result(timeout=30), w.result(timeout=30))
    # read-your-writes: one more observation changes the next forecast
    for srv in (jsrv, tsrv):
        srv.observe(1, 90.0)
    j2, t2 = jsrv.submit(asks[0]), tsrv.submit(asks[0])
    jsrv.drain()
    tsrv.drain()
    _close(t2.result(timeout=30), j2.result(timeout=30))
    assert not np.array_equal(t2.result(), t_fut[0].result())
    assert tsrv.store.get(cold).row == tsrv.dispatcher.n_known
    assert tsrv.store.get(1).t == 31
    _same_counters(tsrv.stats, jsrv.stats)


def test_history_less_request_fails_only_its_future(model):
    _, tsrv = _servers(model)
    fut = tsrv.submit(ForecastRequest(series_id=N_KNOWN + 7))
    ok = tsrv.submit(ForecastRequest(y=_series(20, 6)))
    tsrv.drain()
    with pytest.raises(ValueError, match="no history"):
        fut.result(timeout=30)
    assert np.isfinite(ok.result(timeout=30)).all()


def test_truncation_counted_and_matches_jax(model):
    jsrv, tsrv = _servers(model)
    long_req = [ForecastRequest(y=_series(70, 8), series_id=2, category=3)]
    _close(tsrv.forecast_batch(long_req)[0], jsrv.forecast_batch(long_req)[0])
    assert tsrv.stats.truncated_series == jsrv.stats.truncated_series == 1
    # the served forecast is the forecast of the most recent bucket-length tail
    tail = [ForecastRequest(y=long_req[0].y[-LENGTHS[-1]:], series_id=2, category=3)]
    np.testing.assert_array_equal(tsrv.forecast_batch(tail)[0],
                                  tsrv.forecast_batch(long_req)[0])


def test_threaded_server_deadline_dispatch(model):
    _, tsrv = _servers(model, max_wait_ms=1.0)
    reqs = synthetic_request_stream(tsrv.config, 7, n_known=N_KNOWN, seed=9,
                                    len_range=(10, 30))
    want = BucketDispatcher(tsrv.config, model[3], length_buckets=LENGTHS,
                            batch_buckets=BATCHES, device="cpu").forecast_batch(reqs)
    with tsrv:
        got = [f.result(timeout=60) for f in [tsrv.submit(r) for r in reqs]]
    assert tsrv._thread is None
    for g, w in zip(got, want):
        _close(g, w)      # batches may form differently under the deadline
    lat = tsrv.stats.latency_percentiles()
    assert tsrv.stats.requests == 7 and lat["p50_ms"] <= lat["p99_ms"]


def test_queue_bound_backpressure(model):
    _, tsrv = _servers(model, max_queue=2)
    for _ in range(2):
        tsrv.submit(ForecastRequest(y=_series(20, 0)))
    with pytest.raises(QueueFull):
        tsrv.submit(ForecastRequest(y=_series(20, 0)), timeout=0.01)


def test_finetune_is_not_ported(model):
    """The name dates from the serving slice, when ``finetune_steps > 0``
    raised; the server now builds the fine-tuner on its own device and a
    copy of the params, and leaves the caller's params untouched."""
    tp = model[3]
    before = tp["rnn"][0][0].wx.detach().clone()
    srv = ForecastServer(model[2], tp, device="cpu",
                         server_config=ServerConfig(finetune_steps=2))
    assert isinstance(srv.tuner, IdleFineTuner)
    assert srv.tuner.device == torch.device("cpu")
    assert srv.tuner.params["rnn"][0][0].wx is not tp["rnn"][0][0].wx
    for k, v in enumerate(_series(30, 11)):
        srv.observe(3, float(v), category=1)
    srv.submit(ForecastRequest(series_id=3, category=1))
    srv.drain()
    assert srv.stats.finetunes == 1
    torch.testing.assert_close(tp["rnn"][0][0].wx.detach(), before, rtol=0, atol=0)


def test_idle_finetune_matches_jax(model):
    jsrv, tsrv = _servers(model, finetune_steps=2, finetune_batch=4)
    sids = (0, 2, 3, 5)
    for srv in (jsrv, tsrv):
        for sid in sids:
            for v in _series(24 + sid, 20 + sid):
                srv.observe(sid, float(v), category=sid % 6)
        srv.observe(N_KNOWN + 3, 70.0)             # a cold start: not tuned
    asks = [ForecastRequest(series_id=sid, category=sid % 6) for sid in sids]
    # the first busy period: served before the burst, which fires on drain
    t_before, j_before = tsrv.submit(asks[0]), jsrv.submit(asks[0])
    tsrv.drain()
    jsrv.drain()
    _close(t_before.result(timeout=30), j_before.result(timeout=30))
    assert jsrv.stats.finetunes == tsrv.stats.finetunes == 1
    np.testing.assert_allclose(tsrv.tuner.last_loss, jsrv.tuner.last_loss, rtol=1e-5)
    for name in ("alpha_logit", "gamma_logit", "init_seas_logit"):
        got = getattr(tsrv.dispatcher._hw_table, name)
        want = getattr(jsrv.dispatcher._hw_table, name)
        np.testing.assert_allclose(got[np.arange(N_KNOWN)], want[np.arange(N_KNOWN)],
                                   rtol=0, atol=1e-5, err_msg=name)
    untouched = [r for r in range(N_KNOWN) if r not in sids]
    np.testing.assert_array_equal(tsrv.dispatcher._hw_table.alpha_logit[untouched],
                                  model[1]["hw"].alpha_logit[untouched])
    t_fut = [tsrv.submit(r) for r in asks]
    j_fut = [jsrv.submit(r) for r in asks]
    tsrv.drain()
    jsrv.drain()
    for g, w in zip(t_fut, j_fut):
        _close(g.result(timeout=30), w.result(timeout=30))
    assert not np.array_equal(t_fut[0].result(), t_before.result())
    _same_counters(tsrv.stats, jsrv.stats)


@pytest.mark.parametrize("freq,t_len", [("yearly", 21), ("quarterly", 33), ("hourly", 200)])
def test_rolled_state_matches_from_scratch_scan(freq, t_len):
    cfg = tes.make_config(freq, hidden_size=8, dilations=((1,),))
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 3, device="cpu")
    store = OnlineStateStore(cfg, lambda: params["hw"], 3, history_cap=16)
    m = max(cfg.seasonality, 1)
    y = _series(t_len, 10) * np.tile(np.exp(np.linspace(-0.1, 0.1, m)), t_len)[:t_len]
    st = store.seed(1, y.astype(np.float32), row=1)
    row = params["hw"].map(lambda a: a[1:2])
    levels, seas = thw.hw_smooth(torch.from_numpy(y.astype(np.float32))[None], row,
                                 seasonality=cfg.seasonality,
                                 seasonality2=cfg.seasonality2)
    np.testing.assert_allclose(np.float32(st.level), levels[0, -1].numpy(), rtol=1e-6)
    np.testing.assert_allclose(st.future_seasonal(m), seas[0, t_len:].numpy(), rtol=1e-6)
    assert st.truncated and len(st.history) == 16 and st.t == t_len


def test_vectorized_absorb_equals_scalar_rolls(model):
    tcfg, tp = model[2], model[3]
    stores = [OnlineStateStore(tcfg, lambda: tp["hw"], N_KNOWN, history_cap=64)
              for _ in range(2)]
    for store in stores:
        for sid in range(4):
            store.seed(sid, _series(20, sid), row=sid)
    writes = [ObserveWrite(sid, 100.0 + sid) for sid in range(4)]
    stores[0].absorb(writes, resolve_row=int)
    for w in writes:
        stores[1].absorb([w], resolve_row=int)
    for sid in range(4):
        a, b = stores[0].get(sid), stores[1].get(sid)
        assert np.float32(a.level) == np.float32(b.level)
        np.testing.assert_array_equal(a.s_ring, b.s_ring)


@pytest.mark.parametrize("budget", [64, 1])
def test_compile_budget_parity(budget):
    """P3: ``ServerConfig(compile_budget=)`` on both servers from one
    config: both pass the check, or both raise. The JAX server counts the
    XLA compiles of its dispatches, the port its distinct bucket shapes; a
    width of this test's own keeps the JAX compiles fresh."""
    from repro.analysis.recompile import CompileBudgetExceeded as JExceeded
    from repro_torch.forecast.serving import CompileBudgetExceeded

    hidden = 5 if budget > 1 else 7
    cfg = jes.make_config("quarterly", hidden_size=hidden, dilations=((1, 2), (4,)))
    jp = jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(1), cfg, N_KNOWN))
    tcfg = tes.make_config("quarterly", hidden_size=hidden, dilations=((1, 2), (4,)))
    buckets = dict(length_buckets=LENGTHS, batch_buckets=BATCHES)
    jsrv = JServer(cfg, jp, server_config=JServerConfig(compile_budget=budget), **buckets)
    tsrv = ForecastServer(tcfg, params_from_numpy(jp, "cpu"), device="cpu",
                          server_config=ServerConfig(compile_budget=budget), **buckets)
    reqs = synthetic_request_stream(tcfg, 11, n_known=N_KNOWN, seed=3, len_range=(12, 30))
    for srv in (jsrv, tsrv):
        srv.forecast_batch(reqs)
        assert srv.stats.compile_budget == budget
    outcomes = []
    for srv, exceeded in ((jsrv, JExceeded), (tsrv, CompileBudgetExceeded)):
        try:
            outcomes.append(("pass", srv.check_compile_budget()))
        except exceeded as e:
            outcomes.append(("raise", str(e)))
    assert outcomes[0][0] == outcomes[1][0] == ("pass" if budget > 1 else "raise"), outcomes
    if budget > 1:
        assert outcomes[1][1] == tsrv.stats.compiles >= 2
    assert issubclass(CompileBudgetExceeded, AssertionError)
