"""The port's esn and ssm heads against the JAX package's, on the CPU.

The same numpy inputs (made from a seed) and the same weights (the JAX init
converted leaf by leaf, ``repro_torch.convert``) go through both packages:

* the registry, ``frozen_param_groups`` and ``ssm_dims`` equal to JAX's;
* the init structure (``param_leaves`` paths, shapes and dtypes) under the
  fp32 and bf16 policies and in a bf16 weight dtype;
* each head's forecasts per preset, rtol 1e-4 / atol 1e-5 (the whole pass:
  sums in other orders, then through ``exp``), against JAX with
  ``use_pallas`` False and True (the JAX HW-scan Pallas kernel routed
  through its plain reference, ROADMAP F3); under bf16 within rtol 2e-2 /
  atol 1e-3 of JAX's bf16 forecasts;
* the esn forecast equal to the lstm-without-attention forecast on the same
  weights, bit for bit (the reference's ``tests/core/test_heads.py``);
* the loss and the gradients of the trainable leaves against
  ``jax.value_and_grad`` (loss rtol 1e-5, gradients atol 1e-6), and 12-step
  ``train_esrnn`` trajectories, dense and sparse, against JAX (losses rtol
  1e-5);
* the esn reservoir bit-identical after a fit and after an idle fine-tune,
  and the plain dx-only K5 the one its backward takes (a spy on the plain
  versions); a ``gradcheck`` of ``LSTMCell`` with weights that need no
  gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esrnn as jes
from repro.core import heads as jheads
from repro.data import pipeline as jpipe
from repro.kernels import hw_scan as jhw_kernel
from repro.kernels import ref as jref
from repro.train import trainer as jtrainer
from repro_torch.convert import params_from_numpy
from repro_torch.core import esrnn as tes
from repro_torch.core import heads as theads
from repro_torch.core.esrnn import param_leaves
from repro_torch.data import pipeline as tpipe
from repro_torch.forecast import ForecastRequest
from repro_torch.forecast.server import ForecastServer, ServerConfig
from repro_torch.kernels import lstm_cell as tlstm
from repro_torch.kernels import ref as tref
from repro_torch.train import trainer as ttrainer

RTOL, ATOL = 1e-4, 1e-5
BF16_RTOL, BF16_ATOL = 2e-2, 1e-3
HEADS = ("esn", "ssm")
PRESETS = ("yearly", "quarterly", "monthly", "hourly")


def _batch(cfg, n, t, seed=0):
    rng = np.random.default_rng(seed)
    m = max(cfg.seasonality, 1)
    seas = np.tile(np.exp(rng.normal(0, 0.1, (n, m))), (1, t // m + 1))[:, :t]
    y = 50.0 * np.exp(rng.normal(0, 0.03, (n, t)).cumsum(axis=1)) * seas
    cats = np.eye(cfg.n_categories, dtype=np.float32)[rng.integers(0, cfg.n_categories, n)]
    return y.astype(np.float32), cats


def _jax_params(cfg, n, seed=0):
    """The JAX init, its per-series HW logits and the ssm head's float32
    parameters perturbed (numpy, from a seed), as numpy leaves."""
    params = jes.esrnn_init(jax.random.PRNGKey(seed), cfg, n)
    params = jax.tree_util.tree_map(np.array, params)      # writable copies
    rng = np.random.default_rng(seed + 100)
    hw = params["hw"]
    hw.alpha_logit[:] = rng.normal(0, 1, n)
    hw.gamma_logit[:] = rng.normal(-1, 1, n)
    if hw.init_seas_logit is not None:
        hw.init_seas_logit[:] = rng.normal(0, 0.1, hw.init_seas_logit.shape)
    if "ssm" in params:
        for k in ("a_log", "dt_bias", "d_skip"):
            params["ssm"][k] = (params["ssm"][k]
                                + rng.normal(0, 0.3, params["ssm"][k].shape).astype(np.float32))
    return params


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.fixture
def jax_hw_scan_via_reference(monkeypatch):
    def hw_scan_tm(y_tm, alpha, gamma, init_seas_tm, *, interpret=False):
        levels, seas = jref.hw_scan_ref(y_tm.T, alpha, gamma, init_seas_tm.T)
        return levels.T, seas.T

    monkeypatch.setattr(jhw_kernel, "hw_scan_tm", hw_scan_tm)
    jax.clear_caches()
    yield
    jax.clear_caches()


# -- the registry and the structure ---------------------------------------------


def test_registry_and_frozen_groups_match_jax():
    assert theads.available_heads() == jheads.available_heads() == ("esn", "lstm", "ssm")
    for head in theads.available_heads():
        jcfg, tcfg = jes.make_config("quarterly", head=head), tes.make_config("quarterly", head=head)
        assert theads.frozen_param_groups(tcfg) == jheads.frozen_param_groups(jcfg)
    assert theads.get_head("esn").frozen == frozenset({"rnn"})
    with pytest.raises(KeyError, match="unknown forecasting head"):
        theads.get_head("gru")


@pytest.mark.parametrize("hidden", [1, 7, 8, 16, 30, 40, 50, 64, 120])
def test_ssm_dims_match_jax(hidden):
    for preset in PRESETS:
        jcfg = jes.make_config(preset, head="ssm", hidden_size=hidden)
        tcfg = tes.make_config(preset, head="ssm", hidden_size=hidden)
        assert theads.ssm_dims(tcfg) == jheads.ssm_dims(jcfg)
    assert theads.ssm_dims(tes.make_config("quarterly", head="ssm")) == (5, 8)


@pytest.mark.parametrize("policy", [dict(), dict(precision="bf16"), dict(dtype="bfloat16")])
@pytest.mark.parametrize("head", HEADS)
def test_init_structure_matches_jax(head, policy):
    jcfg = jes.make_config("quarterly", head=head, attention=True, **policy)
    tcfg = tes.make_config("quarterly", head=head, attention=True, **policy)
    jp = jes.esrnn_init(jax.random.PRNGKey(0), jcfg, 5)
    tp = tes.esrnn_init(torch.Generator().manual_seed(0), tcfg, 5, device="cpu")
    j_paths = [tuple(getattr(k, "key", getattr(k, "name", getattr(k, "idx", None))) for k in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    t_leaves = param_leaves(tp)
    assert [path for path, _ in t_leaves] == j_paths
    for (path, t), j in zip(t_leaves, jax.tree_util.tree_leaves(jp)):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
    assert "attn" not in tp                    # attention is not part of either head


# -- forecasts --------------------------------------------------------------------


def _forecasts(jcfg, tcfg, n, t, seed=0):
    y, cats = _batch(jcfg, n, t, seed)
    jp = _jax_params(jcfg, n, seed)
    tp = params_from_numpy(jp, "cpu")
    jy, jc = jnp.asarray(y), jnp.asarray(cats)
    ty, tc = torch.from_numpy(y), torch.from_numpy(cats)
    origins = (t - 7, t)
    got = (tes.esrnn_forecast(tcfg, tp, ty, tc),
           tes.esrnn_forecast_at(tcfg, tp, ty, tc, origins))
    want = (jes.esrnn_forecast(jcfg, jp, jy, jc), jes.esrnn_forecast_at(jcfg, jp, jy, jc, origins))
    return got, want


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("head", HEADS)
def test_forecasts_match_jax_plain(head, preset):
    kw = dict(head=head, hidden_size=8)
    if preset == "hourly":
        kw["dilations"] = ((1, 4), (24,))
    t = 200 if preset == "hourly" else 48
    got, want = _forecasts(jes.make_config(preset, **kw), tes.make_config(preset, **kw), 5, t)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w)


@pytest.mark.parametrize("head", HEADS)
def test_forecasts_match_jax_full_quarterly_width(head):
    """hidden 40, dilations ((1, 2), (4, 8)); the ssm head 5 heads of 8, and
    P = 41 positions padded to two chunks of 32."""
    got, want = _forecasts(jes.make_config("quarterly", head=head),
                           tes.make_config("quarterly", head=head), 4, 48)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("head", HEADS)
def test_forecasts_match_jax_pallas(head, jax_hw_scan_via_reference):
    kw = dict(head=head, hidden_size=8)
    got, want = _forecasts(jes.make_config("quarterly", use_pallas=True, **kw),
                           tes.make_config("quarterly", **kw), 3, 40)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("head", HEADS)
def test_bf16_forecasts_match_jax(head, jax_hw_scan_via_reference):
    kw = dict(head=head, hidden_size=16, precision="bf16")
    got, want = _forecasts(jes.make_config("quarterly", use_pallas=True, **kw),
                           tes.make_config("quarterly", **kw), 4, 44)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, BF16_RTOL, BF16_ATOL)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_esn_forecast_is_the_lstm_forecast_without_attention(precision):
    esn = tes.make_config("quarterly", head="esn", hidden_size=8, precision=precision)
    lstm = tes.make_config("quarterly", hidden_size=8, precision=precision)
    params = tes.esrnn_init(torch.Generator().manual_seed(3), esn, 6, device="cpu")
    again = tes.esrnn_init(torch.Generator().manual_seed(3), lstm, 6, device="cpu")
    for (pa, a), (pb, b) in zip(param_leaves(params), param_leaves(again), strict=True):
        assert pa == pb and torch.equal(a, b)           # the same draws
    y, cats = _batch(esn, 6, 40, seed=2)
    ty, tc = torch.from_numpy(y), torch.from_numpy(cats)
    assert torch.equal(tes.esrnn_forecast(esn, params, ty, tc),
                       tes.esrnn_forecast(lstm, params, ty, tc))


# -- training ---------------------------------------------------------------------


def _trainable(params, head):
    frozen = theads.get_head(head).frozen
    return [(path, t) for path, t in param_leaves(params) if path[0] not in frozen]


@pytest.mark.parametrize("head", HEADS)
def test_loss_and_trainable_grads_match_jax(head, monkeypatch):
    kw = dict(head=head, hidden_size=8, level_penalty=0.3, cstate_penalty=0.2)
    jcfg, tcfg = jes.make_config("quarterly", **kw), tes.make_config("quarterly", **kw)
    d = tpipe.synthetic_prepared(5, series_length=30, seed=4)
    mask = d.mask.copy()
    mask[0, :5] = 0.0                              # a left-padded series
    jp = _jax_params(jcfg, 5, seed=2)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jes.esrnn_loss(jcfg, p, d.train, d.cats, mask))(jp)
    want = dict(zip([tuple(getattr(k, "key", getattr(k, "name", getattr(k, "idx", None)))
                           for k in path)
                     for path, _ in jax.tree_util.tree_flatten_with_path(want_grads)[0]],
                    jax.tree_util.tree_leaves(want_grads)))
    tp = params_from_numpy(jp, "cpu")
    leaves = _trainable(tp, head)
    for _, p in param_leaves(tp):
        p.requires_grad_(False)
    for _, p in leaves:
        p.requires_grad_(True)
    calls = {"dx": 0, "full": 0}
    dx_ref, full_ref = tref.lstm_cell_bwd_dx_ref, tref.lstm_cell_bwd_ref

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tref, "lstm_cell_bwd_dx_ref", spy("dx", dx_ref))
    monkeypatch.setattr(tref, "lstm_cell_bwd_ref", spy("full", full_ref))
    loss, grads = tes.value_and_grad(
        lambda: tes.esrnn_loss_fn(tcfg, tp, torch.from_numpy(d.train),
                                  torch.from_numpy(d.cats), torch.from_numpy(mask)),
        [t for _, t in leaves])
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for (path, _), g in zip(leaves, grads, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]), rtol=0, atol=1e-6,
                                   err_msg=str(path))
    # the esn reservoir's backward is the dx-only K5, once a cell step
    if head == "esn":
        assert calls["dx"] > 0 and calls["full"] == 0
    else:
        assert calls == {"dx": 0, "full": 0}


N_SERIES, T_LEN, BATCH, STEPS = 12, 24, 8, 12


@pytest.fixture(scope="module")
def data():
    return tpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)


def _train_cfg(cls, sparse):
    return cls(batch_size=BATCH, n_steps=STEPS, eval_every=6, ckpt_every=1000, seed=3,
               sparse_adam=sparse)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("head", HEADS)
def test_train_trajectory_matches_jax(data, head, sparse):
    jcfg = jes.make_config("quarterly", head=head, hidden_size=8)
    tcfg = tes.make_config("quarterly", head=head, hidden_size=8)
    jdata = jpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)
    init = jax.tree_util.tree_map(np.asarray,
                                  jes.esrnn_init(jax.random.PRNGKey(1), jcfg, N_SERIES))
    want = jtrainer.train_esrnn(jcfg, jdata, _train_cfg(jtrainer.TrainConfig, sparse),
                                params=init)
    got = ttrainer.train_esrnn(tcfg, data, _train_cfg(ttrainer.TrainConfig, sparse),
                               params=params_from_numpy(init, "cpu"), device="cpu")
    np.testing.assert_allclose(got["history"]["loss"], want["history"]["loss"], rtol=1e-5)
    np.testing.assert_allclose([v for _, v in got["history"]["val_smape"]],
                               [v for _, v in want["history"]["val_smape"]], rtol=1e-5)
    for g, w in zip([t.detach().numpy() for _, t in param_leaves(got["params"])],
                    jax.tree_util.tree_leaves(want["params"]), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
    # the moments cover the trainable subtree only, as JAX's do
    n_train = len(_trainable(got["params"], head))
    assert len(got["opt_state"]["mu"]) == n_train == len(
        jax.tree_util.tree_leaves(want["opt_state"]["mu"]))
    if head == "esn":                           # the reservoir: the init, bit for bit
        for (path, t), (_, t0) in zip(param_leaves(got["params"]),
                                      param_leaves(params_from_numpy(init, "cpu"))):
            if path[0] == "rnn":
                assert torch.equal(t, t0), path
                assert t.requires_grad              # given back as it came


def test_finetune_keeps_the_reservoir():
    cfg = tes.make_config("quarterly", head="esn", hidden_size=8, dilations=((1, 2), (4,)))
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 6, device="cpu")
    before = [t.detach().clone() for _, t in param_leaves(params)]
    srv = ForecastServer(cfg, params, device="cpu", server_config=ServerConfig(
        finetune_steps=3, finetune_batch=4))
    rng = np.random.default_rng(1)
    for sid in (0, 2, 3):
        for v in 100.0 * np.exp(rng.normal(0, 0.02, 30).cumsum()):
            srv.observe(sid, float(v), category=sid % 6)
    srv.submit(ForecastRequest(series_id=0, category=0))
    srv.drain()
    assert srv.stats.finetunes == 1
    tuned = param_leaves(srv.tuner.params)
    moved = {path[0] for (path, t), t0 in zip(tuned, before) if not torch.equal(t, t0)}
    assert moved == {"hw", "head"}              # the readout and the HW rows train
    for (path, t), t0 in zip(tuned, before):
        if path[0] == "rnn":
            assert torch.equal(t, t0), path


def test_lstm_cell_gradcheck_without_weight_gradients(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    r = lambda *s, grad=False: torch.randn(s, generator=gen, dtype=torch.float64,
                                           requires_grad=grad)
    wx, wh, b = r(3, 8), r(2, 8), r(8)
    x, h, c = r(4, 3, grad=True), r(4, 2, grad=True), r(4, 2, grad=True)
    calls = []
    dx_ref = tref.lstm_cell_bwd_dx_ref
    monkeypatch.setattr(tref, "lstm_cell_bwd_dx_ref", lambda *a: calls.append(1) or dx_ref(*a))
    assert torch.autograd.gradcheck(
        lambda x, h, c: tlstm.LSTMCell.apply(wx, wh, b, x, h, c), (x, h, c))
    assert calls
    hn, cn = tlstm.LSTMCell.apply(wx, wh, b, x, h, c)
    # the same inputs through the full backward give the same dx, dh_prev, dc_prev
    wxg = wx.clone().requires_grad_(True)
    full = torch.autograd.grad(
        sum(o.sum() for o in tlstm.LSTMCell.apply(wxg, wh, b, x, h, c)), (x, h, c))
    part = torch.autograd.grad(sum(o.sum() for o in (hn, cn)), (x, h, c))
    for f, p in zip(full, part):
        assert torch.equal(f, p)
