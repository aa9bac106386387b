"""The port's out-of-core chunked fit, on the CPU, against the JAX package's.

At the reference test's size (``tests/train/test_chunked.py``: hidden 8,
N = 19, chunk 16, batch 8, 24 steps in supersteps of 4, eval every 12),
both packages on their plain paths, the weights from one JAX init
converted leaf by leaf. (The JAX package's streamed fit cannot start from a
given params tree -- it copies each shared subtree with ``jnp.array``,
which refuses a dict -- so it draws its init from the seed, and the port is
given that init, ``esrnn_init(PRNGKey(0), cfg, N)``: its shared weights are
the 1-row init's and its table the primer.)

* the port's streamed fit against JAX's ``_train_chunked``: per-step
  losses rtol 1e-5, final params and optimizer state atol 1e-5, val sMAPE
  rtol 1e-5 (the bounds of ``tests/test_torch_train.py``), for a ragged
  two-chunk cut and for one chunk holding every series (the same-rows
  hand-over);
* the streamed fit equal to the port's own ``chunk_resident`` fit bit for
  bit (the schedule and the per-row clocks make the streaming a change of
  memory placement only), the two drawing the same shared weights from one
  generator; a resume at step 12 equal to the unbroken run bit for bit;
* checkpoints moving between the packages and the modes: a chunked fit's
  row-sharded checkpoint resumed by a resident fit and the other way round,
  both ways between the packages;
* the entry rules (``compress_grads`` refused, ``sparse_adam`` implied,
  ``data_parallel`` still a later slice), the esn head chunked (the
  reservoir unchanged, the plain dx-only K5 taken), the estimator's chunked
  ``predict``/``predict_quantiles``/``evaluate``/``backtest`` against its
  resident ones (the reference test's bounds), a saved chunked estimator,
  and the CLI's ``fit``/``predict`` with ``--set series_chunk=8``.
"""

import dataclasses
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import esrnn as jes
from repro.data import pipeline as jpipe
from repro.train import trainer as jtrainer
from repro_torch.convert import params_from_numpy
from repro_torch.core import esrnn as tes
from repro_torch.core.esrnn import param_leaves
from repro_torch.data import pipeline as tpipe
from repro_torch.forecast import ESRNNForecaster, get_smoke_spec
from repro_torch.kernels import ref as tref
from repro_torch.launch import forecast as cli
from repro_torch.train import trainer as ttrainer
from repro_torch.train.host_table import HostStateTable

N, T_LEN = 19, 24
MODEL = dict(hidden_size=8)
RTOL, ATOL = 1e-5, 1e-5


def _cfg(cls, **over):
    base = dict(batch_size=8, n_steps=24, scan_steps=4, sparse_adam=True,
                series_chunk=16, eval_every=12, ckpt_every=1000, seed=0,
                straggler_factor=float("inf"))
    base.update(over)
    return cls(**base)


def _data(mod, n=N):
    return mod.synthetic_prepared(n, seasonality=4, horizon=8, series_length=T_LEN)


@pytest.fixture(scope="module")
def init():
    cfg = jes.make_config("quarterly", **MODEL)
    return jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(0), cfg, N))


def _torch_fit(init=None, head="lstm", **over):
    params = None if init is None else params_from_numpy(init, "cpu")
    return ttrainer.train_esrnn(tes.make_config("quarterly", head=head, **MODEL),
                                _data(tpipe), _cfg(ttrainer.TrainConfig, **over),
                                params=params, device="cpu",
                                generator=torch.Generator().manual_seed(5))


def _jax_fit(init, **over):
    """The JAX fit from ``init``: passed in, or, for its streamed fit, drawn
    from the seed (0: the same init)."""
    cfg = _cfg(jtrainer.TrainConfig, **over)
    return jtrainer.train_esrnn(jes.make_config("quarterly", **MODEL), _data(jpipe), cfg,
                                params=init if cfg.chunk_resident else None)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _state_leaves(out):
    """Params then the optimizer state, leaf for leaf in the JAX tree's order."""
    opt = out["opt_state"]
    return ([_np(t) for _, t in param_leaves(out["params"])] + [_np(t) for t in opt["mu"]]
            + [_np(t) for t in opt["nu"]] + [np.asarray(opt["step"]), _np(opt["t_hw"])])


def _jax_state_leaves(out):
    opt = out["opt_state"]
    return ([np.asarray(a) for a in jax.tree_util.tree_leaves(out["params"])]
            + [np.asarray(a) for a in jax.tree_util.tree_leaves(opt["mu"])]
            + [np.asarray(a) for a in jax.tree_util.tree_leaves(opt["nu"])]
            + [np.asarray(opt["step"]), np.asarray(opt["t_hw"])])


def _assert_same(a, b):
    for x, y in zip(_state_leaves(a), _state_leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chunk", [16, 32])
def test_stream_matches_jax(init, chunk):
    got = _torch_fit(init, series_chunk=chunk)
    want = _jax_fit(init, series_chunk=chunk)
    np.testing.assert_allclose(got["history"]["loss"], want["history"]["loss"], rtol=RTOL)
    (g_steps, g_vs), (w_steps, w_vs) = (zip(*got["history"]["val_smape"]),
                                        zip(*want["history"]["val_smape"]))
    assert g_steps == w_steps == (12, 24)
    np.testing.assert_allclose(g_vs, w_vs, rtol=RTOL)
    for g, w in zip(_state_leaves(got), _jax_state_leaves(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    # the streamed fit hands back a host table, as the reference's numpy one
    assert all(t.device.type == "cpu" for _, t in param_leaves({"hw": got["params"]["hw"]}))
    assert got["opt_state"]["step"] == 24


@pytest.mark.parametrize("chunk,scan_steps", [(16, 4), (16, 1), (8, 4), (32, 4)])
def test_stream_equals_chunk_resident(chunk, scan_steps):
    """Bit for bit, from the same generator: the chunked fit's 1-row init
    draws the resident init's shared weights (the HW primer draws nothing)."""
    stream = _torch_fit(series_chunk=chunk, scan_steps=scan_steps)
    resident = _torch_fit(series_chunk=chunk, scan_steps=scan_steps, chunk_resident=True)
    assert stream["history"]["loss"] == resident["history"]["loss"]
    assert len(stream["history"]["loss"]) == 24
    _assert_same(stream, resident)
    (_, vs_s), (_, vs_r) = stream["history"]["val_smape"][-1], resident["history"]["val_smape"][-1]
    np.testing.assert_allclose(vs_s, vs_r, rtol=RTOL)   # chunk terms vs one mean
    cfg = tes.make_config("quarterly", **MODEL)
    one = tes.esrnn_init(torch.Generator().manual_seed(5), cfg, 1, device="cpu")
    full = tes.esrnn_init(torch.Generator().manual_seed(5), cfg, N, device="cpu")
    for (path, a), (_, b) in zip(param_leaves(one), param_leaves(full)):
        if path[0] != "hw":
            assert torch.equal(a, b), path


def test_resume_bit_exact(tmp_path):
    straight = _torch_fit()
    d = str(tmp_path / "stream")
    _torch_fit(n_steps=12, ckpt_dir=d)
    assert any(".shard_" in f for f in os.listdir(os.path.join(d, "step_12")))
    resumed = _torch_fit(ckpt_dir=d)
    assert resumed["resumed_from"] == 12
    assert resumed["history"]["loss"] == straight["history"]["loss"][12:]
    _assert_same(resumed, straight)


# (writer package, writer chunked?, reader package, reader chunked?)
CROSS = [("torch", True, "torch", False), ("torch", False, "torch", True),
         ("torch", True, "jax", False), ("jax", True, "torch", False),
         ("torch", False, "jax", True), ("jax", False, "torch", True)]


@pytest.mark.parametrize("writer,w_chunked,reader,r_chunked", CROSS)
def test_checkpoints_move_between_modes_and_packages(init, tmp_path, writer, w_chunked,
                                                     reader, r_chunked):
    fit = {"torch": _torch_fit, "jax": _jax_fit}
    d = str(tmp_path / "ckpt")
    fit[writer](init, n_steps=12, ckpt_dir=d, chunk_resident=not w_chunked)
    sharded = any(".shard_" in f for f in os.listdir(os.path.join(d, "step_12")))
    assert sharded == w_chunked
    out = fit[reader](init, ckpt_dir=d, chunk_resident=not r_chunked)
    assert out["resumed_from"] == 12
    want = _torch_fit(init)
    if writer == reader == "torch":
        _assert_same(out, want)
        return
    got = _state_leaves(out) if reader == "torch" else _jax_state_leaves(out)
    for g, w in zip(got, _state_leaves(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_entry_rules(caplog):
    with pytest.raises(ValueError, match="sparse"):
        _torch_fit(compress_grads=True, sparse_adam=False)
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        out = _torch_fit(n_steps=4, sparse_adam=False)
    assert "enabling sparse per-series Adam" in caplog.text
    assert "streaming chunked fit" in caplog.text
    assert len(out["history"]["loss"]) == 4 and "t_hw" in out["opt_state"]
    # over a mesh: tests/test_torch_dp.py; with no process group,
    # data_parallel raises in either chunked mode
    for kw in (dict(data_parallel=2), dict(chunk_resident=True, data_parallel=2)):
        with pytest.raises(ValueError, match="process group"):
            _torch_fit(**kw)


def test_host_table_streams_copies():
    """On the CPU a slice is a copy: training it leaves the table as it was
    until ``absorb`` writes it back."""
    table = HostStateTable.init(10, 4, device="cpu")
    rows = table.device_slice(2, 6, (torch.arange(10.0)[2:6],)).wait()
    assert rows.stream is None and rows.done is None
    rows.state["hw"].alpha_logit += 1.0
    rows.state["t_hw"][:] = 7
    assert float(table.hw.alpha_logit[3]) == 0.0 and int(table.t_hw[3]) == 0
    torch.testing.assert_close(rows.extra[0], torch.arange(2.0, 6.0))
    table.absorb(2, 6, rows.state)
    assert float(table.hw.alpha_logit[3]) == 1.0 and int(table.t_hw[5]) == 7
    assert int(table.t_hw[6]) == 0
    hw_only = table.device_slice(0, 3, moments=False)
    assert set(hw_only.state) == {"hw"}
    with pytest.raises(ValueError, match="snapshot"):
        HostStateTable.from_hw(table.hw).device_slice(0, 1)


def test_esn_head_chunked(monkeypatch):
    calls = {"dx": 0, "full": 0}
    dx_ref, full_ref = tref.lstm_cell_bwd_dx_ref, tref.lstm_cell_bwd_ref

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tref, "lstm_cell_bwd_dx_ref", spy("dx", dx_ref))
    monkeypatch.setattr(tref, "lstm_cell_bwd_ref", spy("full", full_ref))
    stream = _torch_fit(head="esn", n_steps=12)
    assert calls["dx"] > 0 and calls["full"] == 0
    resident = _torch_fit(head="esn", n_steps=12, chunk_resident=True)
    assert stream["history"]["loss"] == resident["history"]["loss"]
    _assert_same(stream, resident)
    cfg = tes.make_config("quarterly", head="esn", **MODEL)
    start = tes.esrnn_init(torch.Generator().manual_seed(5), cfg, N, device="cpu")
    reservoir = [(p, t) for p, t in param_leaves(stream["params"]) if p[0] == "rnn"]
    assert reservoir
    for (path, got), (_, want) in zip(reservoir,
                                      [lf for lf in param_leaves(start) if lf[0][0] == "rnn"]):
        assert torch.equal(got, want), path
    # the moments cover the trainable subtree only (no reservoir leaves)
    assert len(stream["opt_state"]["mu"]) == len(param_leaves(stream["params"])) - len(reservoir)


@pytest.fixture(scope="module")
def estimators():
    spec = get_smoke_spec("esrnn-quarterly", n_steps=8, batch_size=8, series_chunk=8,
                          sparse_adam=True, scan_steps=4, **MODEL)
    f = ESRNNForecaster(spec, device="cpu").fit(_data(tpipe))
    assert f.n_series_ == N > spec.series_chunk
    res = ESRNNForecaster(spec.replace(series_chunk=0), device="cpu")
    res.params_, res.n_series_, res.data_, res.cats_ = f.params_, f.n_series_, f.data_, f.cats_
    return f, res


def test_estimator_chunked_inference_matches_resident(estimators):
    f, res = estimators
    assert f.params_["hw"].alpha_logit.device.type == "cpu"
    np.testing.assert_allclose(f.predict(), res.predict(), atol=1e-6)
    bands, want_bands = f.predict_quantiles(), res.predict_quantiles()
    for tau in want_bands:
        np.testing.assert_allclose(bands[tau], want_bands[tau], atol=1e-6)
    ev_c, ev_r = f.evaluate(), res.evaluate()
    for key in ("smape", "mase", "smape_comb", "mase_comb", "smape_naive2", "mase_naive2",
                "owa"):
        np.testing.assert_allclose(ev_c[key], ev_r[key], rtol=1e-5, err_msg=key)
    bt_c, bt_r = f.backtest(origins=(20, 24)), res.backtest(origins=(20, 24))
    np.testing.assert_allclose(bt_c["forecasts"], bt_r["forecasts"], atol=1e-6)
    for oc, orr in zip(bt_c["per_origin"], bt_r["per_origin"]):
        np.testing.assert_allclose(oc["smape"], orr["smape"], rtol=1e-5)
        np.testing.assert_allclose(oc["mase"], orr["mase"], rtol=1e-5)
    # a subset by series_idx takes its rows from the host table
    np.testing.assert_allclose(f.predict(f.data_.train[[3, 17]], series_idx=[3, 17]),
                               res.predict()[[3, 17]], atol=1e-6)


def test_saved_chunked_estimator_loads_with_a_host_table(estimators, tmp_path):
    f, res = estimators
    out = f.save(str(tmp_path / "saved"))
    g = ESRNNForecaster.load(out, device="cpu")
    assert g.spec.series_chunk == 8
    assert g.params_["hw"].alpha_logit.device.type == "cpu"
    g.data_ = f.data_
    np.testing.assert_array_equal(g.predict(), f.predict())
    srv = g.serve(seed_histories=True)
    assert srv.dispatcher.n_known == N


def test_cli_chunked_fit_and_predict(capsys, caplog, tmp_path):
    out, ckpt = str(tmp_path / "fq"), str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--set", "series_chunk=8"]
    with caplog.at_level(logging.INFO):
        assert cli.main(["fit", "--smoke", "--steps", "6", "--set", "eval_every=3",
                         "--set", "ckpt_every=3", "--ckpt-dir", ckpt, "--out-dir", out,
                         *common]) == 0
    assert "streaming chunked fit" in caplog.text
    steps = sorted(os.listdir(ckpt))
    assert "step_6" in steps
    assert any(f.startswith("leaf_") and ".shard_" in f
               for f in os.listdir(os.path.join(ckpt, "step_6")))
    capsys.readouterr()
    assert cli.main(["predict", "--dir", out, "--json", *common]) == 0
    fc = np.asarray(json.loads(capsys.readouterr().out.strip().splitlines()[-1])["forecast"])
    f = ESRNNForecaster.load(out, device="cpu")
    assert f.n_series_ > 8
    res = ESRNNForecaster(f.spec.replace(series_chunk=0), device="cpu")
    res.params_, res.n_series_, res.cats_ = f.params_, f.n_series_, f.cats_
    res.data_ = res.make_data()
    np.testing.assert_allclose(fc, res.predict(), rtol=1e-4, atol=1e-5)
    assert dataclasses.asdict(f.spec)["series_chunk"] == 8
