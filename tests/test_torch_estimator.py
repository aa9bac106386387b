"""The port's ESRNNForecaster against the JAX package's, on the CPU.

Everything starts from one init, the JAX estimator's drawn from the spec's
seed and converted leaf by leaf (``repro_torch.convert``): the two packages
draw different inits from the same seed.

* fit histories (smoke spec, 6 steps, eval and checkpoint every 3): losses
  and val sMAPE rtol 1e-5, final params atol 1e-5, as
  ``tests/test_torch_train.py`` holds the trainer;
* predict, quantiles, evaluate and backtest on the same params: rtol 1e-4,
  atol 1e-5 (scores rtol 1e-4);
* a directory saved by either estimator loads in the other and predicts
  within that bound;
* a fit resumed from its checkpoint after an interruption equals the
  unbroken fit bit for bit; a trainer checkpoint directory of either package
  resumes in the other's trainer, the continued losses within rtol 1e-5 of
  the unbroken JAX run;
* the errors: not fitted, a shape mismatch, ``data_parallel`` with no
  process group (alone or with series_chunk), and a 1-rank mesh taken as one
  device; a chunked fit and predict run;
* the esn and ssm heads: fits against the JAX estimator from one converted
  init, resumed bit for bit, their trainer checkpoints resumed by JAX.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from repro.core import esrnn as jes
from repro.forecast import ESRNNForecaster as JaxForecaster
from repro.forecast import get_smoke_spec as jax_smoke_spec
from repro.train import trainer as jtrainer
from repro_torch.convert import params_from_numpy
from repro_torch.core.esrnn import param_leaves
from repro_torch.forecast import (
    ESRNNForecaster, ForecastRequest, NotFittedError, get_smoke_spec,
)
from repro_torch.sharding import make_series_mesh
from repro_torch.train import trainer as ttrainer

STEPS = 6
SPEC = dict(data_seed=3, n_steps=STEPS, eval_every=3, ckpt_every=3)
FC_RTOL, FC_ATOL = 1e-4, 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_params_close(port_params, jax_params, atol):
    want = jax.tree_util.tree_leaves(_np_tree(jax_params))
    got = [t.detach().numpy() for _, t in param_leaves(port_params)]
    assert len(want) == len(got)
    for (path, _), g, w in zip(param_leaves(port_params), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=str(path))


@pytest.fixture(scope="module")
def fits():
    """The JAX and the port estimator, fitted from one init."""
    jf = JaxForecaster(jax_smoke_spec("esrnn-quarterly", **SPEC))
    data = jf.make_data()
    init = _np_tree(jes.esrnn_init(jax.random.PRNGKey(0), jf.config, data.n_series))
    jf.params_ = init
    jf.fit(data)
    tf = ESRNNForecaster(get_smoke_spec("esrnn-quarterly", **SPEC), device="cpu")
    tf.params_ = params_from_numpy(init, "cpu")
    tf.fit()
    return init, jf, tf


@pytest.fixture(scope="module")
def same_params(fits):
    """A port estimator holding the JAX estimator's fitted params."""
    _, jf, tf = fits
    f = ESRNNForecaster(tf.spec, device="cpu")
    f.params_ = params_from_numpy(_np_tree(jf.params_), "cpu")
    f.n_series_, f.data_, f.cats_ = tf.n_series_, tf.data_, tf.cats_
    return f


def test_fit_matches_jax(fits):
    _, jf, tf = fits
    assert tf.n_series_ == jf.n_series_ and tf.resumed_from_ == 0
    np.testing.assert_array_equal(tf.data_.train, np.asarray(jf.data_.train))
    np.testing.assert_allclose(tf.history_["loss"], jf.history_["loss"], rtol=1e-5)
    assert len(tf.history_["loss"]) == STEPS
    g_steps, g_smape = zip(*tf.history_["val_smape"])
    w_steps, w_smape = zip(*jf.history_["val_smape"])
    assert g_steps == w_steps == (3, 6)
    np.testing.assert_allclose(g_smape, w_smape, rtol=1e-5)
    _assert_params_close(tf.params_, jf.params_, atol=1e-5)


def test_predict_and_quantiles_match_jax(fits, same_params):
    _, jf, _ = fits
    f = same_params
    np.testing.assert_allclose(f.predict(), jf.predict(), rtol=FC_RTOL, atol=FC_ATOL)
    idx = [0, 5, 7]
    np.testing.assert_allclose(
        f.predict(f.data_.train[idx], series_idx=idx),
        jf.predict(jf.data_.train[idx], series_idx=idx), rtol=FC_RTOL, atol=FC_ATOL)
    taus = (0.1, 0.5, 0.9)
    got, want = f.predict_quantiles(taus=taus), jf.predict_quantiles(taus=taus)
    for tau in taus:
        np.testing.assert_allclose(got[tau], want[tau], rtol=FC_RTOL, atol=FC_ATOL)
    np.testing.assert_array_equal(got[0.5], f.predict())
    assert (got[0.1] <= got[0.5]).all() and (got[0.5] <= got[0.9]).all()


def test_loss_and_grad_match_jax(fits, same_params):
    _, jf, _ = fits
    f = same_params
    y, c = f.data_.train, f.data_.cats
    np.testing.assert_allclose(float(f.loss(y, c)), float(jf.loss(y, c)), rtol=1e-5)
    loss, grads = f.loss_and_grad(y, c)
    w_loss, w_grads = jf.loss_and_grad(y, c)
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-5)
    for g, w in zip(grads, jax.tree_util.tree_leaves(w_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("split", ["val", "test"])
def test_evaluate_matches_jax(fits, same_params, split):
    _, jf, _ = fits
    got, want = same_params.evaluate(split=split), jf.evaluate(split=split)
    assert got.keys() == want.keys() and got["split"] == split
    for k in got:
        if k != "split":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("origins", [None, (60, 72, 80, 88)])
def test_backtest_matches_jax(fits, same_params, origins):
    _, jf, _ = fits
    got, want = same_params.backtest(origins=origins), jf.backtest(origins=origins)
    assert got["origins"] == want["origins"] and got["horizon"] == want["horizon"]
    np.testing.assert_allclose(got["forecasts"], np.asarray(want["forecasts"]),
                               rtol=FC_RTOL, atol=FC_ATOL)
    for g, w in zip(got["per_origin"] + [got], want["per_origin"] + [want]):
        np.testing.assert_allclose([g["smape"], g["mase"]], [w["smape"], w["mase"]],
                                   rtol=1e-4)
    if origins:                                   # origin 88 == T: no target
        assert np.isnan(got["per_origin"][-1]["smape"])


def test_saved_directories_load_across_packages(tmp_path, fits):
    _, jf, tf = fits
    jf.save(str(tmp_path / "jax"))
    tf.save(str(tmp_path / "port"))
    from_jax = ESRNNForecaster.load(str(tmp_path / "jax"), device="cpu")
    assert from_jax.spec.to_dict() == jf.spec.to_dict()
    np.testing.assert_array_equal(from_jax.cats_, jf.cats_)
    _assert_params_close(from_jax.params_, jf.params_, atol=0)
    y = tf.data_.train
    np.testing.assert_allclose(from_jax.predict(y), jf.predict(y), rtol=FC_RTOL, atol=FC_ATOL)
    from_port = JaxForecaster.load(str(tmp_path / "port"))
    assert from_port.spec.to_dict() == tf.spec.to_dict()
    for w, g in zip(jax.tree_util.tree_leaves(_np_tree(from_port.params_)),
                    [t.detach().numpy() for _, t in param_leaves(tf.params_)]):
        np.testing.assert_array_equal(w, g)
    np.testing.assert_allclose(np.asarray(from_port.predict(y)), tf.predict(y),
                               rtol=FC_RTOL, atol=FC_ATOL)


@pytest.mark.parametrize("sparse", [False, True])
def test_resume_is_bit_exact(tmp_path, fits, sparse):
    init, _, _ = fits
    spec = get_smoke_spec("esrnn-quarterly", **SPEC, sparse_adam=sparse)
    whole = ESRNNForecaster(spec, device="cpu")
    whole.params_ = params_from_numpy(init, "cpu")
    whole.fit()
    part = ESRNNForecaster(spec, device="cpu")
    part.params_ = params_from_numpy(init, "cpu")
    part.fit(ckpt_dir=str(tmp_path), n_steps=3)            # interrupted at 3
    rest = ESRNNForecaster(spec, device="cpu")
    rest.fit(ckpt_dir=str(tmp_path))
    assert rest.resumed_from_ == 3
    assert rest.history_["loss"] == whole.history_["loss"][3:]
    assert rest.history_["val_smape"] == whole.history_["val_smape"][1:]
    for (path, a), (_, b) in zip(param_leaves(rest.params_), param_leaves(whole.params_)):
        assert np.array_equal(a.detach().numpy(), b.detach().numpy()), path


@pytest.mark.parametrize("sparse", [False, True])
def test_trainer_checkpoints_resume_across_packages(tmp_path, fits, sparse):
    init, jf, _ = fits
    data, cfg = jf.data_, jf.config
    tcfg = ESRNNForecaster(get_smoke_spec("esrnn-quarterly", **SPEC), device="cpu").config
    kw = dict(batch_size=16, n_steps=STEPS, eval_every=3, ckpt_every=3, seed=0,
              sparse_adam=sparse)
    whole = jtrainer.train_esrnn(cfg, data, jtrainer.TrainConfig(**kw), params=init)
    # JAX writes steps 0-3, the port resumes at 3
    jtrainer.train_esrnn(cfg, data, jtrainer.TrainConfig(
        **dict(kw, n_steps=3), ckpt_dir=str(tmp_path / "j")), params=init)
    port = ttrainer.train_esrnn(tcfg, jf.data_, ttrainer.TrainConfig(
        **kw, ckpt_dir=str(tmp_path / "j")), params=params_from_numpy(init, "cpu"),
        device="cpu")
    assert port["resumed_from"] == 3
    np.testing.assert_allclose(port["history"]["loss"], whole["history"]["loss"][3:],
                               rtol=1e-5)
    # the port writes steps 0-3, JAX resumes at 3
    ttrainer.train_esrnn(tcfg, jf.data_, ttrainer.TrainConfig(
        **dict(kw, n_steps=3), ckpt_dir=str(tmp_path / "t")),
        params=params_from_numpy(init, "cpu"), device="cpu")
    back = jtrainer.train_esrnn(cfg, data, jtrainer.TrainConfig(
        **kw, ckpt_dir=str(tmp_path / "t")), params=init)
    assert back["resumed_from"] == 3
    np.testing.assert_allclose(back["history"]["loss"], whole["history"]["loss"][3:],
                               rtol=1e-5)
    # a dense checkpoint does not resume a sparse run, or the other way round
    with pytest.raises(ValueError, match="sparse_adam"):
        ttrainer.train_esrnn(tcfg, jf.data_, ttrainer.TrainConfig(
            **dict(kw, sparse_adam=not sparse), ckpt_dir=str(tmp_path / "j")),
            params=params_from_numpy(init, "cpu"), device="cpu")


def test_errors_and_refusals(tmp_path, fits):
    _, _, tf = fits
    f = ESRNNForecaster("esrnn-quarterly", device="cpu", hidden_size=8)
    with pytest.raises(NotFittedError):
        f.predict(np.ones((2, 30), np.float32))
    with pytest.raises(NotFittedError):
        f.save(str(tmp_path / "x"))
    with pytest.raises(ValueError, match="series_idx"):
        tf.predict(tf.data_.train[:3])
    with pytest.raises(ValueError, match="split"):
        tf.evaluate(split="train")
    with pytest.raises(ValueError, match="process group"):
        ESRNNForecaster(tf.spec, device="cpu", data_parallel=2).fit()
    # a 1-rank mesh is the single-device path (sharded runs:
    # tests/test_torch_dp.py)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        mesh = make_series_mesh(device="cpu")
        np.testing.assert_array_equal(tf.predict(mesh=mesh), tf.predict())
        assert mesh.collective_counts() == {}
    finally:
        torch.distributed.destroy_process_group()
    # the chunked path runs (tests/test_torch_chunked.py holds it to the
    # resident one); data parallelism needs a process group there too
    fitted = ESRNNForecaster(tf.spec, device="cpu", series_chunk=8, n_steps=2).fit()
    assert fitted.params_["hw"].alpha_logit.device.type == "cpu"
    chunked = ESRNNForecaster(tf.spec.replace(series_chunk=8), device="cpu")
    chunked.params_, chunked.data_, chunked.cats_ = tf.params_, tf.data_, tf.cats_
    chunked.n_series_ = tf.n_series_
    np.testing.assert_allclose(chunked.predict(), tf.predict(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="process group"):
        ESRNNForecaster(tf.spec, device="cpu", series_chunk=8, data_parallel=2).fit()


def test_data_parallel_spec_predicts_on_one_device(caplog, fits):
    _, _, tf = fits
    f = ESRNNForecaster(tf.spec.replace(data_parallel=4), device="cpu")
    f.params_, f.data_, f.cats_ = tf.params_, tf.data_, tf.cats_
    with caplog.at_level("WARNING"):
        fc = f.predict()
    np.testing.assert_array_equal(fc, tf.predict())
    assert "data_parallel=4" in caplog.text


def test_init_params_and_serve(fits):
    _, _, tf = fits
    cold = ESRNNForecaster(tf.spec, device="cpu")
    params = cold.init_params(5)
    assert params["hw"].alpha_logit.shape == (5,)
    again = ESRNNForecaster(tf.spec, device="cpu").init_params(5)
    for (_, a), (_, b) in zip(param_leaves(params), param_leaves(again)):
        assert np.array_equal(a.detach().numpy(), b.detach().numpy())
    srv = tf.serve(seed_histories=True)
    assert len(srv.store) == tf.n_series_
    fut = srv.submit(ForecastRequest(y=None, category=0, series_id=2))
    srv.drain()
    assert np.isfinite(fut.result(timeout=30)).all()


@pytest.mark.parametrize("head", ["esn", "ssm"])
def test_head_fit_matches_jax(tmp_path, head):
    """An esn and an ssm estimator fitted from one converted init: histories
    rtol 1e-5, params atol 1e-5 (the esn reservoir bit for bit: it stays the
    init), forecasts within the forecast bound; the fit resumed from its
    trainer checkpoint (for esn: moments without the reservoir) equals the
    unbroken fit bit for bit, and the JAX trainer resumes the port's
    checkpoint."""
    jf = JaxForecaster(jax_smoke_spec(f"{head}-quarterly", **SPEC))
    data = jf.make_data()
    init = _np_tree(jes.esrnn_init(jax.random.PRNGKey(0), jf.config, data.n_series))
    jf.params_ = init
    jf.fit(data)
    spec = get_smoke_spec(f"{head}-quarterly", **SPEC)
    tf = ESRNNForecaster(spec, device="cpu")
    tf.params_ = params_from_numpy(init, "cpu")
    tf.fit(ckpt_dir=str(tmp_path / "whole"))
    np.testing.assert_allclose(tf.history_["loss"], jf.history_["loss"], rtol=1e-5)
    np.testing.assert_allclose([v for _, v in tf.history_["val_smape"]],
                               [v for _, v in jf.history_["val_smape"]], rtol=1e-5)
    _assert_params_close(tf.params_, jf.params_, atol=1e-5)
    if head == "esn":
        for (path, t), (_, t0) in zip(param_leaves(tf.params_),
                                      param_leaves(params_from_numpy(init, "cpu"))):
            if path[0] == "rnn":
                assert torch.equal(t, t0), path
    y = tf.data_.train
    np.testing.assert_allclose(tf.predict(y), np.asarray(jf.predict(y)),
                               rtol=FC_RTOL, atol=FC_ATOL)
    part = ESRNNForecaster(spec, device="cpu")
    part.params_ = params_from_numpy(init, "cpu")
    part.fit(ckpt_dir=str(tmp_path / "part"), n_steps=3)
    shutil.copytree(tmp_path / "part", tmp_path / "for_jax")
    rest = ESRNNForecaster(spec, device="cpu")
    rest.fit(ckpt_dir=str(tmp_path / "part"))
    assert rest.resumed_from_ == 3
    assert rest.history_["loss"] == tf.history_["loss"][3:]
    for (path, a), (_, b) in zip(param_leaves(rest.params_), param_leaves(tf.params_)):
        assert torch.equal(a, b), path
    back = jtrainer.train_esrnn(jf.config, data, jtrainer.TrainConfig(
        batch_size=spec.batch_size, n_steps=STEPS, eval_every=3, ckpt_every=3, seed=spec.seed,
        lr=spec.rnn_lr, per_series_lr_mult=spec.hw_lr / spec.rnn_lr,
        ckpt_dir=str(tmp_path / "for_jax")), params=init)
    assert back["resumed_from"] == 3
    np.testing.assert_allclose(back["history"]["loss"], tf.history_["loss"][3:], rtol=1e-5)
