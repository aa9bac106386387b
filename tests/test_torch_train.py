"""Parity of the port's training path with the JAX reference, on the CPU.

The same numpy data and the same weights (the JAX init converted leaf by
leaf) go through ``repro`` and ``repro_torch``:

* ``esrnn_loss`` and its gradients against ``jax.value_and_grad``, leaf by
  leaf in the JAX tree's order (``param_leaves``): rtol 1e-5 on the loss,
  atol 1e-6 on the gradients (float32 sums over a few hundred terms in
  another order);
* a 12-step ``train_esrnn`` trajectory, dense and sparse Adam x per-step
  and superstep engines: per-step losses rtol 1e-5, validation sMAPE rtol
  1e-5 and final parameters atol 1e-5. Adam's first steps are sign-like
  (each update is about lr * sign(g)), so a gradient component whose sign
  differs between the two summation orders would move its weight by 2 lr;
  such a component's gradient is at rounding level, so its effect on the
  loss is second order, and the weights themselves differ far less than
  1e-5 in these runs;
* the port's superstep trajectory equal to its per-step one, bit for bit;
* the data layer's arrays and batch schedule equal to JAX's, bit for bit.

Both sides run their plain paths (``use_pallas=False``); the kernels'
autograd wiring is held against the JAX kernels in
``test_torch_grad_kernels.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import esrnn as jes
from repro.data import pipeline as jpipe
from repro.data import synthetic_m4 as jsyn
from repro.train import trainer as jtrainer
from repro_torch.convert import params_from_numpy
from repro_torch.core import esrnn as tes
from repro_torch.core.esrnn import param_leaves
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic_m4 as tsyn
from repro_torch.train import trainer as ttrainer

N_SERIES, T_LEN, BATCH, STEPS = 12, 24, 8, 12
MODEL = dict(hidden_size=8)


def _jax_params(cfg, n, seed=0):
    return jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(seed), cfg, n))


@pytest.fixture(scope="module")
def data():
    return tpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)


@pytest.fixture(scope="module")
def jax_runs(data):
    """JAX trajectories, computed once per (sparse, scan_steps)."""
    cfg = jes.make_config("quarterly", **MODEL)
    jdata = jpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)
    init = _jax_params(cfg, N_SERIES, seed=1)
    cache = {}

    def run(sparse, scan_steps):
        if (sparse, scan_steps) not in cache:
            cache[sparse, scan_steps] = jtrainer.train_esrnn(
                cfg, jdata, _train_cfg(jtrainer.TrainConfig, sparse, scan_steps),
                params=init)
        return cache[sparse, scan_steps]

    return init, run


def _train_cfg(cls, sparse, scan_steps):
    return cls(batch_size=BATCH, n_steps=STEPS, eval_every=6, ckpt_every=1000,
               seed=3, sparse_adam=sparse, scan_steps=scan_steps)


def _leaves_np(params):
    return [t.detach().numpy() for _, t in param_leaves(params)]


def test_loss_and_grads_match_jax():
    jcfg = jes.make_config("quarterly", **MODEL, level_penalty=0.3, cstate_penalty=0.2)
    tcfg = tes.make_config("quarterly", **MODEL, level_penalty=0.3, cstate_penalty=0.2)
    d = tpipe.synthetic_prepared(5, series_length=T_LEN, seed=4)
    mask = d.mask.copy()
    mask[0, :5] = 0.0                              # a left-padded series
    jp = _jax_params(jcfg, 5, seed=2)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jes.esrnn_loss(jcfg, p, d.train, d.cats, mask))(jp)
    tp = params_from_numpy(jp, "cpu")
    for _, t in param_leaves(tp):
        t.requires_grad_(True)
    loss, grads = tes.esrnn_loss_and_grad(
        tcfg, tp, torch.from_numpy(d.train), torch.from_numpy(d.cats),
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(want) == len(grads)
    for (path, _), g, w in zip(param_leaves(tp), grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=str(path))


def test_loss_loop_reference_matches_jax_and_the_batched_loss():
    """``esrnn_loss_loop_reference``: one series at a time, then the mean,
    against the reference's loop on the same weights and data, and against
    the batched loss's mean per-series pin-ball (the same when every series
    scores the same number of windows)."""
    jcfg = jes.make_config("quarterly", **MODEL)
    tcfg = tes.make_config("quarterly", **MODEL)
    d = tpipe.synthetic_prepared(4, series_length=T_LEN, seed=5)
    jp = _jax_params(jcfg, 4, seed=3)
    tp = params_from_numpy(jp, "cpu")
    y, cats = torch.from_numpy(d.train), torch.from_numpy(d.cats)
    with torch.no_grad():
        got = tes.esrnn_loss_loop_reference(tcfg, tp, y, cats)
        batched = tes.esrnn_loss(tcfg, tp, y, cats)
    want = jes.esrnn_loss_loop_reference(jcfg, jp, d.train, d.cats)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(batched), rtol=1e-5)


@pytest.mark.parametrize("sparse,scan_steps", [(False, 1), (False, 4), (True, 1), (True, 4)])
def test_train_trajectory_matches_jax(data, jax_runs, sparse, scan_steps):
    init, run = jax_runs
    want = run(sparse, scan_steps)
    got = ttrainer.train_esrnn(
        tes.make_config("quarterly", **MODEL), data,
        _train_cfg(ttrainer.TrainConfig, sparse, scan_steps),
        params=params_from_numpy(init, "cpu"), device="cpu")
    np.testing.assert_allclose(got["history"]["loss"], want["history"]["loss"], rtol=1e-5)
    g_val, w_val = zip(*got["history"]["val_smape"]), zip(*want["history"]["val_smape"])
    g_steps, g_smape = g_val
    w_steps, w_smape = w_val
    assert g_steps == w_steps == (6, 12)
    np.testing.assert_allclose(g_smape, w_smape, rtol=1e-5)
    for g, w in zip(_leaves_np(got["params"]),
                    jax.tree_util.tree_leaves(want["params"]), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
    assert got["opt_state"]["step"] == int(want["opt_state"]["step"]) == STEPS
    if sparse:
        np.testing.assert_array_equal(got["opt_state"]["t_hw"].numpy(),
                                      np.asarray(want["opt_state"]["t_hw"]))


@pytest.mark.parametrize("sparse", [False, True])
def test_superstep_equals_per_step(data, sparse):
    cfg = tes.make_config("quarterly", **MODEL)
    # no straggler records: they come from the host's wall clock, not the
    # trajectory, so a busy host would make the two histories differ
    runs = [ttrainer.train_esrnn(
        cfg, data, dataclasses.replace(_train_cfg(ttrainer.TrainConfig, sparse, k),
                                       straggler_factor=float("inf")),
        device="cpu", generator=torch.Generator().manual_seed(7)) for k in (1, 5)]
    assert runs[0]["history"] == runs[1]["history"]
    for a, b in zip(_leaves_np(runs[0]["params"]), _leaves_np(runs[1]["params"])):
        np.testing.assert_array_equal(a, b)


def test_on_step_hook_and_unported_options(data, tmp_path):
    cfg = tes.make_config("quarterly", **MODEL)
    seen = []
    ttrainer.train_esrnn(cfg, data, _train_cfg(ttrainer.TrainConfig, False, 4),
                         device="cpu", hooks={"on_step": lambda s, l, p: seen.append(s)})
    assert seen == [3, 5, 9, 11]                   # segment ends: 4, 6, 10, 12
    # checkpoints are ported: ckpt_dir writes one at the end instead of raising
    out = ttrainer.train_esrnn(cfg, data, ttrainer.TrainConfig(n_steps=1, batch_size=4,
                                                               ckpt_dir=str(tmp_path)),
                               device="cpu")
    assert out["resumed_from"] == 0 and (tmp_path / "step_1" / "manifest.json").exists()
    # series data parallelism and gradient compression are ported
    # (tests/test_torch_dp.py, tests/test_torch_grad_compression.py): with no
    # process group data_parallel raises, as the reference does without the
    # devices; compression runs on the dense path and is refused on the sparse
    with pytest.raises(ValueError, match="process group"):
        ttrainer.train_esrnn(cfg, data, ttrainer.TrainConfig(n_steps=1, data_parallel=2),
                             device="cpu")
    out = ttrainer.train_esrnn(cfg, data, ttrainer.TrainConfig(n_steps=1, batch_size=4,
                                                               compress_grads=True),
                               device="cpu")
    assert isinstance(out["opt_state"], tuple) and np.isfinite(out["history"]["loss"]).all()
    with pytest.raises(ValueError, match="dense Adam"):
        ttrainer.train_esrnn(cfg, data, ttrainer.TrainConfig(n_steps=1, compress_grads=True,
                                                             sparse_adam=True), device="cpu")


@pytest.mark.parametrize("freq,scale", [("quarterly", 0.002), ("yearly", 0.001)])
def test_data_layer_matches_jax(freq, scale):
    want = jpipe.prepare(jsyn.generate(freq, scale=scale, seed=3))
    got = tpipe.prepare(tsyn.generate(freq, scale=scale, seed=3))
    for name in ("train", "val_input", "val_target", "test_target", "mask", "cats",
                 "categories"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(tpipe.batch_schedule(got.n_series, 16, 3, 20, seed=1),
                                  jpipe.batch_schedule(want.n_series, 16, 3, 20, seed=1))
    a = tpipe.synthetic_prepared(50, series_length=30, seed=5)
    b = jpipe.synthetic_prepared(50, series_length=30, seed=5)
    np.testing.assert_array_equal(a.train, b.train)
    np.testing.assert_array_equal(a.val_target, b.val_target)
