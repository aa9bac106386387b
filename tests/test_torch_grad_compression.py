"""Error-feedback gradient compression of the port against the JAX package.

``repro_torch.train.grad_compression`` draws its noise from a
``torch.Generator``; JAX's threefry bits are not reproduced, so the
arithmetic is held to ``repro.train.grad_compression`` bit for bit given
the same noise (the reference's own draw, handed in through
``_int8_compress_with_noise``). Then, as the reference's own tests do:

* ``g + err_in - q * scale`` is the residual exactly, ``q * scale +
  residual`` gives ``g + err_in`` back (rtol 1e-6), ``|residual| <=
  scale``, and top-k's kept part plus its residual is ``g + err_in``
  exactly;
* the engine's compressed dense step tracks the uncompressed one: the loss
  after 8 steps within rtol 0.05 (``tests/train/test_grad_compression_engine.py``);
* a compressed fit's residuals go through a checkpoint (the JAX tree's
  structure: ``(params, (adam_state, residuals))``), a resume equals the
  unbroken fit bit for bit, and the JAX trainer resumes the port's
  checkpoint; over a 2-rank gloo mesh the ranks stay bit-identical and a
  resume from the sharded checkpoint equals the unbroken sharded fit;
* the refusals: sparse plus compression, chunked plus compression.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from repro.core import esrnn as jes
from repro.data import pipeline as jpipe
from repro.train import grad_compression as jgc
from repro.train import trainer as jtrainer
from repro_torch.checkpoint.checkpointer import treedef_token
from repro_torch.convert import copy_params, params_from_numpy
from repro_torch.core.esrnn import param_leaves
from repro_torch.sharding import run_ranks
from repro_torch.train import engine as tengine
from repro_torch.train import grad_compression as tgc
from repro_torch.train import trainer as ttrainer
from repro_torch.train.optimizer import AdamConfig, adam_init


def _cases():
    rng = np.random.default_rng(0)
    for seed, shape, err_scale in ((0, (7,), 0.0), (1, (40, 33), 0.1), (2, (5, 4, 3), 1.0),
                                   (3, (1,), 0.5), (4, (257,), 0.01)):
        g = rng.normal(0, 1, shape).astype(np.float32)
        err = (rng.normal(0, err_scale, shape)).astype(np.float32)
        yield seed, g, err


@pytest.mark.parametrize("seed,g,err", list(_cases()))
def test_int8_matches_reference_given_its_noise(seed, g, err):
    key = jax.random.PRNGKey(seed)
    q, scale, new_err = jgc.int8_compress(jnp.asarray(g), jnp.asarray(err), key)
    noise = np.array(jax.random.uniform(key, g.shape, jnp.float32, -0.5, 0.5))
    tq, tscale, terr = tgc._int8_compress_with_noise(
        torch.from_numpy(g), torch.from_numpy(err), torch.from_numpy(noise))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(new_err))
    np.testing.assert_array_equal(tgc.int8_decompress(tq, tscale).numpy(),
                                  np.asarray(jgc.int8_decompress(q, scale)))


@pytest.mark.parametrize("seed,g,err", list(_cases()))
def test_int8_round_trip_and_bound(seed, g, err):
    gen = torch.Generator().manual_seed(seed)
    g_t, e_t = torch.from_numpy(g), torch.from_numpy(err)
    q, scale, new_err = tgc.int8_compress(g_t, e_t, gen)
    total = g_t + e_t
    deq = tgc.int8_decompress(q, scale)
    # the residual is exactly what the quantization dropped
    np.testing.assert_array_equal(new_err.numpy(), (total - deq).numpy())
    np.testing.assert_allclose((deq + new_err).numpy(), total.numpy(), rtol=1e-6, atol=1e-7)
    assert float(new_err.abs().max()) <= float(scale)
    assert int(q.abs().max()) <= 127


@pytest.mark.parametrize("k_frac", [0.01, 0.1, 0.5])
def test_topk_matches_reference_and_residual(k_frac):
    rng = np.random.default_rng(1)
    g = rng.normal(0, 1, 1000).astype(np.float32)
    err = rng.normal(0, 0.1, 1000).astype(np.float32)
    sparse, new_err = tgc.topk_compress(torch.from_numpy(g), torch.from_numpy(err), k_frac)
    j_sparse, j_err = jgc.topk_compress(jnp.asarray(g), jnp.asarray(err), k_frac)
    np.testing.assert_array_equal(sparse.numpy(), np.asarray(j_sparse))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(j_err))
    np.testing.assert_array_equal((sparse + new_err).numpy(), g + err)
    assert int((sparse != 0).sum()) == max(1, int(k_frac * 1000))


def test_tree_matches_reference_leaf_by_leaf():
    """``compress_tree_int8`` over a gradient list: each leaf's arithmetic
    is the reference tree's, given the reference's per-leaf noise."""
    rng = np.random.default_rng(2)
    grads = {"head": {"b": rng.normal(0, 1, (3,)).astype(np.float32),
                      "w": rng.normal(0, 1, (4, 3)).astype(np.float32)},
             "rnn": [rng.normal(0, 1, (6,)).astype(np.float32)]}
    errs = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.01), grads)
    key = jax.random.PRNGKey(11)
    want, want_err = jgc.compress_tree_int8(grads, errs, key)
    leaves = jax.tree_util.tree_leaves(grads)
    for g, e, k, w, we in zip(leaves, jax.tree_util.tree_leaves(errs),
                              jax.random.split(key, len(leaves)),
                              jax.tree_util.tree_leaves(want),
                              jax.tree_util.tree_leaves(want_err)):
        noise = np.array(jax.random.uniform(k, g.shape, jnp.float32, -0.5, 0.5))
        q, s, ne = tgc._int8_compress_with_noise(torch.from_numpy(g), torch.from_numpy(e),
                                                 torch.from_numpy(noise))
        np.testing.assert_array_equal(tgc.int8_decompress(q, s).numpy(), np.asarray(w))
        np.testing.assert_array_equal(ne.numpy(), np.asarray(we))
    # the port's tree: the same round trip, the generator's noise
    t_grads = [torch.from_numpy(a) for a in leaves]
    deq, new_err = tgc.compress_tree_int8(t_grads, tgc.init_error_state(t_grads),
                                          torch.Generator().manual_seed(0))
    for g, d, ne in zip(t_grads, deq, new_err):
        np.testing.assert_array_equal(ne.numpy(), (g - d).numpy())


# ---------------------------------------------------------------------------
# The engine and the trainer
# ---------------------------------------------------------------------------


def _init(n=R.N_SERIES, seed=1):
    cfg = jes.make_config("quarterly", hidden_size=R.HIDDEN)
    return jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(seed), cfg, n))


def test_engine_compress_tracks_uncompressed_trajectory():
    d = R.data()
    tensors = [torch.from_numpy(a) for a in (d.train, d.cats, d.mask)]
    params0 = params_from_numpy(_init(), "cpu")
    cfg = R.model()
    runs = {}
    for compress in (False, True):
        p = copy_params(params0, "cpu")
        opt = adam_init(p)
        if compress:
            opt = (opt, tgc.init_error_state([t for path, t in param_leaves(p)
                                              if path[0] != "hw"]))
        step = tengine.make_step_fn(cfg, AdamConfig(lr=1e-2), *tensors, compress=compress)
        losses = []
        for k in range(8):
            idx = (torch.arange(8) + 8 * k) % R.N_SERIES
            p, opt, loss = step(p, opt, idx)
            losses.append(float(loss))
        runs[compress] = losses, opt
    (ld, _), (lc, oc) = runs[False], runs[True]
    assert np.isfinite(lc).all() and lc[-1] < lc[0]
    np.testing.assert_allclose(lc[-1], ld[-1], rtol=0.05)
    _, err = oc
    assert all(e.dtype == torch.float32 for e in err)
    assert any(float(e.abs().max()) > 0 for e in err)


def _fit(init, **kw):
    return ttrainer.train_esrnn(R.model(), R.data(), R.train_config(**kw),
                                params=copy_params(init, "cpu"), device="cpu")


def test_checkpoint_resume_and_jax_structure(tmp_path):
    jinit = _init()
    init = params_from_numpy(jinit, "cpu")
    unbroken = _fit(init, compress_grads=True)
    ckpt = str(tmp_path / "ckpt")
    _fit(init, compress_grads=True, n_steps=R.EVERY, ckpt_dir=ckpt)
    resumed = _fit(init, compress_grads=True, ckpt_dir=ckpt)
    assert resumed["resumed_from"] == R.EVERY
    assert resumed["history"]["loss"] == unbroken["history"]["loss"][R.EVERY:]
    a, b = R.state_np(resumed), R.state_np(unbroken)
    assert len(a["err"]) == len([p for p, _ in param_leaves(init) if p[0] != "hw"])
    for k in a:
        for x, y in zip(a[k], b[k], strict=True):
            np.testing.assert_array_equal(x, y, err_msg=k)
    # the state has the JAX trainer's structure, whose checkpoint format the
    # port writes: the JAX trainer resumes the port's step-6 checkpoint
    jdata = jpipe.synthetic_prepared(R.N_SERIES, series_length=R.T_LEN, seed=R.DATA_SEED)
    jcfg = jtrainer.TrainConfig(batch_size=R.BATCH, n_steps=R.STEPS, eval_every=R.EVERY,
                                ckpt_every=1000, seed=R.TRAIN_SEED, compress_grads=True,
                                ckpt_dir=str(tmp_path / "jax"))
    jout = jtrainer.train_esrnn(jes.make_config("quarterly", hidden_size=R.HIDDEN), jdata,
                                dataclasses.replace(jcfg, n_steps=1), params=jinit)
    assert treedef_token((unbroken["params"], unbroken["opt_state"])) == str(
        jax.tree_util.tree_structure((jout["params"], jout["opt_state"])))
    shutil.rmtree(tmp_path / "jax")
    shutil.copytree(tmp_path / "ckpt" / f"step_{R.EVERY}", tmp_path / "jax" / f"step_{R.EVERY}")
    jres = jtrainer.train_esrnn(jes.make_config("quarterly", hidden_size=R.HIDDEN), jdata,
                                jcfg, params=jinit)
    assert jres["resumed_from"] == R.EVERY
    # its continued losses follow the port's (different noise: the
    # compression bound)
    np.testing.assert_allclose(jres["history"]["loss"], unbroken["history"]["loss"][R.EVERY:],
                               rtol=0.05)


def test_refusals():
    init = params_from_numpy(_init(), "cpu")
    with pytest.raises(ValueError, match="dense optimizer path"):
        tengine.make_step_fn(R.model(), AdamConfig(), None, None, None, sparse=True,
                             compress=True)
    with pytest.raises(ValueError, match="dense Adam"):
        _fit(init, compress_grads=True, sparse_adam=True)
    with pytest.raises(ValueError, match="compress_grads requires the dense one"):
        _fit(init, compress_grads=True, series_chunk=8)


def test_sharded_compressed_fit(tmp_path):
    init = params_from_numpy(_init(), "cpu")
    ranks = run_ranks(R.session_compress, 2, device="cpu", args=(init, str(tmp_path)))
    r0 = ranks[0]
    for k in r0["unbroken"]["state"]:
        for x, y in zip(r0["unbroken"]["state"][k], ranks[1]["unbroken"]["state"][k]):
            np.testing.assert_array_equal(x, y, err_msg=k)
    assert r0["unbroken"]["counts"] == {"all_reduce": 2 * R.STEPS + R.STEPS // R.EVERY}
    assert r0["resumed_from"] == R.EVERY
    assert r0["resumed"]["loss"] == r0["unbroken"]["loss"][R.EVERY:]
    for k, leaves in r0["resumed"]["state"].items():
        for x, y in zip(leaves, r0["unbroken"]["state"][k], strict=True):
            np.testing.assert_array_equal(x, y, err_msg=k)
    # the same noise as one device (seeded by the batch): the sharded fit
    # follows the single-device compressed fit
    single = _fit(init, compress_grads=True)
    np.testing.assert_allclose(r0["unbroken"]["loss"], single["history"]["loss"], rtol=1e-3)
