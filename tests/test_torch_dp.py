"""Series data parallelism of the port (``repro_torch.sharding``) on the CPU.

Ranks are gloo processes spawned by ``repro_torch.sharding.run_ranks``: one
2-rank session and one 4-rank session for the module (session-scoped
fixtures), each running every case of ``tests/torch_dp_ranks.py`` and
returning numpy. The ranks import no JAX; this process computes the JAX and
the single-device references. The reference's own sharded tests fail on the
installed jax (ROADMAP F1), so sharded runs are held to single-device runs:

* ``esrnn_loss_dp`` loss and gradients against ``jax.value_and_grad`` of
  the JAX single-device loss (loss rtol 1e-6, gradients atol 1e-6, the
  reference's bound), with a variable-length mask whose valid counts differ
  between the ranks (asserted), on 2 and 4 ranks;
* 12-step ``train_esrnn`` fits (dense and sparse x ``scan_steps`` 1 and 4,
  esn, ssm) against the port's and the JAX single-device fits (per-step
  losses rtol 1e-5, val sMAPE rtol 1e-5); bf16 against the port's
  single-device bf16 fit within ``tests/test_torch_bf16_train.py``'s
  trajectory bound (1e-3); every rank's params and moments equal bit for
  bit;
* a fit resumed from a sharded checkpoint equal to the unbroken sharded fit
  bit for bit, the checkpoint restored under 1 rank and under 2 with the
  same leaves;
* ``predict``, ``predict_quantiles``, ``evaluate`` and ``backtest``,
  resident and chunked, against one device (rtol 1e-6) at 15 rows, which
  divide neither 2 nor 4 ranks;
* the chunked fit over the mesh against the chunked single-device fit
  (losses rtol 1e-6); the reference's refusals (a batch or a ragged tail
  that does not divide the mesh, sparse or chunked plus compression);
* the dispatcher and the server with a mesh: the same responses as without
  one, on every rank, the batch buckets snapped to the mesh multiple;
* ``fit``, ``predict``, ``eval`` and ``backtest`` of the CLI with
  ``--devices 2`` against ``--devices 1`` (rtol 1e-6);
* the collectives of a train step, a forecast, an eval and a backtest
  equal to ``repro_torch.sharding.series``'s documented numbers.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from repro.core import esrnn as jes
from repro.data import pipeline as jpipe
from repro.train import trainer as jtrainer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import copy_params, params_from_numpy
from repro_torch.core.esrnn import param_leaves
from repro_torch.forecast import (
    BucketDispatcher, ESRNNForecaster, get_smoke_spec, synthetic_request_stream,
)
from repro_torch.launch import forecast as cli
from repro_torch.sharding import run_ranks
from repro_torch.sharding import series as S
from repro_torch.train import trainer as ttrainer

FIT_RTOL = 1e-5          # 12-step losses and val sMAPE, as tests/test_torch_train.py
BF16_RTOL = 1e-3         # tests/test_torch_bf16_train.py TRAJ_RTOL
INFER_RTOL = 1e-6
BUCKETS = dict(length_buckets=(16, 32), batch_buckets=(1, 4, 16))


def _jax_params(over, n, seed):
    cfg = jes.make_config("quarterly", hidden_size=R.HIDDEN, **over)
    return jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(seed), cfg, n))


def _perturbed_hw(params, seed):
    """Distinct HW rows (the primer's are all equal), so a dropped or
    misplaced row shows."""
    rng = np.random.default_rng(seed)
    for _, t in param_leaves({"hw": params["hw"]}):
        t.add_(torch.from_numpy(rng.normal(0, 0.3, t.shape).astype(np.float32)))
    return params


@pytest.fixture(scope="module")
def jax_inits():
    return {name: _jax_params({k: v for k, v in over.items() if k != "precision"},
                              R.N_SERIES, seed=1)
            for name, over, _, _ in R.FITS}


@pytest.fixture(scope="module")
def inits(jax_inits):
    return {name: params_from_numpy(jp, "cpu") for name, jp in jax_inits.items()}


@pytest.fixture(scope="module")
def infer_inputs():
    """(params, cats, y, spec, buckets, loss params) of the inference cases."""
    params = _perturbed_hw(params_from_numpy(_jax_params({}, R.INFER_N, seed=5), "cpu"), 7)
    d = R.eval_data()
    y = np.concatenate([d.val_input, d.test_target], axis=1)
    spec = get_smoke_spec("esrnn-quarterly", hidden_size=R.HIDDEN)
    loss_params = params_from_numpy(_jax_params({}, R.N_SERIES, seed=2), "cpu")
    return params, d.cats, y, spec, BUCKETS, loss_params


@pytest.fixture(scope="module")
def two(inits, infer_inputs, tmp_path_factory):
    """Both ranks' results of the 2-rank session."""
    tmp = str(tmp_path_factory.mktemp("dp2"))
    return run_ranks(R.session_all, 2, device="cpu", args=(inits, infer_inputs, tmp))


@pytest.fixture(scope="module")
def four(infer_inputs):
    return run_ranks(R.session_infer, 4, device="cpu", args=infer_inputs)


def _same(a, b, what=""):
    """Nested results equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b or (a != a and b != b), what


def _close(a, b, rtol, what=""):
    if isinstance(a, dict):
        for k in a:
            _close(a[k], b[k], rtol, f"{what}/{k}")
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], dict):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _close(x, y, rtol, f"{what}/{i}")
    elif isinstance(a, str):
        assert a == b, what
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=rtol, atol=0, err_msg=what)


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks", [2, 4])
def test_loss_and_grads_match_jax(ranks, two, four, infer_inputs):
    res = two if ranks == 2 else four
    y, cats, mask = R.loss_inputs()
    over = dict(level_penalty=0.3, cstate_penalty=0.2)
    jcfg = jes.make_config("quarterly", hidden_size=R.HIDDEN, **over)
    jp = _jax_params({}, R.N_SERIES, seed=2)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jes.esrnn_loss(jcfg, p, y, cats, mask))(jp)
    valid = [r["loss"]["valid"] for r in res]
    assert len(set(valid)) > 1, f"the ranks' valid counts do not differ: {valid}"
    for r in res:
        got = r["loss"]
        assert got["counts"] == S.STEP_COLLECTIVES
        np.testing.assert_allclose(got["loss"], float(want_loss), rtol=1e-6)
        want = jax.tree_util.tree_leaves(want_grads)
        assert len(want) == len(got["grads"])
        for g, w in zip(got["grads"], want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
        _same(got, res[0]["loss"] | {"valid": got["valid"]})


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_fits(inits):
    """The port's single-device fits of every case."""
    return {name: R.fit_record(ttrainer.train_esrnn(
        R.model(**over), R.data(), R.train_config(sparse, scan),
        params=copy_params(inits[name], "cpu"), device="cpu"))
        for name, over, sparse, scan in R.FITS}


@pytest.mark.parametrize("name", [f[0] for f in R.FITS])
def test_fit_matches_single_device_and_jax(name, two, single_fits, jax_inits):
    over, sparse, scan = next((o, s, k) for n, o, s, k in R.FITS if n == name)
    got, single = two[0]["fits"][name], single_fits[name]
    # every rank holds the same state, bit for bit
    _same(two[1]["fits"][name], got, name)
    steps, evals = R.STEPS, R.STEPS // R.EVERY
    assert got["counts"] == {"all_reduce": 2 * steps + evals}
    rtol = BF16_RTOL if "precision" in over else FIT_RTOL
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=rtol)
    _close([v for _, v in got["val"]], [v for _, v in single["val"]], rtol)
    if "precision" in over:
        return
    jcfg = jes.make_config("quarterly", hidden_size=R.HIDDEN, **over)
    jdata = jpipe.synthetic_prepared(R.N_SERIES, series_length=R.T_LEN, seed=R.DATA_SEED)
    want = jtrainer.train_esrnn(jcfg, jdata, jtrainer.TrainConfig(
        batch_size=R.BATCH, n_steps=R.STEPS, eval_every=R.EVERY, ckpt_every=1000,
        seed=R.TRAIN_SEED, sparse_adam=sparse, scan_steps=scan), params=jax_inits[name])
    np.testing.assert_allclose(got["loss"], want["history"]["loss"], rtol=FIT_RTOL)
    _close([v for _, v in got["val"]], [v for _, v in want["history"]["val_smape"]], FIT_RTOL)


def test_sharded_resume_and_checkpoint_restores(two, inits):
    unbroken = two[0]["fits"]["dense"]
    ck = two[0]["checkpoint"]
    _same(two[1]["checkpoint"], ck)
    assert ck["resumed_from"] == R.EVERY
    # the resumed half equals the unbroken run's, bit for bit
    assert ck["resumed"]["loss"] == unbroken["loss"][R.EVERY:]
    _same(ck["resumed"]["state"], unbroken["state"])
    # restored under the 2-rank mesh (in the ranks) and under 1 rank (here)
    assert ck["restored_step"] == R.STEPS
    _same(ck["restored"], unbroken["state"])
    template = ttrainer.train_esrnn(R.model(), R.data(), dataclasses.replace(
        R.train_config(), n_steps=0), params=copy_params(inits["dense"], "cpu"), device="cpu")
    step, (p, o) = Checkpointer(ck["dir"]).restore((template["params"],
                                                    template["opt_state"]))
    assert step == R.STEPS
    _same(R.state_np({"params": p, "opt_state": o}), unbroken["state"])


def test_chunked_fit_over_the_mesh(two, inits):
    got = two[0]["chunked"]
    _same(two[1]["chunked"], got)
    assert got["counts"] == {"all_reduce": 2 * R.STEPS + R.STEPS // R.EVERY}
    cfg = dataclasses.replace(R.train_config(), series_chunk=8, batch_size=4)
    single = R.fit_record(ttrainer.train_esrnn(R.model(), R.data(), cfg,
                                               params=copy_params(inits["dense"], "cpu"),
                                               device="cpu"))
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-6)
    _close([v for _, v in got["val"]], [v for _, v in single["val"]], 1e-6)


def test_refusals(two):
    ref = two[0]["refusals"]
    d = 2
    assert ref["batch"] == (f"series batch of 5 does not divide the {d}-device 'series' "
                            f"mesh; pick a batch size that is a multiple of {d}")
    assert "dense optimizer path" in ref["sparse_compress"]
    assert "compress_grads requires the dense one" in ref["chunked_compress"]
    assert ref["ragged_tail"].startswith("series batch of 1 does not divide")
    assert ref["forecast_rows"].startswith("series batch of 3 does not divide")


def test_step_and_inference_collectives(two):
    counts = two[0]["counts"]
    assert counts["step_dense"] == counts["step_sparse"] == S.STEP_COLLECTIVES
    assert counts["forecast"] == counts["predict_stats"] == S.FORECAST_COLLECTIVES
    assert counts["eval"] == S.EVAL_COLLECTIVES
    assert counts["backtest"] == S.BACKTEST_COLLECTIVES


# ---------------------------------------------------------------------------
# Inference and serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_infer(infer_inputs):
    params, cats, y, spec, _, _ = infer_inputs
    out = {}
    for chunked in (False, True):
        key = "chunked" if chunked else "resident"
        f = ESRNNForecaster(spec.replace(series_chunk=R.CHUNK if chunked else 0), device="cpu")
        f.params_, f.n_series_, f.cats_ = params, R.INFER_N, cats
        out[key, "predict"] = f.predict(y, cats)
        out[key, "quantiles"] = f.predict_quantiles(y, cats)
        out[key, "backtest"] = f.backtest(y=y, cats=cats, origins=R.ORIGINS)
        d = R.eval_data()
        f.n_series_, f.cats_ = d.n_series, d.cats
        for split in ("val", "test"):
            out[key, "eval_" + split] = f.evaluate(d, split=split)
    return out


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("mode", ["resident", "chunked"])
def test_inference_matches_one_device(ranks, mode, two, four, single_infer):
    res = two if ranks == 2 else four
    for r in res[1:]:
        _same({k: v for k, v in r["infer"].items() if k[0] == mode},
              {k: v for k, v in res[0]["infer"].items() if k[0] == mode})
    got = res[0]["infer"]
    for name in ("predict", "quantiles", "backtest", "eval_val", "eval_test"):
        _close(got[mode, name], single_infer[mode, name], INFER_RTOL, f"{mode}/{name}")
    counts = res[0]["infer_counts"]
    for name in ("predict", "quantiles", "backtest", "eval_val", "eval_test"):
        assert counts[mode, name] == S.VERB_COLLECTIVES, (mode, name)


def test_data_parallel_spec_without_process_group(caplog, infer_inputs, single_infer):
    params, cats, y, spec, _, _ = infer_inputs
    for chunked in (False, True):
        key = "chunked" if chunked else "resident"
        f = ESRNNForecaster(spec.replace(data_parallel=2,
                                         series_chunk=R.CHUNK if chunked else 0), device="cpu")
        f.params_, f.n_series_, f.cats_ = params, R.INFER_N, cats
        with caplog.at_level("WARNING"):
            np.testing.assert_array_equal(f.predict(y, cats), single_infer[key, "predict"])
        assert "data_parallel=2: inference runs on one device" in caplog.text
        with pytest.raises(ValueError, match="process group"):
            f.fit()


@pytest.mark.parametrize("ranks", [2, 4])
def test_serving_with_a_mesh(ranks, two, four, infer_inputs):
    res = two if ranks == 2 else four
    params = infer_inputs[0]
    cfg = R.model()
    reqs = synthetic_request_stream(cfg, 24, n_known=R.N_SERIES, seed=5)
    want = np.stack(BucketDispatcher(cfg, params, device="cpu", **BUCKETS).forecast_batch(reqs))
    for r in res:
        s = r["serving"]
        _same(s, res[0]["serving"])
        assert s["buckets", True] == tuple(sorted({b + (-b) % ranks for b in (1, 4, 16)}))
        for what in ("dispatcher", "server"):
            np.testing.assert_allclose(s[what, True], s[what, False], rtol=INFER_RTOL)
            np.testing.assert_allclose(s[what, True], want, rtol=INFER_RTOL)
        np.testing.assert_allclose(s["after_finetune", True], s["after_finetune", False],
                                   rtol=INFER_RTOL)
        assert s["finetunes", True] == s["finetunes", False] >= 1
        # one all-reduce per dispatched bucket
        assert s["server_counts", True] == {"all_reduce": s["server_batches", True]}
        assert "driven synchronously" in s["threaded"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _json(capsys, argv):
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_devices_2_matches_devices_1(capsys, tmp_path):
    base = ["--smoke", "--device", "cpu", "--steps", "4"]
    fits = {}
    for d in (1, 2):
        out = str(tmp_path / f"d{d}")
        fits[d] = _json(capsys, ["fit", *base, "--out-dir", out, "--devices", str(d), "--json"])
    np.testing.assert_allclose(fits[2]["loss"], fits[1]["loss"], rtol=INFER_RTOL)
    # inference from one saved directory, sharded and not
    d1 = str(tmp_path / "d1")
    for sub in (["predict"], ["predict", "--quantiles", "0.1,0.9"], ["eval"],
                ["backtest", "--origins", "60,72,80"]):
        one, two = (_json(capsys, [sub[0], "--dir", d1, "--device", "cpu", *sub[1:],
                                   "--devices", str(d), "--json"]) for d in (1, 2))
        _close(two, one, INFER_RTOL, " ".join(sub))
