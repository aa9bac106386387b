"""The rank side of ``tests/test_torch_dp.py`` and
``tests/test_torch_grad_compression.py``: what each rank of a gloo series
mesh on the CPU runs, returning plain numpy and Python values.

Spawned ranks import this module by name, so it imports neither JAX nor the
JAX package: the test processes compute the references and compare.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import copy_params
from repro_torch.core import esrnn as tes
from repro_torch.core.esrnn import param_leaves
from repro_torch.data import pipeline as tpipe
from repro_torch.forecast import (
    BucketDispatcher, ESRNNForecaster, ForecastServer, ServerConfig,
    synthetic_request_stream,
)
from repro_torch.sharding import series as S
from repro_torch.train import engine as tengine
from repro_torch.train import trainer as ttrainer
from repro_torch.train.optimizer import AdamConfig, adam_init, adam_init_sparse

# the CPU cell: 16 series of length 24 at hidden 8, batch 8 (a multiple of
# 2 and of 4 ranks), 12 steps with eval every 6
N_SERIES, T_LEN, HIDDEN, BATCH, STEPS, EVERY = 16, 24, 8, 8, 12, 6
DATA_SEED, TRAIN_SEED = 2, 3
# the fits: (name, model overrides, sparse, scan_steps)
FITS = [
    ("dense", {}, False, 1), ("dense_scan", {}, False, 4),
    ("sparse", {}, True, 1), ("sparse_scan", {}, True, 4),
    ("esn", dict(head="esn"), False, 1), ("ssm", dict(head="ssm"), False, 1),
    ("bf16", dict(precision="bf16"), False, 1),
]
# the inference cell: 15 rows, which neither 2 nor 4 ranks divide; chunks of 4 rows
INFER_N, CHUNK = 15, 4
ORIGINS = (16, 20, 24)


def data():
    return tpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=DATA_SEED)


def model(**over):
    return tes.make_config("quarterly", hidden_size=HIDDEN, **over)


def train_config(sparse=False, scan_steps=1, **kw):
    base = dict(batch_size=BATCH, n_steps=STEPS, eval_every=EVERY, ckpt_every=1000,
                seed=TRAIN_SEED, sparse_adam=sparse, scan_steps=scan_steps,
                straggler_factor=float("inf"))
    return ttrainer.TrainConfig(**{**base, **kw})


def loss_inputs(n=N_SERIES):
    """Data, params-independent: y, one-hots and a variable-length mask
    whose valid counts differ between the ranks' row blocks."""
    d = tpipe.synthetic_prepared(n, series_length=T_LEN, seed=4)
    mask = d.mask.copy()
    mask[0, :9] = 0.0                  # rank 0's first row left-padded
    mask[1, :5] = 0.0
    return d.train, d.cats, mask


def state_np(out) -> Dict[str, List[np.ndarray]]:
    """A fit's params and optimizer state as numpy, in leaf order."""
    leaves = lambda ts: [t.detach().cpu().numpy().copy() for t in ts]
    opt = out["opt_state"]
    if isinstance(opt, tuple):
        opt, err = opt
    else:
        err = []
    rec = {"params": leaves(t for _, t in param_leaves(out["params"])),
           "mu": leaves(opt["mu"]), "nu": leaves(opt["nu"]), "err": leaves(err),
           "step": [np.asarray(opt["step"])]}
    if "t_hw" in opt:
        rec["t_hw"] = leaves([opt["t_hw"]])
    return rec


def fit_record(out, mesh=None):
    rec = {"loss": list(out["history"]["loss"]), "val": list(out["history"]["val_smape"]),
           "state": state_np(out)}
    if mesh is not None:
        rec["counts"] = mesh.collective_counts()
    return rec


def _fit(mesh, init, name, over, sparse, scan, **kw):
    mesh.reset_counts()
    out = ttrainer.train_esrnn(model(**over), data(), train_config(sparse, scan, **kw),
                               params=copy_params(init[name], "cpu"), mesh=mesh, device="cpu")
    return fit_record(out, mesh)


# ---------------------------------------------------------------------------
# The 2-rank session
# ---------------------------------------------------------------------------


def loss_case(mesh, params):
    y, cats, mask = (torch.from_numpy(a) for a in loss_inputs())
    p = copy_params(params, "cpu")
    for _, t in param_leaves(p):
        t.requires_grad_(True)
    mesh.reset_counts()
    loss, grads = S.esrnn_loss_and_grad_dp(model(level_penalty=0.3, cstate_penalty=0.2),
                                           p, y, cats, mask, mesh=mesh)
    rows = mesh.rows(y.shape[0])
    return {"loss": float(loss), "grads": [g.numpy() for g in grads],
            "counts": mesh.collective_counts(),
            "valid": float((mask[rows][:, 8:]).sum())}


def inference_case(mesh, params, cats, y, spec):
    """The estimator's verbs on ``params`` (INFER_N rows), resident and
    chunked, with the mesh; each call's collective counts."""
    out, counts = {}, {}
    for chunked in (False, True):
        f = ESRNNForecaster(spec.replace(series_chunk=CHUNK if chunked else 0), device="cpu")
        f.params_, f.n_series_, f.cats_ = params, INFER_N, cats
        key = "chunked" if chunked else "resident"
        calls = {
            "predict": lambda: f.predict(y, cats, mesh=mesh),
            "quantiles": lambda: f.predict_quantiles(y, cats, mesh=mesh),
            "backtest": lambda: f.backtest(y=y, cats=cats, origins=ORIGINS, mesh=mesh),
        }
        for name, call in calls.items():
            mesh.reset_counts()
            out[key, name] = call()
            counts[key, name] = mesh.collective_counts()
    # evaluate against a PreparedData of the same rows
    d = eval_data()
    for chunked in (False, True):
        f = ESRNNForecaster(spec.replace(series_chunk=CHUNK if chunked else 0), device="cpu")
        f.params_, f.n_series_, f.cats_ = params, d.n_series, d.cats
        key = "chunked" if chunked else "resident"
        for split in ("val", "test"):
            mesh.reset_counts()
            out[key, "eval_" + split] = f.evaluate(d, split=split, mesh=mesh)
            counts[key, "eval_" + split] = mesh.collective_counts()
    return out, counts


def eval_data():
    return tpipe.synthetic_prepared(INFER_N, series_length=T_LEN, seed=6)


def dp_function_counts(mesh, params):
    """One call of each sharded function: its collectives."""
    cfg = model()
    n = 2 * mesh.size
    y = torch.from_numpy(eval_data().train[:n])
    cats = torch.from_numpy(eval_data().cats[:n])
    p = {**params, "hw": params["hw"].map(lambda a: a[:n])}
    tgt = y[:, -8:]
    tm = torch.ones((n, len(ORIGINS), 8))
    calls = {
        "forecast": lambda: S.esrnn_forecast_dp(cfg, p, y, cats, mesh=mesh),
        "predict_stats": lambda: S.esrnn_predict_stats_dp(cfg, p, y, cats, mesh=mesh),
        "eval": lambda: S.esrnn_eval_dp(cfg, p, y, cats, tgt, y, seasonality=4, mesh=mesh),
        "backtest": lambda: S.esrnn_backtest_dp(cfg, p, y, cats, ORIGINS,
                                                torch.zeros((n, len(ORIGINS), 8)) + 100.0,
                                                tm, seasonality=4, mesh=mesh),
    }
    counts = {}
    for name, call in calls.items():
        mesh.reset_counts()
        call()
        counts[name] = mesh.collective_counts()
    # one train step, dense and sparse
    for sparse in (False, True):
        d = data()
        params_c = copy_params(params, "cpu")
        opt = adam_init_sparse(params_c) if sparse else adam_init(params_c)
        step = tengine.make_step_fn(cfg, AdamConfig(), *(torch.from_numpy(a) for a in (
            d.train, d.cats, d.mask)), mesh=mesh, sparse=sparse)
        mesh.reset_counts()
        step(params_c, opt, torch.arange(BATCH))
        counts["step_sparse" if sparse else "step_dense"] = mesh.collective_counts()
    return counts


def refusals(mesh):
    """The reference's refusals, each message (None where nothing raised)."""
    out = {}
    d = data()

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)

    catch("batch", lambda: ttrainer.train_esrnn(
        model(), d, dataclasses.replace(train_config(), batch_size=5, n_steps=1), mesh=mesh,
        device="cpu"))
    catch("sparse_compress", lambda: tengine.make_step_fn(
        model(), AdamConfig(), None, None, None, mesh=mesh, sparse=True, compress=True))
    catch("chunked_compress", lambda: ttrainer.train_esrnn(
        model(), d, dataclasses.replace(train_config(), series_chunk=8, compress_grads=True,
                                        n_steps=1), mesh=mesh, device="cpu"))
    # a ragged tail: 17 series in chunks of 8 leave a 1-row chunk, whose
    # batch of 1 does not divide the mesh
    catch("ragged_tail", lambda: ttrainer.train_esrnn(
        model(), tpipe.synthetic_prepared(17, series_length=T_LEN, seed=DATA_SEED),
        dataclasses.replace(train_config(), series_chunk=8, batch_size=4, n_steps=1),
        mesh=mesh, device="cpu"))
    catch("forecast_rows", lambda: S.esrnn_forecast_dp(
        model(), None, torch.zeros((mesh.size + 1, T_LEN)), None, mesh=mesh))
    return out


def serving_case(mesh, params, buckets):
    """The dispatcher and the server with and without the mesh: their
    responses, the mesh's batch buckets, the server's per-dispatch counts."""
    cfg = model()
    reqs = synthetic_request_stream(cfg, 24, n_known=N_SERIES, seed=5)
    out = {}
    for sharded in (False, True):
        m = mesh if sharded else None
        disp = BucketDispatcher(cfg, params, mesh=m, device="cpu", **buckets)
        out["dispatcher", sharded] = np.stack(disp.forecast_batch(reqs))
        out["buckets", sharded] = disp.batch_buckets
        srv = ForecastServer(cfg, params, mesh=m, device="cpu",
                             server_config=ServerConfig(finetune_steps=2, finetune_batch=4,
                                                        finetune_min_history=12), **buckets)
        mesh.reset_counts()
        out["server", sharded] = np.stack(srv.forecast_batch(reqs))
        out["server_batches", sharded] = srv.stats.batches
        out["server_counts", sharded] = mesh.collective_counts()
        for sid in range(4):               # 16 observations: past min_history
            for k in range(16):
                srv.observe(sid, 100.0 + 5.0 * np.sin(k + sid))
        srv.drain()
        fut = [srv.submit(r) for r in synthetic_request_stream(cfg, 2, n_known=4, seed=9)]
        srv.drain()
        out["after_finetune", sharded] = np.stack([f.result() for f in fut])
        out["finetunes", sharded] = srv.stats.finetunes
        if sharded:
            try:
                srv.start()
                out["threaded"] = None
            except RuntimeError as e:
                out["threaded"] = str(e)
    return out


def checkpoint_case(mesh, init, tmp):
    """A dense sharded fit checkpointed at step 6 and resumed to 12, beside
    the unbroken run; the checkpoint restored under this mesh."""
    ckpt = os.path.join(tmp, "ckpt_dp")
    cfg6 = dataclasses.replace(train_config(), n_steps=EVERY, ckpt_dir=ckpt)
    ttrainer.train_esrnn(model(), data(), cfg6, params=copy_params(init["dense"], "cpu"),
                         mesh=mesh, device="cpu")
    mesh.reset_counts()
    resumed = ttrainer.train_esrnn(model(), data(), dataclasses.replace(cfg6, n_steps=STEPS),
                                   params=copy_params(init["dense"], "cpu"), mesh=mesh,
                                   device="cpu")
    rec = {"resumed": fit_record(resumed, mesh), "resumed_from": resumed["resumed_from"],
           "dir": ckpt}
    # the step-12 checkpoint restored under this mesh
    template = ttrainer.train_esrnn(model(), data(), dataclasses.replace(train_config(),
                                                                       n_steps=0),
                                    params=copy_params(init["dense"], "cpu"), mesh=mesh,
                                    device="cpu")
    step, (p, o) = Checkpointer(ckpt, mesh=mesh).restore(
        (template["params"], template["opt_state"]), shardings=mesh)
    rec["restored"] = state_np({"params": p, "opt_state": o})
    rec["restored_step"] = step
    return rec


def chunked_case(mesh, init):
    """The chunked fit over the mesh: 16 series in chunks of 8, batch 4."""
    mesh.reset_counts()
    cfg = dataclasses.replace(train_config(), series_chunk=8, batch_size=4)
    out = ttrainer.train_esrnn(model(), data(), cfg, params=copy_params(init["dense"], "cpu"),
                               mesh=mesh, device="cpu")
    return fit_record(out, mesh)


def session_two(mesh, init, tmp):
    """Everything the 2-rank session checks, by case."""
    res = {"rank": mesh.rank}
    res["fits"] = {name: _fit(mesh, init, name, over, sparse, scan)
                   for name, over, sparse, scan in FITS}
    res["checkpoint"] = checkpoint_case(mesh, init, tmp)
    res["chunked"] = chunked_case(mesh, init)
    res["counts"] = dp_function_counts(mesh, init["dense"])
    res["refusals"] = refusals(mesh)
    return res


def session_infer(mesh, params, cats, y, spec, buckets, loss_params):
    """The inference and serving cases, and the loss (2 or 4 ranks)."""
    out, counts = inference_case(mesh, params, cats, y, spec)
    return {"rank": mesh.rank, "infer": out, "infer_counts": counts,
            "serving": serving_case(mesh, params, buckets),
            "loss": loss_case(mesh, loss_params)}


def session_all(mesh, init, infer_args, tmp):
    """The 2-rank session: training, checkpoints, refusals and inference."""
    return {**session_two(mesh, init, tmp), **session_infer(mesh, *infer_args)}


def session_compress(mesh, init, tmp):
    """A 12-step compressed dense fit over the mesh, and the same fit
    resumed at step 6 from its sharded checkpoint."""
    unbroken = _fit(mesh, {"c": init}, "c", {}, False, 1, compress_grads=True)
    ckpt = os.path.join(tmp, "ckpt_compress")
    cfg6 = train_config(n_steps=EVERY, ckpt_dir=ckpt, compress_grads=True)
    ttrainer.train_esrnn(model(), data(), cfg6, params=copy_params(init, "cpu"), mesh=mesh,
                         device="cpu")
    resumed = ttrainer.train_esrnn(model(), data(), dataclasses.replace(cfg6, n_steps=STEPS),
                                   params=copy_params(init, "cpu"), mesh=mesh, device="cpu")
    return {"unbroken": unbroken, "resumed": fit_record(resumed),
            "resumed_from": resumed["resumed_from"]}


# ---------------------------------------------------------------------------
# the collective audit (tests/test_torch_analysis.py)
# ---------------------------------------------------------------------------


def loss_with_broadcast(cfg, params, y, cats, mask=None, *, mesh):
    """The sharded loss plus one broadcast that bypasses the mesh: the
    collective audit's seeded violation."""
    import torch.distributed as dist

    loss = S.esrnn_loss_dp(cfg, params, y, cats, mask, mesh=mesh)
    dist.broadcast(loss.detach().clone(), src=0)
    return loss


def collective_cases(mesh):
    """The collective recorder on its own, then the audit's rank counts,
    healthy and with :func:`loss_with_broadcast`."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    from repro_torch.analysis.collectives import (
        COLLECTIVES, CollectiveRecorder, rank_collective_counts,
    )

    originals = {k: getattr(distributed_c10d, k) for k in COLLECTIVES}
    t = torch.ones(4)
    with CollectiveRecorder() as rec:
        dist.all_reduce(t)
        dist.all_reduce(t)
        dist.all_gather([torch.zeros(4) for _ in range(mesh.size)], t)
        dist.broadcast(t, src=0)
        dist.barrier()
        distributed_c10d.all_reduce(t)          # a direct call, past the namespace
    kinds = dict(rec.counts)
    restored = all(getattr(dist, k) is originals[k] and getattr(distributed_c10d, k)
                   is originals[k] for k in COLLECTIVES)
    with CollectiveRecorder() as rec:
        pass
    dist.all_reduce(t)                          # outside every block
    cfg = model()
    return {"kinds": kinds, "restored": restored, "idle": dict(rec.counts),
            "healthy": rank_collective_counts(mesh, cfg),
            "broadcast": rank_collective_counts(mesh, cfg, loss_with_broadcast)}
