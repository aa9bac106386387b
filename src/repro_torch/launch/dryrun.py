"""Production-mesh dry-run: every (arch x shape) cell's per-rank shapes and bytes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch esrnn-quarterly --shape m4_train

The port of the JAX package's ``launch/dryrun.py``, with its CLI: one JSON
per cell under ``<out>/<mesh>/`` (``--out``, default
``experiments/dryrun``); ``--all`` runs every :func:`~repro_torch.configs.all_cells`
cell and ``("esrnn-quarterly", "m4_train")``. The reference lowers and
compiles each cell with XLA on 256 or 512 forced host devices and reads the
roofline terms and XLA's memory analysis from the executable; here only the
shape and memory check carries over to one card, and nothing is compiled:

* the params (fp32 masters in a train cell, bf16 otherwise), Adam's state
  (train), the bf16 caches (prefill, decode) and the batch of the cell, as
  shapes and dtypes on the ``meta`` device in the reference's stacked layout
  (:func:`repro_torch.launch.steps.abstract_params`, ``abstract_caches``,
  ``abstract_opt_state``, ``batch_template``);
* under the partition rules (:mod:`repro_torch.sharding.specs`, param mode
  ``"decode"`` in a decode cell, ``"train"`` otherwise, as the reference
  sets it) on the production mesh (:func:`~repro_torch.launch.mesh.make_production_mesh`),
  one rank's shard of each leaf, and its bytes by part: ``per_rank_bytes``
  (``params``, ``opt``, ``caches``, ``batch``, ``total``), in place of the
  reference's XLA-only ``roofline``, ``lower_s``, ``compile_s`` and
  ``memory_analysis``;
* the reference's ``n_params``, ``n_params_active``, ``tokens`` and
  ``model_flops`` (6 N D, x 3 in a train cell);
* ``fits``: whether one rank's bytes fit this card's memory
  (``torch.cuda.get_device_properties(0).total_memory``, ``device_bytes``),
  null where no card is present.

A cell that fails records ``status: "error"`` with its traceback, and the
sweep goes on; the summary line counts the errors.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, all_cells, cell_applicable, get_config
from repro_torch.core import esrnn as E
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import specs

# the reference's ES-RNN cells: N series per batch, equalized length C
ESRNN_CELLS = {
    "m4_train": dict(n_series=262144, t_len=72),
    "m4_train_monthly": dict(n_series=262144, t_len=72),
}


def model_flops(n_params: int, tokens: int) -> float:
    """MODEL_FLOPS = 6 * N * D (N_active for MoE; the caller chooses N)."""
    return 6.0 * n_params * tokens


def device_bytes():
    """This card's memory in bytes, or None without a card."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(0).total_memory)


def _batch_bytes(mesh, batch_abs, batch: int) -> int:
    sp = specs.batch_shardings(mesh, batch_abs, batch)
    return sum(specs.local_bytes(shape, dtype, sp[k], mesh)
               for k, (shape, dtype) in batch_abs.items())


def cell_bytes(arch: str, shape: str, mesh):
    """(meta, per-rank bytes by part) of an LM cell on ``mesh``."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    model = build_model(cfg)
    mode = "decode" if cell.kind == "decode" else "train"
    b = cell.global_batch
    meta = {"arch": arch, "shape": shape, "kind": cell.kind, "seq_len": cell.seq_len,
            "global_batch": b, "n_params": cfg.param_count(),
            "n_params_active": cfg.active_param_count(),
            "tokens": b if cell.kind == "decode" else b * cell.seq_len}
    parts = {"params": 0, "opt": 0, "caches": 0,
             "batch": _batch_bytes(mesh, steps.batch_template(cfg, cell), b)}
    params_abs = steps.abstract_params(model, master_fp32=cell.kind == "train")
    params_sp = specs.param_shardings(mesh, params_abs, mode)
    parts["params"] = specs.tree_local_bytes(params_abs, params_sp, mesh)
    if cell.kind == "train":
        opt_abs = steps.abstract_opt_state(params_abs)
        parts["opt"] = specs.tree_local_bytes(
            opt_abs, {"mu": params_sp, "nu": params_sp, "step": ()}, mesh)
    else:
        caches_abs = steps.abstract_caches(model, cell)
        parts["caches"] = specs.tree_local_bytes(
            caches_abs, specs.cache_shardings(mesh, caches_abs, b), mesh)
    return meta, parts


def esrnn_cell_bytes(arch: str, shape: str, mesh):
    """(meta, per-rank bytes by part) of an ES-RNN cell: the per-series
    ``hw`` table on ``dp``, the shared weights replicated, Adam's moments
    alike, the series and categories on ``dp``."""
    cfg = E.make_config(arch.split("-", 1)[1])
    cell = ESRNN_CELLS[shape]
    n, t_len = cell["n_series"], cell["t_len"]
    dp = specs.axes_for(mesh)["dp"]
    params = E.esrnn_init(torch.Generator().manual_seed(0), cfg, n, device="cpu")
    leaves = [(tuple(specs.path_part(k) for k in path), t)
              for path, t in E.param_leaves(params)]
    param_b = sum(specs.local_bytes(t.shape, t.dtype, specs.esrnn_param_spec(p, t, dp), mesh)
                  for p, t in leaves)
    opt_b = sum(2 * specs.local_bytes(t.shape, torch.float32,
                                      specs.esrnn_param_spec(p, t, dp), mesh)
                for p, t in leaves) + specs.itemsize(torch.int32)
    data_b = (specs.local_bytes((n, t_len), torch.float32, (dp, None), mesh)
              + specs.local_bytes((n, cfg.n_categories), torch.float32, (dp, None), mesh))
    meta = {"arch": arch, "shape": shape, "kind": "train", "seq_len": t_len,
            "global_batch": n, "n_params": int(n * (2 + cfg.seasonality)),
            "n_params_active": int(n * (2 + cfg.seasonality)), "tokens": n * t_len}
    return meta, {"params": param_b, "opt": opt_b, "caches": 0, "batch": data_b}


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str) -> dict:
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    t0 = time.perf_counter()
    try:
        if arch.startswith("esrnn-"):
            meta, parts = esrnn_cell_bytes(arch, shape, mesh)
        else:
            meta, parts = cell_bytes(arch, shape, mesh)
        mf = model_flops(meta["n_params_active"], meta["tokens"])
        if meta["kind"] == "train":
            mf *= 3  # fwd + bwd
        total = sum(parts.values())
        card = device_bytes()
        result = {
            **meta, "mesh": mesh_kind, "chips": mesh.size, "status": "ok",
            "mesh_shape": mesh.shape, "model_flops": mf,
            "per_rank_bytes": dict(parts, total=total),
            "device_bytes": card, "fits": None if card is None else total <= card,
            "check_s": time.perf_counter() - t0,
        }
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        result = {
            "arch": arch, "shape": shape, "mesh": mesh_kind, "chips": mesh.size,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def cells(args):
    if args.all:
        return all_cells() + [("esrnn-quarterly", "m4_train")]
    ok, why = (True, "") if args.arch.startswith("esrnn-") else \
        cell_applicable(args.arch, args.shape)
    if not ok:
        print(f"SKIP {args.arch} x {args.shape}: {why}")
        return []
    return [(args.arch, args.shape)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    out_dir = os.path.join(args.out, args.mesh)
    results = []
    for arch, shape in cells(args):
        r = run_cell(arch, shape, args.mesh, out_dir)
        results.append(r)
        if r["status"] == "ok":
            gb = {k: v / 1e9 for k, v in r["per_rank_bytes"].items()}
            print(f"OK   {arch:24s} {shape:12s} {args.mesh:6s} per rank "
                  f"params={gb['params']:.3f} opt={gb['opt']:.3f} caches={gb['caches']:.3f} "
                  f"batch={gb['batch']:.4f} total={gb['total']:.3f} GB fits={r['fits']}")
        else:
            print(f"FAIL {arch:24s} {shape:12s} {args.mesh:6s} {r['error']}")
    errors = sum(r["status"] != "ok" for r in results)
    print(f"{len(results)} cells, {errors} errors")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
