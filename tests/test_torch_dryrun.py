"""The port's dry-run (``repro_torch.launch.dryrun``) against the reference's partition rules.

The reference's dry-run lowers and compiles each cell with XLA on 256 or
512 forced host devices; the port keeps its per-cell shape and memory
check. For every ``all_cells()`` cell and ``("esrnn-quarterly",
"m4_train")``, on both production meshes, the port's ``per_rank_bytes``
(params, Adam's state, caches, batch) equal the reference's specs applied
to its own ``jax.eval_shape`` trees (``repro.launch.steps``'
``abstract_params``, ``abstract_opt_state``, ``batch_template``, the
models' ``make_caches``; the ES-RNN cell's ``esrnn_init`` and
``adam_init``): each dim divided by the product of its axes' sizes, nothing
compiled. The reference's rules read a module-global mesh, given a stub
with ``axis_names`` and ``devices`` and restored afterwards. Every cell is
``ok`` and carries the reference's keys; the CLI writes one file per
``--arch/--shape`` and the full set for ``--all``.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import esrnn as jes
from repro.launch import steps as JS
from repro.models.model import build_model as jbuild_model
from repro.sharding import specs as jspecs
from repro.train.optimizer import adam_init
from repro_torch.configs import all_cells
from repro_torch.launch import dryrun

CELLS = all_cells() + [("esrnn-quarterly", "m4_train")]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# the reference's result keys that carry over (its XLA-only ones do not:
# roofline, lower_s, compile_s, memory_analysis, flops_jaxpr, useful_flops_ratio)
KEYS = {"arch", "shape", "kind", "seq_len", "global_batch", "n_params", "n_params_active",
        "tokens", "mesh", "chips", "status", "model_flops"}


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """``--all`` on both meshes: {mesh: {(arch, shape): result}}."""
    out = tmp_path_factory.mktemp("dryrun")
    results = {}
    for kind in MESHES:
        assert dryrun.main(["--all", "--mesh", kind, "--out", str(out)]) == 0
        folder = out / kind
        assert sorted(os.listdir(folder)) == sorted(f"{a}__{s}.json" for a, s in CELLS)
        results[kind] = {(a, s): json.loads((folder / f"{a}__{s}.json").read_text())
                         for a, s in CELLS}
    return results


@pytest.fixture
def reference_mesh():
    saved = (jspecs._MESH, jspecs._PARAM_MODE)

    def use(kind, mode="train"):
        shape, names = MESHES[kind]
        stub = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
        jspecs.set_mesh(stub)
        jspecs.set_param_mode(mode)
        return stub

    yield use
    jspecs._MESH, jspecs._PARAM_MODE = saved


def _local_bytes(stub, leaf, spec):
    sizes = dict(zip(stub.axis_names, stub.devices.shape))
    n = 1
    for i, dim in enumerate(leaf.shape):
        ax = spec[i] if i < len(spec) else None
        size = 1 if ax is None else int(np.prod(
            [sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
        n *= -(-dim // size)
    return n * np.dtype(leaf.dtype).itemsize


def _tree_bytes(stub, tree, spec_fn):
    return sum(_local_bytes(stub, leaf, spec_fn(path, leaf))
               for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])


def _reference_lm(stub, arch, shape):
    cfg = jconfigs.get_config(arch)
    cell = jconfigs.SHAPES[shape]
    model = jbuild_model(cfg)
    axes = jspecs.axes_for(stub)
    b = cell.global_batch
    parts = {"params": 0, "opt": 0, "caches": 0}
    parts["batch"] = _tree_bytes(stub, JS.batch_template(cfg, cell),
                                 lambda p, leaf: jspecs.batch_spec(stub, len(leaf.shape), b))
    params = JS.abstract_params(model, master_fp32=cell.kind == "train")
    param_spec = lambda p, leaf: jspecs.param_spec(p, leaf, axes)
    parts["params"] = _tree_bytes(stub, params, param_spec)
    if cell.kind == "train":
        opt = JS.abstract_opt_state(params)
        parts["opt"] = (_tree_bytes(stub, opt["mu"], param_spec)
                        + _tree_bytes(stub, opt["nu"], param_spec)
                        + _tree_bytes(stub, opt["step"], lambda p, leaf: ()))
    else:
        caches = jax.eval_shape(lambda: model.make_caches(b, cell.seq_len, jnp.bfloat16))
        parts["caches"] = _tree_bytes(stub, caches,
                                      lambda p, leaf: jspecs.cache_spec(stub, p, leaf, b))
    return parts


def _reference_esrnn(stub, arch, shape):
    """The reference's ``lower_esrnn`` layout: ``hw`` on dp, the rest
    replicated; Adam's moments alike; y and the categories on dp."""
    cfg = jes.make_config(arch.split("-", 1)[1])
    n, t_len = 262144, 72
    dp = jspecs.axes_for(stub)["dp"]

    def rule(path, leaf):
        if "hw" in jspecs._path_names(path):
            return (dp,) + (None,) * (len(leaf.shape) - 1)
        return (None,) * len(leaf.shape)

    params = jax.eval_shape(lambda k: jes.esrnn_init(k, cfg, n), jax.random.PRNGKey(0))
    opt = jax.eval_shape(adam_init, params)
    data = [jax.ShapeDtypeStruct((n, t_len), jnp.float32),
            jax.ShapeDtypeStruct((n, cfg.n_categories), jnp.float32)]
    return {"params": _tree_bytes(stub, params, rule),
            "opt": (_tree_bytes(stub, opt["mu"], rule) + _tree_bytes(stub, opt["nu"], rule)
                    + _tree_bytes(stub, opt["step"], lambda p, leaf: ())),
            "caches": 0,
            "batch": sum(_local_bytes(stub, x, (dp, None)) for x in data)}


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_per_rank_bytes_match_reference_specs(swept, reference_mesh, arch, shape, kind):
    got = swept[kind][arch, shape]
    assert got["status"] == "ok", got.get("traceback")
    assert KEYS <= set(got)
    if arch.startswith("esrnn-"):
        want = _reference_esrnn(reference_mesh(kind), arch, shape)
    else:
        cell = jconfigs.SHAPES[shape]
        want = _reference_lm(reference_mesh(kind, "decode" if cell.kind == "decode" else "train"),
                             arch, shape)
        cfg = jconfigs.get_config(arch)
        assert got["n_params"] == cfg.param_count()
        assert got["n_params_active"] == cfg.active_param_count()
        tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
        assert got["tokens"] == tokens
        assert got["model_flops"] == 6.0 * cfg.active_param_count() * tokens * (
            3 if cell.kind == "train" else 1)
    assert got["per_rank_bytes"] == dict(want, total=sum(want.values()))
    assert got["chips"] == (512 if kind == "multi" else 256) and got["mesh"] == kind
    assert got["fits"] is None and got["device_bytes"] is None     # no card here


def test_cli_writes_one_file_per_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--out", str(tmp_path)]) == 0
    assert os.listdir(tmp_path / "single") == ["yi-6b__decode_32k.json"]
    assert "1 cells, 0 errors" in capsys.readouterr().out
    assert dryrun.main(["--arch", "esrnn-quarterly", "--shape", "m4_train", "--mesh", "multi",
                        "--out", str(tmp_path)]) == 0
    assert os.listdir(tmp_path / "multi") == ["esrnn-quarterly__m4_train.json"]
    # the reference's skip rule: no 500k decode for a full-attention arch
    assert dryrun.main(["--arch", "yi-6b", "--shape", "long_500k", "--out", str(tmp_path)]) == 0
    assert "SKIP yi-6b x long_500k" in capsys.readouterr().out


def test_a_failing_cell_is_recorded(tmp_path):
    r = dryrun.run_cell("yi-6b", "no_such_shape", "single", str(tmp_path))
    assert r["status"] == "error" and "KeyError" in r["error"] and r["traceback"]
    saved = json.loads((tmp_path / "yi-6b__no_such_shape.json").read_text())
    assert saved["status"] == "error"
