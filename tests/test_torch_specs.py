"""The port's partition rules (``repro_torch.sharding.specs``, ``ctx``) against the reference's.

The reference's rules read a module-global mesh and param mode
(``specs.set_mesh``, ``set_param_mode``); without 256 devices it is given a
stub mesh with ``axis_names`` and ``devices = np.empty(shape)``, all that
``_mesh_axis_sizes``, ``axes_for``, ``dp_dim`` and ``cache_spec`` read, and
both globals are restored after each test. Nothing under ``src/repro``
changes. Held, on the meshes (1, 1), (1, 2), (2, 2), (1, 4), (16, 16) and
(2, 16, 16):

* ``param_spec`` of every leaf of every registry arch at its full config,
  in the abstract stacked layout (the port's
  ``repro_torch.launch.steps.abstract_params`` against the reference's
  ``jax.eval_shape`` tree: the same paths, shapes and dtypes), in both
  param modes;
* ``cache_spec`` of every arch's caches at ``decode_32k`` and ``long_500k``
  (``abstract_caches`` against the reference's ``make_caches``);
  ``batch_spec``; ``logical_to_spec``; the ES-RNN rule (the reference's
  ``lower_esrnn`` lines, on its ``esrnn_init`` tree); the cases of the
  reference's two rule tests (``tests/distributed/test_sharding.py``);
* the serving plan (``repro_torch.sharding.tp.shard_lm_params``) against
  the spec: every dim it cuts, on every rank, is one ``param_spec`` (mode
  ``"decode"``) puts on ``model``.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import esrnn as jes
from repro.models.model import build_model as jbuild_model
from repro.sharding import ctx as jctx
from repro.sharding import specs as jspecs
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_stacked_layout
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import AbstractMesh, HostMesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import ctx as tctx
from repro_torch.sharding import specs as tspecs
from repro_torch.sharding import tp

MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
MODES = ("train", "decode")


def _stub(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


@pytest.fixture
def reference_mesh():
    """Sets the reference's mesh global (and mode) for a test; restores both."""
    saved = (jspecs._MESH, jspecs._PARAM_MODE)

    def use(shape, names, mode="train"):
        stub = _stub(shape, names)
        jspecs.set_mesh(stub)
        jspecs.set_param_mode(mode)
        return stub

    yield use
    jspecs._MESH, jspecs._PARAM_MODE = saved


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    model = jbuild_model(jconfigs.get_config(arch))
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tuple(tspecs.tree_leaves_with_path(
        S.abstract_params(build_model(tconfigs.get_config(arch)), master_fp32=False)))


def _ref_caches(arch, batch, seq):
    model = jbuild_model(jconfigs.get_config(arch))
    tree = jax.eval_shape(lambda: model.make_caches(batch, seq, jnp.bfloat16))
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _names(path):
    return jspecs._path_names(path)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_spec_matches_reference(reference_mesh, arch, shape, names, mode):
    stub = reference_mesh(shape, names, mode)
    mesh = AbstractMesh(shape, names)
    ref_axes, axes = jspecs.axes_for(stub), tspecs.axes_for(mesh)
    assert axes == ref_axes
    ref = {_names(p): (leaf, tuple(jspecs.param_spec(p, leaf, ref_axes)))
           for p, leaf in _ref_params(arch)}
    port = dict(_port_params(arch))
    assert set(port) == set(ref)
    for path, leaf in port.items():
        ref_leaf, ref_spec = ref[path]
        assert leaf.shape == tuple(ref_leaf.shape) and leaf.dtype == str(ref_leaf.dtype), path
        assert tspecs.param_spec(path, leaf, axes, mesh=mesh, mode=mode) == ref_spec, path


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("cell", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cache_spec_matches_reference(reference_mesh, arch, cell, shape, names):
    stub = reference_mesh(shape, names)
    mesh = AbstractMesh(shape, names)
    c = tconfigs.SHAPES[cell]
    ref = {_names(p): (leaf, tuple(jspecs.cache_spec(stub, p, leaf, c.global_batch)))
           for p, leaf in _ref_caches(arch, c.global_batch, c.seq_len)}
    port = dict(tspecs.tree_leaves_with_path(
        S.abstract_caches(build_model(tconfigs.get_config(arch)), c)))
    assert set(port) == set(ref)
    for path, leaf in port.items():
        ref_leaf, ref_spec = ref[path]
        assert leaf.shape == tuple(ref_leaf.shape) and leaf.dtype == str(ref_leaf.dtype), path
        assert tspecs.cache_spec(mesh, path, leaf, c.global_batch) == ref_spec, path


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_batch_spec_and_dp_dim_match_reference(reference_mesh, shape, names):
    stub = reference_mesh(shape, names)
    mesh = AbstractMesh(shape, names)
    for batch in (1, 2, 3, 4, 16, 32, 128, 256, 512):
        ref_dp = jspecs.dp_dim(stub, batch)
        assert tspecs.dp_dim(mesh, batch) == ref_dp
        for ndim in (1, 2, 3):
            assert tspecs.batch_spec(mesh, ndim, batch) == tuple(
                jspecs.batch_spec(stub, ndim, batch))


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_logical_to_spec_matches_reference(reference_mesh, shape, names):
    stub = reference_mesh(shape, names)
    mesh = AbstractMesh(shape, names)
    dims = [(None,), ("dp",), ("tp",), ("dp", None, "tp"), (("dp", "tp"),), (("dp",), None),
            ("model",), (("pod",), "data")]
    assert tctx.logical_to_spec(("dp",)) is None and jctx.logical_to_spec(("dp",)) is None
    axes = tspecs.axes_for(mesh)
    with jctx.activation_sharding(stub, dp=axes["dp"], tp=axes["tp"]), \
            tctx.activation_sharding(mesh, dp=axes["dp"], tp=axes["tp"]):
        for d in dims:
            assert tctx.logical_to_spec(d) == tuple(jctx.logical_to_spec(d)), d
        x = torch.ones(3)
        assert tctx.constrain(x, "dp") is x
        assert tctx.model_axis() is None          # an abstract mesh: no ranks
    assert tctx.current() is None


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_esrnn_rule_matches_reference(shape, names):
    """The reference's ``lower_esrnn`` rule (``launch/dryrun.py``: ``hw`` on
    dp, everything else replicated) on its ``esrnn_init`` tree."""
    stub = _stub(shape, names)
    dp = jspecs.axes_for(stub)["dp"]

    def reference_rule(path, leaf):          # the reference's lines, verbatim in effect
        if "hw" in jspecs._path_names(path):
            return (dp,) + (None,) * (len(leaf.shape) - 1)
        return (None,) * len(leaf.shape)

    cfg = jes.make_config("quarterly")
    tree = jax.eval_shape(lambda k: jes.esrnn_init(k, cfg, 4096), jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert any("hw" in _names(p) for p, _ in leaves)
    for p, leaf in leaves:
        assert tspecs.esrnn_param_spec(_names(p), leaf, tspecs.axes_for(
            AbstractMesh(shape, names))["dp"]) == reference_rule(p, leaf)


class _Leaf:
    def __init__(self, shape):
        self.shape = shape


def test_param_spec_rules():
    """The reference's ``test_param_spec_rules`` cases."""
    mesh = AbstractMesh((1, 1), ("data", "model"))
    axes = {"dp": "data", "tp": "model"}
    spec = functools.partial(tspecs.param_spec, axes=axes, mesh=mesh)
    assert spec(("embed",), _Leaf((100, 64))) == ("model", "data")
    assert spec(("layers", "attn", "wq"), _Leaf((4, 64, 128))) == (None, "data", "model")
    assert spec(("layers", "attn", "wo"), _Leaf((4, 128, 64))) == (None, "model", "data")
    assert spec(("layers", "moe", "w_gate"), _Leaf((4, 8, 64, 32))) == (
        None, "model", "data", None)
    assert spec(("layers", "ssm", "w_in"), _Leaf((4, 64, 200))) == (None, "data", None)
    assert spec(("final_norm", "scale"), _Leaf((64,))) == (None,)


def test_divisibility_guard():
    """The reference's ``test_divisibility_guard``: no mesh, everything
    divides; and the guard on a mesh (granite's odd vocab stays whole at
    tp 2; chatglm3's 256-wide ``wk`` is cut at tp 4)."""
    axes = {"dp": "data", "tp": "model"}
    assert tspecs.param_spec(("embed",), _Leaf((100, 64)), axes) == ("model", "data")
    mesh = AbstractMesh((1, 2), ("data", "model"))
    assert tspecs.param_spec(("embed",), _Leaf((49155, 2048)), axes, mesh=mesh) == (None, "data")
    mesh4 = AbstractMesh((1, 4), ("data", "model"))
    assert tspecs.param_spec(("layers", "attn", "wk"), _Leaf((28, 4096, 256)), axes,
                             mesh=mesh4) == (None, "data", "model")


def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert tspecs.axes_for(multi) == {"dp": ("pod", "data"), "tp": "model"}


def _plan_cuts(cfg, model_parallel, rank):
    """{path: [dims]} the serving plan cuts on rank ``rank`` of a (1, tp)
    mesh, from the stacked layouts of the whole and the cut params (meta
    tensors: nothing allocated)."""
    whole = build_model(cfg).init(S._MetaGenerator())
    mesh = HostMesh(1, model_parallel, rank=rank, device="meta", backend=None, groups={})
    cut = dict(tspecs.tree_leaves_with_path(
        lm_stacked_layout(tp.shard_lm_params(cfg, whole, mesh))))
    out = {}
    for path, leaf in tspecs.tree_leaves_with_path(lm_stacked_layout(whole)):
        dims = [i for i, (a, b) in enumerate(zip(leaf.shape, cut[path].shape)) if a != b]
        assert len(cut[path].shape) == len(leaf.shape)
        if dims:
            out[path] = (leaf, dims)
    return out


@pytest.mark.parametrize("model_parallel", [2, 4])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_serving_plan_cuts_only_what_the_spec_puts_on_model(arch, smoke, model_parallel):
    cfg = (tconfigs.get_smoke_config if smoke else tconfigs.get_config)(arch)
    mesh = AbstractMesh((1, model_parallel), ("data", "model"))
    axes = tspecs.axes_for(mesh)
    for rank in range(model_parallel):
        cuts = _plan_cuts(cfg, model_parallel, rank)
        assert cuts or cfg.family == "ssm" and cfg.vocab_size % model_parallel
        for path, (leaf, dims) in cuts.items():
            spec = tspecs.param_spec(path, leaf, axes, mesh=mesh, mode="decode")
            for d in dims:
                assert spec[d] == "model", (path, d, spec)
