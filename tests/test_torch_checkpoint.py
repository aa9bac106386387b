"""The port's checkpointer against the JAX package's, on the CPU.

* ``treedef_token`` renders the port's params and ``(params, opt_state)``
  in exactly the text ``str(jax.tree_util.tree_structure(...))`` gives for
  the JAX counterpart, for every preset with attention on and off, and for
  dense and sparse Adam states;
* a save/restore round trip is bitwise, leaves no ``.tmp`` directory, keeps
  the best step under retention and refuses a structure mismatch or an
  unsupported dtype;
* a ``(params, opt_state)`` checkpoint written by either package restores in
  the other bit for bit, dense and sparse, flat and row-sharded
  (``shard_rows``);
* the same for the esn and ssm heads, dense and sparse: the treedef text,
  and checkpoints both ways bit for bit, the esn moments covering only the
  trainable subtree (the reservoir is frozen).
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.core import esrnn as jes
from repro.core import heads as jheads
from repro.data import pipeline as jpipe
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.checkpoint import Checkpointer, flatten_with_path, treedef_token
from repro_torch.convert import params_from_numpy
from repro_torch.core import esrnn as tes
from repro_torch.data import pipeline as tpipe
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

N_SERIES, T_LEN, HIDDEN = 10, 24, 4
PRESETS = ("yearly", "quarterly", "monthly", "hourly")


def _port_state(params, kind):
    if kind == "params":
        return params
    return (params, topt.adam_init(params) if kind == "dense" else topt.adam_init_sparse(params))


def _jax_state(params, kind):
    if kind == "params":
        return params
    return (params, jopt.adam_init(params) if kind == "dense" else jopt.adam_init_sparse(params))


@pytest.mark.parametrize("kind", ["params", "dense", "sparse"])
@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_treedef_token_is_jax_text(preset, attention, kind):
    jcfg = jes.make_config(preset, hidden_size=HIDDEN, attention=attention)
    tcfg = tes.make_config(preset, hidden_size=HIDDEN, attention=attention)
    jp = jes.esrnn_init(jax.random.PRNGKey(0), jcfg, 3)
    tp = tes.esrnn_init(torch.Generator().manual_seed(0), tcfg, 3, device="cpu")
    want = str(jax.tree_util.tree_structure(_jax_state(jp, kind)))
    assert treedef_token(_port_state(tp, kind)) == want
    # and the flat leaf order is JAX's, shape for shape
    j_leaves = jax.tree_util.tree_leaves(_jax_state(jp, kind))
    t_leaves = [leaf for _, leaf in flatten_with_path(_port_state(tp, kind))]
    assert len(j_leaves) == len(t_leaves)
    for j, t in zip(j_leaves, t_leaves):
        assert tuple(np.shape(j)) == tuple(getattr(t, "shape", ()))


def _filled(kind, seed=0):
    """A port state whose every leaf holds distinct values."""
    cfg = tes.make_config("quarterly", hidden_size=HIDDEN)
    params = tes.esrnn_init(torch.Generator().manual_seed(seed), cfg, N_SERIES, device="cpu")
    state = _port_state(params, kind)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for _, leaf in flatten_with_path(state):
            if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32:
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
            elif isinstance(leaf, torch.Tensor):
                leaf.copy_(torch.randint(0, 50, leaf.shape, generator=gen))
    if kind != "params":
        state[1]["step"] = 17
    return state


def _assert_same(a, b):
    la, lb = flatten_with_path(a), flatten_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, path
            assert torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x.value == y.value, path


@pytest.mark.parametrize("kind", ["params", "dense", "sparse"])
def test_round_trip_is_bitwise(tmp_path, kind):
    state = _filled(kind)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(17, state, metric=1.5)
    step, back = ckpt.restore(_filled(kind, seed=5))
    assert step == 17
    _assert_same(back, state)
    if kind != "params":
        assert back[1]["step"] == 17 and isinstance(back[1]["step"], int)
        assert isinstance(back[1]["mu"], list)
    # restored tensors are new and writable: the trainer updates in place
    with torch.no_grad():
        for _, leaf in flatten_with_path(back):
            if isinstance(leaf, torch.Tensor):
                leaf.add_(1)
    _assert_same(_filled(kind), state)                 # the saved state untouched
    assert not any(".tmp" in n for n in os.listdir(tmp_path))


def test_retention_keeps_best(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for step, metric in [(1, 5.0), (2, 1.0), (3, 3.0), (4, 4.0), (5, 6.0)]:
        ckpt.save(step, {"x": torch.full((2,), float(step))}, metric=metric)
    steps = ckpt.all_steps()
    assert 2 in steps and steps[-1] == 5 and len(steps) <= 3
    assert ckpt.best_step() == 2 and ckpt.latest_step() == 5


def test_mismatch_and_dtypes_refused(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, _filled("dense"))
    with pytest.raises(ValueError, match="tree structure mismatch"):
        ckpt.restore(_filled("sparse"))
    ckpt.save(2, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="expected"):
        ckpt.restore({"x": torch.zeros(4)}, step=2)
    with pytest.raises(TypeError, match="float32 and int32 only"):
        ckpt.save(3, {"x": torch.zeros(3, dtype=torch.bfloat16)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"x": torch.zeros(3)})


def test_host_paths_give_writable_numpy(tmp_path):
    state = _filled("sparse")
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, state, shard_rows=3)
    table = lambda path: "hw" in path or "t_hw" in path
    _, back = ckpt.restore(state, host_paths=table)
    assert isinstance(back[0]["hw"].alpha_logit, np.ndarray)
    assert isinstance(back[1]["t_hw"], np.ndarray)
    back[1]["t_hw"][0] = 99                            # writable
    np.testing.assert_array_equal(back[0]["hw"].alpha_logit,
                                  state[0]["hw"].alpha_logit.numpy())
    assert isinstance(back[0]["head"].out_w, torch.Tensor)


# -- across packages -----------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """A 3-step (params, opt_state) from each package, dense and sparse,
    from one converted init."""
    jcfg = jes.make_config("quarterly", hidden_size=HIDDEN)
    tcfg = tes.make_config("quarterly", hidden_size=HIDDEN)
    jdata = jpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)
    tdata = tpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)
    init = jax.tree_util.tree_map(
        np.asarray, jes.esrnn_init(jax.random.PRNGKey(1), jcfg, N_SERIES))
    out = {}
    for sparse in (False, True):
        kw = dict(batch_size=4, n_steps=3, eval_every=100, ckpt_every=100, seed=3,
                  sparse_adam=sparse)
        j = jtrainer.train_esrnn(jcfg, jdata, jtrainer.TrainConfig(**kw), params=init)
        t = ttrainer.train_esrnn(tcfg, tdata, ttrainer.TrainConfig(**kw),
                                 params=params_from_numpy(init, "cpu"), device="cpu")
        out[sparse] = (init, (j["params"], j["opt_state"]), (t["params"], t["opt_state"]))
    return out


def _templates(init, sparse):
    jp = jax.tree_util.tree_map(np.asarray, init)
    jt = (jp, jopt.adam_init_sparse(jp) if sparse else jopt.adam_init(jp))
    tp = params_from_numpy(init, "cpu")
    tt = (tp, topt.adam_init_sparse(tp) if sparse else topt.adam_init(tp))
    return jt, tt


def _assert_port_equals_jax(port_state, jax_state):
    j_leaves = jax.tree_util.tree_leaves(jax_state)
    t_leaves = flatten_with_path(port_state)
    assert len(j_leaves) == len(t_leaves)
    for j, (path, t) in zip(j_leaves, t_leaves):
        j = np.asarray(j)
        t = np.asarray(t.value if not isinstance(t, torch.Tensor) else t.detach().numpy())
        assert j.dtype == t.dtype or j.shape == (), path
        np.testing.assert_array_equal(t, j, err_msg=str(path))


@pytest.mark.parametrize("shard_rows", [None, 3])
@pytest.mark.parametrize("sparse", [False, True])
def test_jax_checkpoint_restores_in_the_port(tmp_path, trained, sparse, shard_rows):
    init, j_state, _ = trained[sparse]
    JaxCheckpointer(str(tmp_path)).save(3, j_state, metric=2.0, shard_rows=shard_rows)
    _, tt = _templates(init, sparse)
    step, back = Checkpointer(str(tmp_path)).restore(tt)
    assert step == 3 and back[1]["step"] == 3
    _assert_port_equals_jax(back, j_state)


@pytest.mark.parametrize("shard_rows", [None, 3])
@pytest.mark.parametrize("sparse", [False, True])
def test_port_checkpoint_restores_in_jax(tmp_path, trained, sparse, shard_rows):
    init, _, t_state = trained[sparse]
    Checkpointer(str(tmp_path)).save(3, t_state, metric=2.0, shard_rows=shard_rows)
    if shard_rows:
        assert any(".shard_" in n for n in os.listdir(tmp_path / "step_3"))
    jt, _ = _templates(init, sparse)
    step, back = JaxCheckpointer(str(tmp_path)).restore(jt)
    assert step == 3 and int(back[1]["step"]) == 3
    assert np.asarray(back[1]["step"]).dtype == np.int32
    _assert_port_equals_jax(t_state, back)


def test_shard_layouts_restore_alike(tmp_path, trained):
    """Row-sharded (ragged last shard) and flat saves of one state restore
    to the same bits; shared weights are never sharded."""
    init, _, t_state = trained[True]
    Checkpointer(str(tmp_path / "flat")).save(3, t_state)
    Checkpointer(str(tmp_path / "rows")).save(3, t_state, shard_rows=4)
    names = os.listdir(tmp_path / "rows" / "step_3")
    assert sum(".shard_" in n for n in names) > 0
    assert not any(n.startswith("leaf_0.shard") for n in names)   # head.dense_b
    _, tt = _templates(init, True)
    for d in ("flat", "rows"):
        _, back = Checkpointer(str(tmp_path / d)).restore(tt)
        _assert_same(back, t_state)


# -- the esn and ssm heads -------------------------------------------------------
#
# The moments of an (params, opt_state) cover the trainable subtree: for esn
# the reservoir ("rnn") is frozen, so JAX renders mu / nu as {'head', 'hw'}.


def _head_states(head, sparse, seed=0):
    jcfg = jes.make_config("quarterly", hidden_size=HIDDEN, head=head)
    frozen = sorted(jheads.frozen_param_groups(jcfg))
    jp = jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(seed), jcfg, 3))
    j_train = {k: v for k, v in jp.items() if k not in frozen}
    tp = params_from_numpy(jp, "cpu")
    t_train = {k: v for k, v in tp.items() if k not in frozen}
    j_opt = jopt.adam_init_sparse(j_train) if sparse else jopt.adam_init(j_train)
    t_opt = topt.adam_init_sparse(t_train) if sparse else topt.adam_init(t_train)
    return frozenset(frozen), (jp, j_opt), (tp, t_opt)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("head", ["esn", "ssm"])
def test_head_treedef_token_is_jax_text(head, sparse):
    frozen, j_state, t_state = _head_states(head, sparse)
    assert treedef_token(t_state, frozen) == str(jax.tree_util.tree_structure(j_state))
    assert treedef_token(t_state[0]) == str(jax.tree_util.tree_structure(j_state[0]))
    j_leaves = jax.tree_util.tree_leaves(j_state)
    t_leaves = [leaf for _, leaf in flatten_with_path(t_state, frozen)]
    assert len(j_leaves) == len(t_leaves)
    for j, t in zip(j_leaves, t_leaves):
        assert tuple(np.shape(j)) == tuple(getattr(t, "shape", ()))
    if frozen:                                 # the moments without the reservoir
        assert "'rnn'" not in treedef_token(t_state, frozen).split("'mu'")[1].split("'nu'")[0]
        with pytest.raises(ValueError, match="frozen groups"):
            treedef_token(t_state)


@pytest.fixture(scope="module")
def trained_heads():
    """A 3-step (params, opt_state) of each package for the esn and ssm
    heads, dense and sparse, from one converted init."""
    jdata = jpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)
    tdata = tpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)
    out = {}
    for head in ("esn", "ssm"):
        jcfg = jes.make_config("quarterly", hidden_size=HIDDEN, head=head)
        tcfg = tes.make_config("quarterly", hidden_size=HIDDEN, head=head)
        init = jax.tree_util.tree_map(
            np.asarray, jes.esrnn_init(jax.random.PRNGKey(1), jcfg, N_SERIES))
        for sparse in (False, True):
            kw = dict(batch_size=4, n_steps=3, eval_every=100, ckpt_every=100, seed=3,
                      sparse_adam=sparse)
            j = jtrainer.train_esrnn(jcfg, jdata, jtrainer.TrainConfig(**kw), params=init)
            t = ttrainer.train_esrnn(tcfg, tdata, ttrainer.TrainConfig(**kw),
                                     params=params_from_numpy(init, "cpu"), device="cpu")
            out[head, sparse] = (jheads.frozen_param_groups(jcfg), init,
                                 (j["params"], j["opt_state"]), (t["params"], t["opt_state"]))
    return out


def _head_templates(init, sparse, frozen):
    jp = jax.tree_util.tree_map(np.asarray, init)
    j_train = {k: v for k, v in jp.items() if k not in frozen}
    tp = params_from_numpy(init, "cpu")
    t_train = {k: v for k, v in tp.items() if k not in frozen}
    return ((jp, jopt.adam_init_sparse(j_train) if sparse else jopt.adam_init(j_train)),
            (tp, topt.adam_init_sparse(t_train) if sparse else topt.adam_init(t_train)))


def _assert_head_state_equal(port_state, jax_state, frozen):
    j_leaves = jax.tree_util.tree_leaves(jax_state)
    t_leaves = flatten_with_path(port_state, frozen)
    assert len(j_leaves) == len(t_leaves)
    for j, (path, t) in zip(j_leaves, t_leaves):
        t = np.asarray(t.value if not isinstance(t, torch.Tensor) else t.detach().numpy())
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=str(path))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("head", ["esn", "ssm"])
def test_head_checkpoints_cross_packages(tmp_path, trained_heads, head, sparse, direction):
    frozen, init, j_state, t_state = trained_heads[head, sparse]
    jt, tt = _head_templates(init, sparse, frozen)
    if direction == "jax_to_port":
        JaxCheckpointer(str(tmp_path)).save(3, j_state, metric=2.0)
        step, back = Checkpointer(str(tmp_path), frozen=frozen).restore(tt)
        assert step == 3 and back[1]["step"] == 3
        _assert_head_state_equal(back, j_state, frozen)
    else:
        Checkpointer(str(tmp_path), frozen=frozen).save(3, t_state, metric=2.0)
        step, back = JaxCheckpointer(str(tmp_path)).restore(jt)
        assert step == 3 and int(back[1]["step"]) == 3
        _assert_head_state_equal(t_state, back, frozen)
