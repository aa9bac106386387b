"""Parity of the port's Adam with ``repro.train.optimizer`` (CPU).

The same params (a small ES-RNN tree, converted leaf by leaf) and the same
numpy gradients go through both packages for several steps: dense
``adam_update`` under each schedule, warm-up, clipping, weight decay and the
two-group learning rates, and sparse ``adam_update_sparse`` over changing
row sets (closed-form moment catch-up, ``t_hw`` clocks). Parameters and
moments agree to rtol 1e-5 / atol 1e-7 in float32: the same operations,
with the bias-correction and schedule scalars taken in float32 on the host
where the reference takes them on the device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import esrnn as jes
from repro.train import optimizer as jopt
from repro_torch.convert import params_from_numpy
from repro_torch.core.esrnn import param_leaves
from repro_torch.train import optimizer as topt

N = 10
CONFIGS = {
    "constant": dict(lr=1e-2),
    "grouped_clipped": dict(lr=1e-2, clip_norm=0.5,
                            group_lr={"per_series": 10.0, "default": 1.0}),
    "cosine_warmup": dict(lr=5e-2, schedule="cosine", total_steps=6, warmup_steps=3),
    "exp_decay_wd": dict(lr=5e-2, schedule="exp", total_steps=4, weight_decay=0.1),
}


def _params():
    cfg = jes.make_config("quarterly", hidden_size=4, dilations=((1, 2),))
    return jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(0), cfg, N))


def _grads(jp, rng, rows=None):
    """Numpy grads in the JAX tree's leaf order; hw leaves cut to ``rows``."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jp)
    out = []
    for path, leaf in leaves:
        g = rng.normal(0, 1, leaf.shape).astype(np.float32)
        if rows is not None and jopt._is_hw_path(path, "hw"):
            g = g[rows]
        out.append(g)
    return out


def _check(tp, jp, t_state, j_state):
    j_leaves = jax.tree_util.tree_leaves(jp)
    for (path, t), w in zip(param_leaves(tp), j_leaves, strict=True):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-7,
                                   err_msg=str(path))
    for key in ("mu", "nu"):
        for t, w in zip(t_state[key], jax.tree_util.tree_leaves(j_state[key]), strict=True):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5, atol=1e-9)
    assert t_state["step"] == int(j_state["step"])


def test_leaf_order_is_the_jax_tree_order():
    jp = _params()
    tp = params_from_numpy(jp, "cpu")
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jp)]
    got = [t.detach().numpy() for _, t in param_leaves(tp)]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    paths = [p for p, _ in param_leaves(tp)]
    assert paths[0][0] == "head" and ("hw", "alpha_logit") in paths
    assert topt.esrnn_group_fn(("hw", "alpha_logit")) == "per_series"
    assert topt.esrnn_group_fn(("rnn", 0, 1, "wx")) == "default"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dense_adam_matches_jax(name):
    cfg_kw = CONFIGS[name]
    jp = _params()
    tp = params_from_numpy(jp, "cpu")
    j_cfg, t_cfg = jopt.AdamConfig(**cfg_kw), topt.AdamConfig(**cfg_kw)
    j_state, t_state = jopt.adam_init(jp), topt.adam_init(tp)
    treedef = jax.tree_util.tree_structure(jp)
    rng = np.random.default_rng(1)
    for _ in range(6):
        g = _grads(jp, rng)
        jp, j_state = jopt.adam_update(jax.tree_util.tree_unflatten(treedef, g), j_state,
                                       jp, j_cfg, group_fn=jopt.esrnn_group_fn)
        tp, t_state = topt.adam_update([torch.from_numpy(a) for a in g], t_state, tp,
                                       t_cfg, group_fn=topt.esrnn_group_fn)
    _check(tp, jp, t_state, j_state)


@pytest.mark.parametrize("name", ["constant", "grouped_clipped", "exp_decay_wd"])
def test_sparse_adam_matches_jax(name):
    cfg_kw = CONFIGS[name]
    jp = _params()
    tp = params_from_numpy(jp, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    j_cfg, t_cfg = jopt.AdamConfig(**cfg_kw), topt.AdamConfig(**cfg_kw)
    j_state, t_state = jopt.adam_init_sparse(jp), topt.adam_init_sparse(tp)
    assert topt.hw_table_rows(tp) == jopt.hw_table_rows(jp) == N
    treedef = jax.tree_util.tree_structure(jp)
    rng = np.random.default_rng(2)
    for rows in ([0, 3, 4], [1, 3, 9], [5, 0], [3, 4, 8, 2], [7]):
        rows = np.asarray(rows)
        g = _grads(jp, rng, rows)
        jp, j_state = jopt.adam_update_sparse(
            jax.tree_util.tree_unflatten(treedef, g), j_state, jp, j_cfg,
            idx=jnp.asarray(rows), group_fn=jopt.esrnn_group_fn)
        tp, t_state = topt.adam_update_sparse(
            [torch.from_numpy(a) for a in g], t_state, tp, t_cfg,
            idx=torch.from_numpy(rows), group_fn=topt.esrnn_group_fn)
    _check(tp, jp, t_state, j_state)
    np.testing.assert_array_equal(t_state["t_hw"].numpy(), np.asarray(j_state["t_hw"]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schedule_factor_matches_jax(name):
    j_cfg = jopt.AdamConfig(**CONFIGS[name])
    t_cfg = topt.AdamConfig(**CONFIGS[name])
    for step in (1, 2, 3, 5, 8):
        np.testing.assert_allclose(topt.schedule_factor(t_cfg, step),
                                   float(jopt._schedule_factor(j_cfg, jnp.asarray(step))),
                                   rtol=1e-6)


def test_clip_and_global_norm_match_jax():
    rng = np.random.default_rng(4)
    g = [rng.normal(0, 3, s).astype(np.float32) for s in ((3,), (2, 5), (4,))]
    np.testing.assert_allclose(float(topt.global_norm([torch.from_numpy(a) for a in g])),
                               float(jopt.global_norm(g)), rtol=1e-6)
    cfg = dict(clip_norm=1.0)
    got = topt.clip_by_global_norm([torch.from_numpy(a) for a in g], topt.AdamConfig(**cfg))
    want = jopt._clip_by_global_norm(g, jopt.AdamConfig(**cfg))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
