"""Sharded LM training under the default bf16 compute against the reference.

The ranks (``tests/torch_tp_train_ranks.py``, gloo on the CPU, the meshes
of ``tests/test_torch_tp_train.py``: every arch's SMOKE config on (1, 2) and
(2, 2), yi-6b and qwen3-moe on (2, 1)) run 3 sharded train steps under the
bf16 compute policy at the launcher's Adam, from the port's masters of one
seed, on the train launcher's batches; the reference's jitted one-device
``make_train_step`` runs the same steps on those weights converted by
``repro_torch.convert``. Each step's loss and the params after 3 are held
within the bounds of ``tests/test_torch_lm_train_step.py`` (rtol 2e-2, atol
1e-3). The launcher's Adam moves a weight by about lr x sign(g): where the
``data`` ranks' bf16 partial gradients nearly cancel, one rounding flips
the sign, so the update itself is held in
``tests/test_torch_tp_train_update.py``, at the Adam whose step follows the
mean gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_train_ranks as R
from repro import configs as jconfigs
from repro.launch import steps as JS
from repro.models.model import build_model as jbuild_model
from repro.train import optimizer as JO
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_to_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import synthetic_batch
from repro_torch.sharding import run_ranks
from test_torch_tp_train import EXTRA, arch_cases

BF16_RTOL, BF16_ATOL, UPDATE_RTOL = 2e-2, 1e-3, 2e-2
ADAM = "launcher"


def sessions(adam):
    """The two sessions' trajectories at ``R.ADAMS[adam]``: (two, four)."""
    two = run_ranks(R.session, 2, device="cpu", args=(adam, ARCHS, EXTRA),
                    mesh_factory=functools.partial(make_host_mesh, 2))
    four = run_ranks(R.session4, 4, device="cpu", args=(adam, ARCHS),
                     mesh_factory=functools.partial(make_host_mesh, 2))
    return two, four


@pytest.fixture(scope="module")
def ranks():
    return sessions(ADAM)


def _jax_trajectory(arch, adam):
    """The reference's jitted one-device train step, 3 steps from the port's
    masters of ``R.SEED`` (converted) on the launcher's batches under
    ``R.ADAMS[adam]``."""
    cfg, _, full = R.init(arch)
    jp = lm_params_to_numpy(full)
    jmodel = jbuild_model(jconfigs.get_smoke_config(arch))
    jstep = jax.jit(JS.make_train_step(jmodel, jconfigs.ShapeCell(
        "t", "train", R.SEQ, R.GLOBAL, microbatch=R.MICRO),
        adam=JO.AdamConfig(**R.ADAMS[adam])))
    params, opt, losses = jp, JO.adam_init(jp), []
    for step in range(R.STEPS):
        b = synthetic_batch(cfg, R.cell(), step, R.SEED)
        jb = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) if v.dtype == torch.bfloat16
              else jnp.asarray(v.numpy()) for k, v in b.items()}
        params, opt, loss = jstep(params, opt, jb)
        losses.append(float(loss))
    return jp, jax.tree_util.tree_map(np.asarray, params), losses


def check_against_the_reference(ranks, arch, adam, update: bool):
    """Each step's loss and the params after 3 of every case of ``arch``
    against the reference's; with ``update``, each leaf's update within
    ``UPDATE_RTOL`` of the norm of the reference's."""
    two, four = ranks
    p0, want, want_losses = _jax_trajectory(arch, adam)
    template = R.init(arch)[2]
    want_leaves, want_def = jax.tree_util.tree_flatten(want)
    for mesh, rank, traj in arch_cases(two, four, arch):
        where = f"{arch} on {mesh}, rank {rank}, {adam} Adam"
        np.testing.assert_allclose(traj["losses"], want_losses, rtol=BF16_RTOL,
                                   atol=BF16_ATOL, err_msg=where)
        got, got_def = jax.tree_util.tree_flatten(
            lm_params_to_numpy(_tree_like(template, traj["params"])))
        assert got_def == want_def
        for g, w, i in zip(got, want_leaves, jax.tree_util.tree_leaves(p0), strict=True):
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=BF16_ATOL, err_msg=where)
            d_got, d_want = g.astype(np.float64) - i, w.astype(np.float64) - i
            assert np.linalg.norm(d_want) > 0, where
            if update:
                assert np.linalg.norm(d_got - d_want) <= UPDATE_RTOL * np.linalg.norm(
                    d_want), where


def _tree_like(template, by_name):
    """``template``'s nest with each leaf taken from ``by_name`` (numpy by
    ``R.name(path)``)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        return torch.from_numpy(by_name[R.name(path)])
    return walk(template, ())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_steps_match_the_reference(ranks, arch):
    check_against_the_reference(ranks, arch, ADAM, update=False)
