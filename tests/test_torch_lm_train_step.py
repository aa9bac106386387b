"""The port's LM train step and Adam against the JAX package's.

At the SMOKE configs on the CPU, the reference's ``model.init`` weights
converted with ``repro_torch.convert`` (fp32 masters in both):

* ``make_train_step`` at global batch 4 in 2 microbatches of 2 (the bf16
  compute cast of ``cast_params_for_compute``; a SMOKE config computes in
  fp32, so its products promote the bf16 weights back to fp32 as JAX's
  ``jnp.matmul`` does), 3 steps against the reference's jitted
  ``make_train_step``: each step's loss and the updated params within the
  repo's bf16 bound, rtol 2e-2 and atol 1e-3, and each leaf's update (new
  params - init) within 2e-2 of its norm, for one arch of each family
  (the vlm and DeepSeek's MLA with its prefix layer in
  ``tests/test_torch_lm_launch.py``, for the files' time), under two Adam
  configs (``ADAMS``);
* ``cast_params_for_compute``: each leaf's dtype and bits as the
  reference's cast gives them on its stacked layout, where a layer's 1-D
  leaves are stacked to rank 2 and so cast, for every arch;
* ``adam_update`` on an LM tree (sorted keys, then list order) against the
  reference's ``adam_update`` on the stacked tree, with clipping and
  weight decay, 2 steps: params and moments within rtol 1e-6 and atol
  1e-8, a few ulps of the 0.01-sized weights (only the global norm's order
  of summation differs, and XLA fuses the update's arithmetic);
* the train step's attention route: every call needs a gradient and takes
  the plain path, attention layers x microbatches of them, twice under
  remat; no K6 launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as JS
from repro.models.model import build_model as jbuild_model
from repro.train import optimizer as JO
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_leaves_from_numpy, lm_leaves_to_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.kernels import ops
from repro_torch.launch import steps as TS
from repro_torch.models import attention as TA
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as TO

BF16_RTOL, BF16_ATOL = 2e-2, 1e-3
GLOBAL, MICRO, SEQ, STEPS = 4, 2, 16, 3
STEP_ARCHS = ["granite-3-2b", "qwen3-moe-30b-a3b", "mamba2-1.3b", "zamba2-2.7b",
              "whisper-base"]
# the step's Adam: the launcher's (the default), which moves each weight by
# about lr x sign(g), and one whose eps is far above every |g| with no clip,
# which moves it by about -(lr / eps) x the mean gradient, so that the
# microbatches' sum and the division by their count show in the update
# (the launcher's Adam is blind to a gradient's scale); lr / eps = 1e-2
# keeps 3 steps' drift of the two packages' trajectories under the bf16 atol
ADAMS = {"launcher": None, "linear": dict(lr=10.0, eps=1e3)}
UPDATE_RTOL = BF16_RTOL


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, step):
    rng = np.random.default_rng([11, step])
    s_text = SEQ - (cfg.n_patches if cfg.family == "vlm" else 0)
    toks = rng.zipf(1.3, (GLOBAL, s_text + 1)).clip(max=cfg.vocab_size - 1).astype(np.int32)
    b = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.family == "vlm":
        b["image_embeds"] = rng.normal(0, 1, (GLOBAL, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.normal(0, 1, (GLOBAL, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return b


def _cell():
    return jconfigs.ShapeCell("t", "train", SEQ, GLOBAL, microbatch=MICRO)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_with_microbatches_matches_jax(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_update_follows_the_mean_gradient(arch):
    check_train_step(arch, "linear")


def check_train_step(arch, adam="launcher"):
    """3 steps of the port's and the reference's train step from one init
    under ``ADAMS[adam]`` (``tests/test_torch_lm_launch.py`` holds the vlm
    and MLA archs)."""
    kw = ADAMS[adam]
    jcfg = jconfigs.get_smoke_config(arch)
    jmodel = jbuild_model(jcfg)
    jp = _np(jmodel.init(jax.random.PRNGKey(0)))
    jstep = jax.jit(JS.make_train_step(jmodel, _cell(),
                                       adam=kw and JO.AdamConfig(**kw)))
    jparams, jopt = jp, JO.adam_init(jp)
    cfg = tconfigs.get_smoke_config(arch)
    tstep = TS.make_train_step(build_model(cfg), tconfigs.ShapeCell(
        "t", "train", SEQ, GLOBAL, microbatch=MICRO), adam=kw and TO.AdamConfig(**kw))
    params = lm_params_from_numpy(jp, "cpu")
    opt = TO.adam_init(params)
    for step in range(STEPS):
        b = _batch(cfg, step)
        jparams, jopt, jloss = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, loss = tstep(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(loss), float(jloss), rtol=BF16_RTOL, atol=BF16_ATOL)
    assert opt["step"] == STEPS and int(jopt["step"]) == STEPS
    got, got_def = jax.tree_util.tree_flatten(lm_params_to_numpy(params))
    want, want_def = jax.tree_util.tree_flatten(_np(jparams))
    assert got_def == want_def
    for g, w, p0 in zip(got, want, jax.tree_util.tree_leaves(jp), strict=True):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=BF16_ATOL)
        # the update itself: the reference moves every leaf, and the port
        # within UPDATE_RTOL of that move's norm
        d_got, d_want = g.astype(np.float64) - p0, w.astype(np.float64) - p0
        assert np.linalg.norm(d_want) > 0
        assert np.linalg.norm(d_got - d_want) <= UPDATE_RTOL * np.linalg.norm(d_want)
    assert all(not t.requires_grad and t.grad is None
               for _, t in TO.param_leaves(params))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_cast_params_for_compute_matches_the_reference(arch):
    jp = _np(jbuild_model(jconfigs.get_smoke_config(arch)).init(jax.random.PRNGKey(1)))
    want = _np(JS.cast_params_for_compute(jp))
    got = lm_params_to_numpy(TS.cast_params_for_compute(lm_params_from_numpy(jp, "cpu")))
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    assert g_def == w_def
    kept = 0
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
        kept += g.dtype == np.float32
    # only the unstacked 1-D leaves stay fp32 (final norms and the like)
    assert 0 < kept < len(g_leaves) // 2


def test_adam_on_an_lm_tree_matches_jax():
    arch = "deepseek-v2-lite-16b"          # stacked layers and a prefix list
    jp = _np(jbuild_model(jconfigs.get_smoke_config(arch)).init(jax.random.PRNGKey(2)))
    cfg = dict(lr=1e-2, clip_norm=1.0, weight_decay=0.1)
    jstate = JO.adam_init(jp)
    params = lm_params_from_numpy(jp, "cpu")
    state = TO.adam_init(params)
    jparams = jp
    rng = np.random.default_rng(3)
    jupdate = jax.jit(lambda g, s, p: JO.adam_update(g, s, p, JO.AdamConfig(**cfg)))
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 0.5, a.shape).astype(np.float32), jp)
        jparams, jstate = jupdate(grads, jstate, jparams)
        params, state = TO.adam_update(lm_leaves_from_numpy(grads, "cpu"), state, params,
                                       TO.AdamConfig(**cfg))
    assert state["step"] == 2
    for got, want in ((lm_params_to_numpy(params), jparams),
                      (lm_leaves_to_numpy(params, state["mu"]), jstate["mu"]),
                      (lm_leaves_to_numpy(params, state["nu"]), jstate["nu"])):
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(_np(want))):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_routes_every_attention_to_the_plain_path(remat):
    arch = "zamba2-2.7b"                   # 2 shared-block applications
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), remat=remat)
    model = build_model(cfg)
    params = TS.cast_params_for_compute(model.init(torch.Generator().manual_seed(0)),
                                        torch.float32)
    step = TS.make_train_step(model, tconfigs.ShapeCell("t", "train", SEQ, GLOBAL,
                                                        microbatch=MICRO))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    TA.reset_grad_route_calls()
    ops.reset_launch_counts()
    _, _, loss = step(params, TO.adam_init(params), b)
    applications = cfg.n_layers // cfg.attn_every
    assert TA.grad_route_calls() == applications * (GLOBAL // MICRO) * (2 if remat else 1)
    assert ops.launch_counts()["flash_attention"] == 0
    assert torch.isfinite(loss)
