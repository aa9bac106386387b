"""The port's LM training launcher against the JAX package's.

On the CPU:

* ``synthetic_batch`` bit for bit the reference's (zipf tokens and labels,
  a vlm's bf16 image embeddings, an encdec model's bf16 frames drawn as
  float64 normals and rounded through float32, as ``jnp.asarray(...,
  jnp.bfloat16)`` rounds them; held on values that sit next to a bf16
  tie too), at the SMOKE and full configs;
* a checkpoint of an LM ``(params, opt_state)`` written by the reference's
  ``Checkpointer`` restored by the port, and one written by the port
  restored by the reference, bit for bit, the treedef text equal (stacked
  layers, DeepSeek's prefix list, the hybrid's (G, K) blocks, whisper);
* ``train()`` resumed from a checkpoint equal to the unbroken run bit for
  bit (losses and params), ``train(model_parallel=2)`` spawning its ranks
  and matching the one-device run, the CLI;
* ``batch_template`` against the reference's for every arch and cell, and
  the prefill and decode steps;
* the train step of the vlm (internvl2-2b) and of DeepSeek's MLA with its
  prefix layer against the reference's (``check_train_step`` of
  ``tests/test_torch_lm_train_step.py``; here for the files' time).

The reference's launcher module fails to import on jax 0.9 (its mesh
imports ``jax.experimental.shard_map``, whose DeprecationWarning the
pytest settings make an error; ROADMAP F8), and its ``train()`` fails past
that as its serve launcher does (F5). Its ``synthetic_batch`` is imported
with that one warning ignored; ``train()`` is held to the port's own
unbroken run.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.launch import steps as JS
from repro.models.model import build_model as jbuild_model
from repro.train import optimizer as JO
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointer import Checkpointer, treedef_token
from repro_torch.convert import (lm_leaves_from_numpy, lm_opt_state_to_numpy,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as TO
from test_torch_lm_train_step import check_train_step


def _reference_launcher():
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r"jax\.experimental\.shard_map is deprecated",
                                category=DeprecationWarning)
        import repro.launch.train as JT
    return JT


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("arch", ["granite-3-2b", "internvl2-2b", "whisper-base"])
@pytest.mark.parametrize("smoke", [True, False])
def test_synthetic_batch_is_the_reference_bits(arch, smoke):
    JT = _reference_launcher()
    get = "get_smoke_config" if smoke else "get_config"
    jcfg, cfg = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    seq = 40 if smoke else 300
    for step, seed in ((0, 0), (7, 3)):
        want = JT.synthetic_batch(jcfg, jconfigs.ShapeCell("c", "train", seq, 3), step, seed)
        got = TT.synthetic_batch(cfg, tconfigs.ShapeCell("c", "train", seq, 3), step, seed)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k]
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            g = g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 else g.numpy()
            np.testing.assert_array_equal(_bits(g), _bits(w))


def test_bf16_rounding_of_the_float64_draws():
    """A float64 just past a bf16 tie rounds to float32 on the tie, then to
    even: the reference's two roundings, which a direct float64 -> bf16
    rounding would not give."""
    tie = float(np.float32(1.0) + np.float32(2 ** -8))
    x = np.array([tie + 2 ** -40, tie - 2 ** -40, -tie - 2 ** -40, 3.0000001, 1e-3])
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def _reference_state(arch, seed=0):
    jp = _np(jbuild_model(jconfigs.get_smoke_config(arch)).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    noise = lambda: jax.tree_util.tree_map(lambda a: rng.normal(0, 1, a.shape).astype(
        np.float32), jp)
    opt = dict(JO.adam_init(jp), mu=noise(), nu=jax.tree_util.tree_map(np.abs, noise()),
               step=jnp.asarray(5, jnp.int32))
    return jp, opt


def _assert_same_tree(got, want):
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    assert g_def == w_def
    for g, w in zip(g_leaves, w_leaves):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-2.7b", "whisper-base"])
def test_checkpoints_cross_between_packages(arch, tmp_path):
    jp, jopt = _reference_state(arch)
    params = lm_params_from_numpy(jp, "cpu")
    opt = {"mu": lm_leaves_from_numpy(jopt["mu"], "cpu"),
           "nu": lm_leaves_from_numpy(jopt["nu"], "cpu"), "step": 5}
    assert treedef_token((params, opt)) == str(jax.tree_util.tree_structure((jp, jopt)))
    # the reference writes, the port restores
    JCheckpointer(str(tmp_path / "jax")).save(5, (jp, jopt), metric=1.5)
    template = (lm_params_from_numpy(jax.tree_util.tree_map(np.zeros_like, jp), "cpu"),
                TO.adam_init(lm_params_from_numpy(jp, "cpu")))
    step, (p2, o2) = Checkpointer(str(tmp_path / "jax")).restore(template)
    assert step == 5 and o2["step"] == 5
    _assert_same_tree((lm_params_to_numpy(p2), lm_opt_state_to_numpy(p2, o2)), (jp, _np(jopt)))
    # the port writes, the reference restores
    Checkpointer(str(tmp_path / "port")).save(6, (params, opt), metric=1.25)
    jtemplate = jax.tree_util.tree_map(jnp.zeros_like, (jp, jopt))
    step, back = JCheckpointer(str(tmp_path / "port")).restore(jtemplate)
    assert step == 6
    _assert_same_tree(_np(back), (jp, _np(jopt)))


def test_train_resumes_bit_for_bit(tmp_path):
    kw = dict(smoke=True, batch=4, seq=16, microbatch=2, seed=3, device="cpu")
    whole = TT.train("qwen3-moe-30b-a3b", steps=4, ckpt_dir=str(tmp_path / "a"), **kw)
    first = TT.train("qwen3-moe-30b-a3b", steps=2, ckpt_dir=str(tmp_path / "b"), **kw)
    rest = TT.train("qwen3-moe-30b-a3b", steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(whole["losses"]) == 4 and len(rest["losses"]) == 2
    assert first["losses"] + rest["losses"] == whole["losses"]
    for (_, a), (_, b) in zip(TO.param_leaves(rest["params"]),
                              TO.param_leaves(whole["params"]), strict=True):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert Checkpointer(str(tmp_path / "b")).all_steps() == [2, 4]
    assert whole["losses"][-1] < whole["losses"][0]


def test_train_model_parallel_spawns_its_ranks():
    """``train(model_parallel=2)`` starts 2 gloo ranks on a (1, 2) mesh and
    returns rank 0's result: the one-device run's losses (fp32 partial sums
    in another order) and its params gathered to one device's layout,
    within the bf16 bound (the launcher's Adam moves a weight by about lr x
    sign(g))."""
    kw = dict(smoke=True, steps=2, batch=4, seq=16, microbatch=2, seed=1, device="cpu")
    got = TT.train("granite-3-2b", model_parallel=2, **kw)
    want = TT.train("granite-3-2b", **kw)
    assert got["mesh"] == {"data": 1, "model": 2, "backend": "gloo"}
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["collectives"]["model"]["all_reduce"] > 0 and "data" not in got["collectives"]
    for (pa, a), (pb, b) in zip(TO.param_leaves(got["params"]),
                                TO.param_leaves(want["params"]), strict=True):
        assert pa == pb and a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=1e-3)


def test_train_cli_runs_on_cpu(capsys):
    TT.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu", "--steps", "2",
             "--batch", "2", "--seq", "16"])
    assert "first loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_batch_template_matches_the_reference(arch):
    for name, jcell in jconfigs.SHAPES.items():
        cell = tconfigs.SHAPES[name]
        want = JS.batch_template(jconfigs.get_config(arch), jcell)
        got = TS.batch_template(tconfigs.get_config(arch), cell)
        assert {k: (shape, str(dt).removeprefix("torch.")) for k, (shape, dt) in got.items()} \
            == {k: (v.shape, str(v.dtype)) for k, v in want.items()}


def test_prefill_and_decode_steps_run_the_model():
    cfg = tconfigs.get_smoke_config("yi-6b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cell = tconfigs.ShapeCell("p", "prefill", 12, 2)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, caches = TS.make_prefill_step(model, cell)(params, {"tokens": toks})
        want, _ = model.prefill(params, {"tokens": toks}, 12)
        assert torch.equal(logits, want) and caches["layers"][0].k.shape[1] == 12
        step = {"tokens": logits[:, -1].argmax(-1)[:, None],
                "positions": torch.full((2, 1), 8)}
        out, _ = TS.make_decode_step(model, cell)(params, step, caches)
    assert out.shape == (2, 1, cfg.vocab_size) and torch.isfinite(out).all()


@pytest.mark.parametrize("arch", ["internvl2-2b", "deepseek-v2-lite-16b"])
def test_train_step_matches_jax(arch):
    check_train_step(arch)


def test_remat_train_step_equals_no_remat():
    """Remat changes memory, not values: a train step of a MoE model with
    and without it gives the same loss and params bit for bit."""
    arch = "qwen3-moe-30b-a3b"
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), remat=remat)
        model = build_model(cfg)
        params = TT.fp32_masters(model.init(torch.Generator().manual_seed(0)))
        cell = tconfigs.ShapeCell("t", "train", 16, 4, microbatch=2)
        step = TS.make_train_step(model, cell)
        batch = TT.synthetic_batch(cfg, cell, 0)
        params, opt, loss = step(params, TO.adam_init(params), batch)
        out.append((loss, params))
    assert torch.equal(out[0][0], out[1][0])
    for (_, a), (_, b) in zip(TO.param_leaves(out[0][1]), TO.param_leaves(out[1][1])):
        assert torch.equal(a, b)
