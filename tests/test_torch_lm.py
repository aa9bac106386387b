"""The port's LM serving path (dense and MoE families) against the JAX package's.

Same numpy weights (``repro.models.transformer.lm_init`` converted with
``repro_torch.convert.lm_params_from_numpy``) and the same token ids through
both packages, on the CPU, at the SMOKE configs (fp32). On CPU tensors the
port's prefill attention runs the plain chunked path; it is held against the
reference's ``use_pallas=False`` (its plain chunked path) and, for configs
whose scale is 1/sqrt(head_dim), ``use_pallas=True`` (the Pallas kernel K6
in interpret mode; for other scales that path is wrong, ROADMAP F4).
Logits and caches within rtol 1e-5 / atol 1e-5: fp32 sums of at most a few
hundred terms in another order (a second layer's K/V carry the first
layer's rounding: 1.4e-6 apart at most here). The MoE family runs at the
qwen3-moe SMOKE config and at DeepSeek's layout on GQA (one dense prefix
layer of ``first_dense_d_ff`` and a shared expert: ``DEEPSEEK_LAYOUT``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro.models.model import build_model as jbuild_model
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model

DENSE = ["yi-6b", "granite-3-2b", "qwen2.5-14b", "chatglm3-6b"]
MOE = "qwen3-moe-30b-a3b"
# qwen3-moe's SMOKE config with deepseek-v2's prefix layer and shared expert
DEEPSEEK_LAYOUT = "qwen3-moe-30b-a3b+prefix"
_LAYOUT = dict(first_dense_layers=1, first_dense_d_ff=128, n_shared_experts=1)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_TOL = LOGIT_TOL
BATCH, PROMPT = 2, 12


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_config_registry_matches_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        got = dataclasses.asdict(getattr(tconfigs, get)(arch))
        assert got == want
    cfg = tconfigs.get_config(arch)
    assert cfg.param_count() == jconfigs.get_config(arch).param_count()
    assert cfg.tdtype == getattr(torch, cfg.dtype)


def test_registry_shapes_and_cells_match_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.all_cells() == jconfigs.all_cells()


def test_rms_norm_and_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (3, 5, 48)).astype(np.float32)
    scale = rng.normal(1, 0.1, 48).astype(np.float32)
    np.testing.assert_allclose(TL.rms_norm(_t(x), _t(scale)).numpy(),
                               np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
                               rtol=1e-6, atol=1e-6)
    p = {k: rng.normal(0, 0.2, s).astype(np.float32)
         for k, s in (("w_gate", (48, 80)), ("w_up", (48, 80)), ("w_down", (80, 48)))}
    want = JL.swiglu_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = TL.swiglu_apply({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_jax(fraction):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 40, 3, 32)).astype(np.float32)
    for pos in (np.arange(40)[None, :], rng.integers(0, 5000, (2, 40))):
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=5e6, fraction=fraction)
        got = TL.apply_rope(_t(x), _t(pos), theta=5e6, fraction=fraction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["yi-6b", "chatglm3-6b", "qwen3-moe-30b-a3b"])
def test_gqa_apply_prefill_and_decode_match_jax(arch):
    """Prefill (a cache of 16 from 9 positions) then a one-token append; the
    configs cover plain GQA, QKV bias with half RoPE, and QK-norm."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jp = _np(JA.gqa_init(jax.random.PRNGKey(2), jcfg, jnp.float32))
    rng = np.random.default_rng(2)
    for k in ("bq", "bk", "bv", "q_norm", "k_norm"):     # away from 0 and 1
        if k in jp:
            jp[k] = (jp[k] + rng.normal(0, 0.5, jp[k].shape)).astype(np.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    x = rng.normal(0, 1, (2, 9, jcfg.d_model)).astype(np.float32)
    pos = np.arange(9)[None, :]
    jout, jcache = JA.gqa_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), cache_max_len=16)
    tout, tcache = TA.gqa_apply(tp, tcfg, _t(x), _t(pos), cache_max_len=16)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **LOGIT_TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **CACHE_TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), **CACHE_TOL)
    assert tcache.length == int(jcache.length) == 9

    x1 = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
    pos1 = np.full((2, 1), 9)
    jout, jcache = JA.gqa_apply(jp, jcfg, jnp.asarray(x1), jnp.asarray(pos1), cache=jcache)
    tout, tcache = TA.gqa_apply(tp, tcfg, _t(x1), _t(pos1), cache=tcache)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **LOGIT_TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **CACHE_TOL)
    assert tcache.length == int(jcache.length) == 10


def _smoke(arch):
    """(the JAX config, the port's) at ``arch``'s SMOKE size."""
    if arch == DEEPSEEK_LAYOUT:
        return tuple(dataclasses.replace(pkg.get_smoke_config(MOE), **_LAYOUT)
                     for pkg in (jconfigs, tconfigs))
    return jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)


def _models(arch, seed=0):
    jcfg, tcfg = _smoke(arch)
    jp = _np(JTF.lm_init(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, build_model(tcfg), lm_params_from_numpy(jp, "cpu")


def _prompts(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)


def _assert_caches(tcaches, jcaches):
    assert set(tcaches) == set(jcaches)
    for part, jc in jcaches.items():
        assert len(tcaches[part]) == jc.k.shape[0]
        for i, tc in enumerate(tcaches[part]):
            np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k[i]), **CACHE_TOL)
            np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v[i]), **CACHE_TOL)
            assert tc.length == int(jc.length[i])


@pytest.mark.parametrize("arch,use_pallas", [(a, False) for a in DENSE] + [("yi-6b", True)]
                         + [(a, p) for a in (MOE, DEEPSEEK_LAYOUT) for p in (False, True)])
def test_prefill_and_decode_match_jax(arch, use_pallas):
    jcfg, jp, model, tp = _models(arch)
    jmodel = jbuild_model(jcfg, use_pallas=use_pallas)
    toks = _prompts(jcfg.vocab_size)
    max_len = PROMPT + 3
    jlog, jcaches = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
    ops.reset_launch_counts()
    with torch.no_grad():
        tlog, tcaches = model.prefill(tp, {"tokens": _t(toks).long()}, max_len)
    assert ops.launch_counts()["flash_attention"] == 0          # the CPU path
    assert tlog.shape == (BATCH, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    _assert_caches(tcaches, jcaches)

    step = np.array([[5], [7]], np.int32)
    for i in range(2):
        pos = np.full((BATCH, 1), PROMPT + i, np.int32)
        jlog, jcaches = jmodel.decode(
            jp, {"tokens": jnp.asarray(step), "positions": jnp.asarray(pos)}, jcaches)
        with torch.no_grad():
            tlog, tcaches = model.decode(
                tp, {"tokens": _t(step).long(), "positions": _t(pos).long()}, tcaches)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        _assert_caches(tcaches, jcaches)
        step = step + 1


def _greedy_tokens_match_jax(arch, use_pallas):
    jcfg, jp, model, tp = _models(arch, seed=4)
    jmodel = jbuild_model(jcfg, use_pallas=use_pallas)
    toks = _prompts(jcfg.vocab_size, seed=5)
    max_len = PROMPT + 5
    jlog, jcaches = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
    jtok = [np.asarray(jnp.argmax(jlog[:, -1], axis=-1))]
    for i in range(4):
        pos = jnp.full((BATCH, 1), PROMPT + i, jnp.int32)
        jlog, jcaches = jmodel.decode(
            jp, {"tokens": jnp.asarray(jtok[-1])[:, None].astype(jnp.int32),
                 "positions": pos}, jcaches)
        jtok.append(np.asarray(jnp.argmax(jlog[:, -1], axis=-1)))
    out = tserve.generate(model, tp, _t(toks).long(), 5)
    np.testing.assert_array_equal(out["generated"], np.stack(jtok, axis=1))
    assert out["kernel_launches"]["prefill"]["flash_attention"] == 0
    assert out["logits_finite"]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_tokens_match_jax(use_pallas):
    """Prefill plus 4 greedy decode steps: the same tokens as the same loop
    on the JAX model."""
    _greedy_tokens_match_jax("yi-6b", use_pallas)


@pytest.mark.parametrize("arch", [MOE, DEEPSEEK_LAYOUT])
def test_moe_greedy_tokens_match_jax(arch):
    _greedy_tokens_match_jax(arch, use_pallas=True)


def test_make_caches_match_reference_layout():
    jcfg, _, model, _ = _models("yi-6b")
    want = JTF.lm_make_caches(jcfg, BATCH, 20, jnp.float32)["layers"]
    got = model.make_caches(BATCH, 20, torch.float32)["layers"]
    assert len(got) == jcfg.n_layers
    for c in got:
        assert c.k.shape == c.v.shape == want.k.shape[1:] and c.length == 0
        assert c.k.dtype == torch.float32 and not c.k.any()


def test_moe_make_caches_match_reference_layout():
    """The prefix layers' caches apart, under ``"prefix"``, as the reference's."""
    jcfg, _, model, _ = _models(DEEPSEEK_LAYOUT)
    want = JTF.lm_make_caches(jcfg, BATCH, 20, jnp.float32)
    got = model.make_caches(BATCH, 20, torch.float32)
    assert set(got) == set(want) == {"layers", "prefix"}
    for part in want:
        assert len(got[part]) == want[part].k.shape[0]
        for c in got[part]:
            assert c.k.shape == want[part].k.shape[1:] and c.length == 0


def test_serve_runs_end_to_end_on_cpu():
    """The reference's keys, shapes and token dtype (``repro.launch.serve``
    returns ``generated`` (batch, gen) int32, ``prefill_s``,
    ``decode_s_per_tok``). The reference launcher itself cannot run on the
    installed jax 0.9 (its mesh has explicit axes, which its activation
    constraints refuse; ROADMAP F1), so its loop is held to the port's at the
    model level in ``test_greedy_tokens_match_jax``."""
    got = tserve.serve("yi-6b", smoke=True, batch=2, prompt_len=8, gen=4, device="cpu")
    assert {"generated", "prefill_s", "decode_s_per_tok"} <= set(got)
    assert got["generated"].shape == (2, 4)
    assert got["generated"].dtype == np.int32
    assert (0 <= got["generated"]).all() and (got["generated"] < 128).all()
    assert got["prefill_s"] > 0 and got["decode_s_per_tok"] > 0
    assert got["kernel_launches"]["decode"]["flash_attention"] == 0


def test_serve_moe_runs_end_to_end_on_cpu():
    got = tserve.serve(MOE, smoke=True, batch=2, prompt_len=8, gen=4, device="cpu")
    assert got["generated"].shape == (2, 4) and got["generated"].dtype == np.int32
    assert (0 <= got["generated"]).all() and (got["generated"] < 128).all()
    assert got["logits_finite"]
    assert got["kernel_launches"]["prefill"]["flash_attention"] == 0
    assert got["kernel_launches"]["decode"]["flash_attention"] == 0


def test_serve_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="model_parallel"):
        tserve.serve("yi-6b", smoke=True, batch=1, prompt_len=4, gen=2, device="cpu",
                     model_parallel=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.serve("yi-6b", smoke=True, batch=1, prompt_len=4, gen=2)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "internvl2-2b", "whisper-base",
                                  "zamba2-2.7b", "mamba2-1.3b"])
def test_build_model_raises_for_families_not_ported(arch):
    """deepseek-v2-lite (a MoE) raises for its MLA attention, the others for
    their family; each names the slice that brings it."""
    cfg = tconfigs.get_smoke_config(arch)
    match = "MLA attention is not ported yet.*MLA slice" if cfg.use_mla else \
        f"the {cfg.family} family"
    with pytest.raises(NotImplementedError, match=match):
        build_model(cfg)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", ["yi-6b", "granite-3-2b", MOE])
def test_lm_converter_round_trips_bitwise(arch, dtype):
    cfg = jconfigs.get_smoke_config(arch)
    jp = _np(JTF.lm_init(cfg, jax.random.PRNGKey(6), dtype=dtype))
    tp = lm_params_from_numpy(jp, "cpu")
    want_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert tp["embed"].dtype == want_dtype
    assert len(tp["layers"]) == cfg.n_layers
    np.testing.assert_array_equal(
        tp["layers"][1]["attn"]["wq"].float().numpy(),
        np.asarray(jp["layers"]["attn"]["wq"][1]).astype(np.float32))
    back = lm_params_to_numpy(tp)
    w_leaves, w_def = jax.tree_util.tree_flatten(jp)
    g_leaves, g_def = jax.tree_util.tree_flatten(back)
    assert w_def == g_def
    for w, g in zip(w_leaves, g_leaves):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", [DEEPSEEK_LAYOUT, "deepseek-v2-lite-16b"])
def test_lm_converter_round_trips_prefix_layers_bitwise(arch, dtype):
    """``prefix_layers``, a list of per-layer dicts in both packages, and the
    stacked expert leaves (L, E, ...) split per layer; deepseek-v2-lite's
    own tree (MLA leaves, which the converter passes through) too."""
    cfg = _smoke(arch)[0]
    jp = _np(JTF.lm_init(cfg, jax.random.PRNGKey(7), dtype=dtype))
    tp = lm_params_from_numpy(jp, "cpu")
    assert len(tp["prefix_layers"]) == cfg.first_dense_layers == 1
    assert len(tp["layers"]) == cfg.n_layers - 1
    np.testing.assert_array_equal(
        tp["layers"][-1]["moe"]["w_gate"].float().numpy(),
        np.asarray(jp["layers"]["moe"]["w_gate"][-1]).astype(np.float32))
    assert tp["prefix_layers"][0]["mlp"]["w_up"].shape == (cfg.d_model, cfg.first_dense_d_ff)
    back = lm_params_to_numpy(tp)
    w_leaves, w_def = jax.tree_util.tree_flatten(jp)
    g_leaves, g_def = jax.tree_util.tree_flatten(back)
    assert w_def == g_def
    for w, g in zip(w_leaves, g_leaves):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
