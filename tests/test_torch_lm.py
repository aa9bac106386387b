"""The port's LM serving path (dense, MoE and vlm families, GQA and MLA) against the JAX package's.

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
deepseek-v2-lite's own SMOKE config (``MLA``: MLA attention in every layer,
the prefix layer too) is held against ``use_pallas=False`` only: the
reference's Pallas kernel takes only a v as wide as q (ROADMAP F4). Its bf16
stream (the SMOKE config in bf16 in both packages) is held block by block,
each block of the port on the reference's own input, within rtol 2e-2 and
an atol of one bf16 ulp at the output's largest magnitude: a block's output
is the residual sum of terms each rounded to bf16 at its own scale, and
XLA's and PyTorch's bf16 SiLU round apart on about a fifth of inputs, so a
small output can sit an ulp of the largest term away (the MoE test's bound,
2**-7, is that ulp for terms below 2). End to end, such an ulp can flip a
token's top-2 experts, a near-tie of the router and not a fault of either.
The vlm family (internvl2-2b SMOKE: 8 image patches) is held the same way,
its image embeddings (numpy, from the seed) in front of the prompt in both
packages and its decode positions after them; its bf16 stream block by
block at the same bounds. The ssm and hybrid families are in
``tests/test_torch_hybrid.py``.
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
from repro_torch.models import transformer as TF
from repro_torch.models.model import build_model

DENSE = ["yi-6b", "granite-3-2b", "qwen2.5-14b", "chatglm3-6b"]
MOE = "qwen3-moe-30b-a3b"
# qwen3-moe's SMOKE config with deepseek-v2's prefix layer and shared expert
DEEPSEEK_LAYOUT = "qwen3-moe-30b-a3b+prefix"
MLA = "deepseek-v2-lite-16b"
VLM = "internvl2-2b"
_LAYOUT = dict(first_dense_layers=1, first_dense_d_ff=128, n_shared_experts=1)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_TOL = LOGIT_TOL
BF16_RTOL = 2e-2
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


def _smoke(arch, **changes):
    """(the JAX config, the port's) at ``arch``'s SMOKE size."""
    if arch == DEEPSEEK_LAYOUT:
        changes = {**_LAYOUT, **changes}
        arch = MOE
    return tuple(dataclasses.replace(pkg.get_smoke_config(arch), **changes)
                 for pkg in (jconfigs, tconfigs))


def _models(arch, seed=0, **changes):
    jcfg, tcfg = _smoke(arch, **changes)
    jp = _np(JTF.lm_init(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, jp, build_model(tcfg), lm_params_from_numpy(jp, "cpu")


def _prompts(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)


def _prefill_batch(cfg, toks, seed=8):
    """(the reference's prefill batch, the port's, the decode positions'
    offset): a vlm's image embeddings (B, n_patches, d_model) from a numpy
    seed go into both."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks).long()}
    if cfg.family != "vlm":
        return jb, tb, 0
    img = np.random.default_rng(seed).normal(0, 1, (BATCH, cfg.n_patches, cfg.d_model))
    jb["image_embeds"] = jnp.asarray(img, cfg.jdtype)
    tb["image_embeds"] = _t(np.asarray(jb["image_embeds"], np.float32)).to(
        getattr(torch, cfg.dtype))
    return jb, tb, cfg.n_patches


def _assert_caches(tcaches, jcaches, tol=CACHE_TOL):
    """Every part's caches, field by field (k and v, or MLA's c_kv and
    k_rope), and their lengths."""
    assert set(tcaches) == set(jcaches)
    for part, jc in jcaches.items():
        fields = [f for f in jc._fields if f != "length"]
        assert len(tcaches[part]) == getattr(jc, fields[0]).shape[0]
        for i, tc in enumerate(tcaches[part]):
            assert type(tc).__name__ == type(jc).__name__ and tc._fields == jc._fields
            for f in fields:
                np.testing.assert_allclose(getattr(tc, f).float().numpy(),
                                           np.asarray(getattr(jc, f)[i], np.float32), **tol)
            assert tc.length == int(jc.length[i])


def _prefill_and_decode(arch, use_pallas, steps):
    jcfg, jp, model, tp = _models(arch)
    jmodel = jbuild_model(jcfg, use_pallas=use_pallas)
    toks = _prompts(jcfg.vocab_size)
    jbatch, tbatch, offset = _prefill_batch(jcfg, toks)
    max_len = PROMPT + offset + steps + 1
    jlog, jcaches = jmodel.prefill(jp, jbatch, max_len)
    ops.reset_launch_counts()
    with torch.no_grad():
        tlog, tcaches = model.prefill(tp, tbatch, max_len)
    assert ops.launch_counts()["flash_attention"] == 0          # the CPU path
    assert tlog.shape == (BATCH, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    _assert_caches(tcaches, jcaches)

    step = np.array([[5], [7]], np.int32)
    for i in range(steps):
        pos = np.full((BATCH, 1), PROMPT + offset + i, np.int32)
        jlog, jcaches = jmodel.decode(
            jp, {"tokens": jnp.asarray(step), "positions": jnp.asarray(pos)}, jcaches)
        with torch.no_grad():
            tlog, tcaches = model.decode(
                tp, {"tokens": _t(step).long(), "positions": _t(pos).long()}, tcaches)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        _assert_caches(tcaches, jcaches)
        step = step + 1
    return tcaches


@pytest.mark.parametrize("arch,use_pallas", [(a, False) for a in DENSE] + [("yi-6b", True)]
                         + [(a, p) for a in (MOE, DEEPSEEK_LAYOUT, VLM) for p in (False, True)])
def test_prefill_and_decode_match_jax(arch, use_pallas):
    _prefill_and_decode(arch, use_pallas, steps=2)


def test_mla_prefill_and_decode_match_jax():
    """deepseek-v2-lite at its SMOKE size: MLA in the prefix layer and the
    MoE layers, the absorbed decode, 3 steps; the ``"prefix"`` caches are
    ``MLACache``s too."""
    caches = _prefill_and_decode(MLA, False, steps=3)
    assert set(caches) == {"layers", "prefix"}
    assert all(isinstance(c, TA.MLACache) for part in caches.values() for c in part)


def _assert_bf16_close(got, want):
    """Within rtol 2e-2 and one bf16 ulp at ``want``'s largest magnitude."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=ulp)


def test_mla_bf16_prefill_and_decode_match_jax():
    """The same in bf16 (weights, activations and caches) in both packages,
    block by block: the prefill, then 2 decode steps, each block of the
    port fed the reference's input to that block and its own caches."""
    jcfg, jp, _, tp = _models(MLA, dtype="bfloat16")
    tcfg = _smoke(MLA, dtype="bfloat16")[1]
    n_prefix = jcfg.first_dense_layers
    jlayers = list(jp["prefix_layers"]) + [
        jax.tree_util.tree_map(lambda a, i=i: a[i], jp["layers"])
        for i in range(jcfg.n_layers - n_prefix)]
    tlayers = tp["prefix_layers"] + tp["layers"]
    toks = _prompts(jcfg.vocab_size)
    steps = [(toks, np.arange(PROMPT)[None, :])] + [
        (np.array([[5 + i], [7 + i]], np.int32), np.full((BATCH, 1), PROMPT + i, np.int32))
        for i in range(2)]
    jcaches, tcaches = [None] * jcfg.n_layers, [None] * jcfg.n_layers
    with torch.no_grad():
        for call, (tok, pos) in enumerate(steps):
            jh = JTF._embed_h(jcfg, jp, jnp.asarray(tok))
            max_len = PROMPT + 3 if call == 0 else None
            for i, (jl, tl) in enumerate(zip(jlayers, tlayers)):
                th = _t(np.asarray(jh, np.float32)).to(torch.bfloat16)
                jh, jcaches[i], _ = JTF._block(jcfg, jl, jh, jnp.asarray(pos),
                                              moe_layer=i >= n_prefix, cache=jcaches[i],
                                              cache_max_len=max_len)
                th, tcaches[i], _ = TF._block(tcfg, tl, th, _t(pos).long(), cache=tcaches[i],
                                             cache_max_len=max_len)
                assert th.dtype == tcaches[i].c_kv.dtype == torch.bfloat16
                _assert_bf16_close(th, jh)
                for f in ("c_kv", "k_rope"):
                    _assert_bf16_close(getattr(tcaches[i], f), getattr(jcaches[i], f))
                assert tcaches[i].length == int(jcaches[i].length)


def _greedy_tokens_match_jax(arch, use_pallas):
    jcfg, jp, model, tp = _models(arch, seed=4)
    jmodel = jbuild_model(jcfg, use_pallas=use_pallas)
    toks = _prompts(jcfg.vocab_size, seed=5)
    jbatch, tbatch, offset = _prefill_batch(jcfg, toks)
    max_len = PROMPT + offset + 5
    jlog, jcaches = jmodel.prefill(jp, jbatch, max_len)
    jtok = [np.asarray(jnp.argmax(jlog[:, -1], axis=-1))]
    for i in range(4):
        pos = jnp.full((BATCH, 1), PROMPT + offset + i, jnp.int32)
        jlog, jcaches = jmodel.decode(
            jp, {"tokens": jnp.asarray(jtok[-1])[:, None].astype(jnp.int32),
                 "positions": pos}, jcaches)
        jtok.append(np.asarray(jnp.argmax(jlog[:, -1], axis=-1)))
    out = tserve.generate(model, tp, _t(toks).long(), 5,
                          image_embeds=tbatch.get("image_embeds"))
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


def test_mla_greedy_tokens_match_jax():
    _greedy_tokens_match_jax(MLA, use_pallas=False)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_vlm_greedy_tokens_match_jax(use_pallas):
    """The image embeddings through ``generate``: the cache holds the
    patches and the decode positions start after them."""
    _greedy_tokens_match_jax(VLM, use_pallas)


def test_make_caches_match_reference_layout(arch="yi-6b"):
    jcfg, _, model, _ = _models(arch)
    want = JTF.lm_make_caches(jcfg, BATCH, 20, jnp.float32)["layers"]
    got = model.make_caches(BATCH, 20, torch.float32)["layers"]
    assert len(got) == jcfg.n_layers
    for c in got:
        assert c.k.shape == c.v.shape == want.k.shape[1:] and c.length == 0
        assert c.k.dtype == torch.float32 and not c.k.any()


def test_vlm_make_caches_match_reference_layout():
    """The vlm's caches are the dense layout; the patches take cache slots."""
    test_make_caches_match_reference_layout(VLM)


@pytest.mark.parametrize("arch", [DEEPSEEK_LAYOUT, MLA])
def test_moe_make_caches_match_reference_layout(arch):
    """The prefix layers' caches apart, under ``"prefix"``, as the
    reference's; MLA's hold the latent and k_rope."""
    jcfg, _, model, _ = _models(arch)
    want = JTF.lm_make_caches(jcfg, BATCH, 20, jnp.float32)
    got = model.make_caches(BATCH, 20, torch.float32)
    assert set(got) == set(want) == {"layers", "prefix"}
    for part in want:
        fields = [f for f in want[part]._fields if f != "length"]
        assert len(got[part]) == getattr(want[part], fields[0]).shape[0]
        for c in got[part]:
            assert c._fields == want[part]._fields and c.length == 0
            for f in fields:
                assert getattr(c, f).shape == getattr(want[part], f).shape[1:]


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


@pytest.mark.parametrize("arch", [MOE, MLA])
def test_serve_moe_runs_end_to_end_on_cpu(arch):
    got = tserve.serve(arch, smoke=True, batch=2, prompt_len=8, gen=4, device="cpu")
    assert got["generated"].shape == (2, 4) and got["generated"].dtype == np.int32
    assert (0 <= got["generated"]).all() and (got["generated"] < 128).all()
    assert got["logits_finite"]
    assert got["kernel_launches"]["prefill"]["flash_attention"] == 0
    assert got["kernel_launches"]["decode"]["flash_attention"] == 0


def test_serve_vlm_runs_end_to_end_on_cpu():
    """``serve`` draws the image embeddings from its numpy generator after
    the prompts, as the reference's launcher does: its weights (the port's
    init from the seed) and those draws through the reference's loop on the
    JAX model (cache ``prompt + gen + n_patches``, decode positions after
    the patches) give the same tokens."""
    got = tserve.serve(VLM, smoke=True, batch=2, prompt_len=8, gen=4, device="cpu", seed=3)
    assert got["generated"].shape == (2, 4) and got["generated"].dtype == np.int32
    assert got["logits_finite"]
    assert got["kernel_launches"]["prefill"]["flash_attention"] == 0
    jcfg, tcfg = _smoke(VLM)
    params = build_model(tcfg).init(torch.Generator().manual_seed(3))
    jp = lm_params_to_numpy(params)
    rng = np.random.default_rng(3)
    toks = jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 8)), jnp.int32)
    img = jnp.asarray(rng.normal(0, 1, (2, jcfg.n_patches, jcfg.d_model)), jcfg.jdtype)
    jmodel = jbuild_model(jcfg)
    jlog, jcaches = jmodel.prefill(jp, {"tokens": toks, "image_embeds": img},
                                   8 + 4 + jcfg.n_patches)
    want = [np.asarray(jnp.argmax(jlog[:, -1], axis=-1))]
    for i in range(3):
        pos = jnp.full((2, 1), 8 + jcfg.n_patches + i, jnp.int32)
        jlog, jcaches = jmodel.decode(
            jp, {"tokens": jnp.asarray(want[-1])[:, None].astype(jnp.int32),
                 "positions": pos}, jcaches)
        want.append(np.asarray(jnp.argmax(jlog[:, -1], axis=-1)))
    np.testing.assert_array_equal(got["generated"], np.stack(want, axis=1))


def test_vlm_bf16_prefill_and_decode_match_jax():
    """internvl2 SMOKE in bf16 in both packages, block by block: the image
    embeddings and the prompt through the prefill, then 2 decode steps,
    each block of the port fed the reference's input to it and its own KV
    cache."""
    jcfg, jp, _, tp = _models(VLM, dtype="bfloat16")
    tcfg = _smoke(VLM, dtype="bfloat16")[1]
    jlayers = [jax.tree_util.tree_map(lambda a, i=i: a[i], jp["layers"])
               for i in range(jcfg.n_layers)]
    toks = _prompts(jcfg.vocab_size)
    jbatch, tbatch, offset = _prefill_batch(jcfg, toks)
    assert tbatch["image_embeds"].dtype == torch.bfloat16
    steps = [(toks, np.arange(PROMPT + offset)[None, :])] + [
        (np.array([[5 + i], [7 + i]], np.int32),
         np.full((BATCH, 1), PROMPT + offset + i, np.int32)) for i in range(2)]
    jcaches, tcaches = [None] * jcfg.n_layers, [None] * jcfg.n_layers
    with torch.no_grad():
        for call, (tok, pos) in enumerate(steps):
            jh = JTF._embed_h(jcfg, jp, jnp.asarray(tok))
            if call == 0:
                jh = jnp.concatenate([jbatch["image_embeds"], jh], axis=1)
            max_len = PROMPT + offset + 3 if call == 0 else None
            for i, (jl, tl) in enumerate(zip(jlayers, tp["layers"])):
                th = _t(np.asarray(jh, np.float32)).to(torch.bfloat16)
                jh, jcaches[i], _ = JTF._block(jcfg, jl, jh, jnp.asarray(pos), moe_layer=False,
                                              cache=jcaches[i], cache_max_len=max_len)
                th, tcaches[i], _ = TF._block(tcfg, tl, th, _t(pos).long(), cache=tcaches[i],
                                             cache_max_len=max_len)
                assert th.dtype == tcaches[i].k.dtype == torch.bfloat16
                _assert_bf16_close(th, jh)
                for f in ("k", "v"):
                    _assert_bf16_close(getattr(tcaches[i], f), getattr(jcaches[i], f))
                assert tcaches[i].length == int(jcaches[i].length)


def test_serve_refuses_what_is_not_ported():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.serve("yi-6b", smoke=True, batch=1, prompt_len=4, gen=2)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", ["yi-6b", "granite-3-2b", MOE, MLA, VLM])
def test_lm_converter_round_trips_bitwise(arch, dtype):
    """deepseek-v2-lite: the MLA leaves (wq, w_dkv, kv_norm, w_uk, w_uv, wo)
    of the stacked layers and of the prefix layer."""
    cfg = jconfigs.get_smoke_config(arch)
    jp = _np(JTF.lm_init(cfg, jax.random.PRNGKey(6), dtype=dtype))
    tp = lm_params_from_numpy(jp, "cpu")
    want_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert tp["embed"].dtype == want_dtype
    n_prefix = cfg.first_dense_layers if cfg.family == "moe" else 0
    assert len(tp["layers"]) == cfg.n_layers - n_prefix
    if cfg.use_mla:
        assert set(tp["layers"][1]["attn"]) == set(tp["prefix_layers"][0]["attn"]) == {
            "wq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}
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
