"""The port's encoder-decoder (whisper) against the JAX package's.

Same numpy weights (the reference's ``encdec_init``, converted with
``repro_torch.convert.lm_params_from_numpy``; the cross-attention's and the
MLP's biases moved off their zero inits) and the same inputs, made from a
numpy seed, through both packages on the CPU, at whisper-base's SMOKE config
(2 + 2 layers, d_model 64, 4 heads of 16, 16 frames):

* ``_sinusoid``, ``gelu_mlp_apply``, ``cross_attn_apply`` (S = 1, a decode
  step's, and S = 12), ``encode``, ``decode_stack``, ``encdec_prefill`` and
  3 ``encdec_decode`` steps (logits and every cache, ``memory`` too), and
  the greedy tokens of ``generate``: fp32 within rtol 1e-5 / atol 1e-5
  (sums of a few hundred terms in another order), against the reference's
  ``use_pallas=False`` and ``use_pallas=True`` (its Pallas K6 in interpret
  mode; whisper's scale is 1/sqrt(head_dim), which that path takes);
* the tanh GELU in bf16 equal to ``jax.nn.gelu(approximate=True)`` bit for
  bit, and the bf16 model block by block (every encoder and decoder block
  of the port fed the reference's input to it) within rtol 2e-2 and one
  bf16 ulp at the output's largest magnitude, the bound of
  ``tests/test_torch_lm.py``;
* ``make_caches`` and the init's layout against the reference's, the
  converter's round trip bit for bit in fp32 and bf16, ``serve`` on the
  CPU (its frames drawn after the prompts from the seed's generator, held
  to numpy directly, as the reference's launcher fails on the installed
  jax, ROADMAP F5), and ``build_model`` for every family of the registry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models.model import build_model as jbuild_model
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model

ARCH = "whisper-base"
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, PROMPT, STEPS = 2, 12, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return _t(np.asarray(a, np.float32)).to(torch.bfloat16)


def _cfgs(**changes):
    return tuple(dataclasses.replace(pkg.get_smoke_config(ARCH), **changes)
                 for pkg in (jconfigs, tconfigs))


def _biased(jp, seed):
    """The reference's init with every bias drawn from a numpy seed (zeros
    would hide a bias on the wrong projection)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key in ("bq", "bv", "bo", "b_in", "b_out", "bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, jp)


def _models(seed=0, **changes):
    jcfg, tcfg = _cfgs(**changes)
    jp = _biased(_np(JED.encdec_init(jcfg, jax.random.PRNGKey(seed))), seed)
    return jcfg, tcfg, jp, lm_params_from_numpy(jp, "cpu")


def _frames(cfg, seed=1):
    return np.random.default_rng(seed).normal(0, 1, (BATCH, cfg.n_frames, cfg.d_model)).astype(
        np.float32)


def _prompts(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)


def _layer(stacked, i):
    return jax.tree_util.tree_map(lambda a: a[i], stacked)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 64, 512])
@pytest.mark.parametrize("positions", [np.arange(1500)[None, :], np.array([[7], [1499]])])
def test_sinusoid_matches_jax(positions, d):
    """Prefill positions (1, S) and decode positions (B, 1), the
    ``max(half - 1, 1)`` denominator included (d = 2). The frequencies are
    the reference's exponents' exps rounded once from float64; XLA's float32
    exp sits an ulp from that on a few, which moves an angle by up to an ulp
    of itself: within 2 ulps of the largest angle (2.4e-4 at 1,499) and
    float32's sin/cos rounding."""
    got = TED._sinusoid(_t(positions), d)
    want = JED._sinusoid(jnp.asarray(positions), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    half = d // 2
    expo = (np.float32(-np.log(10000.0)) * np.arange(half, dtype=np.float32)
            / np.float32(max(half - 1, 1)))
    freq = np.exp(expo.astype(np.float64)).astype(np.float32)
    ang = positions[..., None].astype(np.float32) * freq
    bound = 2.0 ** (np.floor(np.log2(max(positions.max(), 1))) - 22) + 2e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=bound)
    np.testing.assert_allclose(got.numpy(), np.concatenate([np.sin(ang), np.cos(ang)], -1),
                               rtol=0, atol=2e-6)


def test_gelu_tanh_is_xla_bitwise_in_bf16():
    """The port's tanh GELU rounds as XLA rounds ``jax.nn.gelu(approximate=
    True)``: the reference's bits on every one of 2**16 bf16 inputs from
    N(0, 2**2); ``F.gelu(approximate="tanh")``, which rounds once, differs on
    a large share of them. In fp32 within an ulp-level bound."""
    x = np.random.default_rng(0).normal(0, 2, 1 << 16).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.nn.gelu(xj, approximate=True), np.float32)
    xt = _bf16(xj)
    got = TL.gelu_tanh(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (F.gelu(xt, approximate="tanh").float().numpy() != want).mean() > 0.3
    np.testing.assert_allclose(TL.gelu_tanh(_t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_apply_matches_jax(dtype):
    jcfg, tcfg, jp, tp = _models(dtype=dtype)
    p = _layer(jp["enc_layers"]["mlp"], 1)
    x = np.random.default_rng(5).normal(0, 1, (BATCH, 9, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.jdtype)
    want = JL.gelu_mlp_apply(p, jx)
    got = TL.gelu_mlp_apply(tp["enc_layers"][1]["mlp"], _bf16(jx) if dtype == "bfloat16"
                            else _t(x))
    assert str(got.dtype) == f"torch.{dtype}"
    if dtype == "float32":
        _close(got, want)
    else:
        _assert_bf16_close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("s", [1, 12])
def test_cross_attn_apply_matches_jax(s, use_pallas):
    """Queries from S decoder positions (1: a decode step's) over the
    encoder's memory; biases on q, v and o, none on k."""
    jcfg, tcfg, jp, tp = _models()
    p = _layer(jp["dec_layers"]["cross"], 0)
    assert set(p) == {"wq", "wk", "wv", "wo", "bq", "bv", "bo"}
    rng = np.random.default_rng(s)
    x = rng.normal(0, 1, (BATCH, s, jcfg.d_model)).astype(np.float32)
    memory = rng.normal(0, 1, (BATCH, jcfg.n_frames, jcfg.d_model)).astype(np.float32)
    want = JA.cross_attn_apply(p, jcfg, jnp.asarray(x), jnp.asarray(memory),
                               use_pallas=use_pallas)
    ops.reset_launch_counts()
    got = TA.cross_attn_apply(tp["dec_layers"][0]["cross"], tcfg, _t(x), _t(memory))
    assert ops.launch_counts()["flash_attention"] == 0          # the CPU path
    assert tuple(got.shape) == (BATCH, s, jcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_encode_matches_jax(use_pallas):
    jcfg, tcfg, jp, tp = _models()
    frames = _frames(jcfg)
    want = JED.encode(jcfg, jp, jnp.asarray(frames), use_pallas=use_pallas)
    with torch.no_grad():
        got = TED.encode(tcfg, tp, _t(frames))
    assert tuple(got.shape) == (BATCH, jcfg.n_frames, jcfg.d_model)
    _close(got, want)
    # the bf16 block test's transcription of the reference's scan body
    jh = jnp.asarray(frames) + JED._sinusoid(jnp.arange(jcfg.n_frames)[None, :], jcfg.d_model)
    for i in range(jcfg.n_enc_layers):
        jh = _jax_enc_block(jcfg, _layer(jp["enc_layers"], i), jh)
    _close(_t(JL.apply_norm(jh, jp["enc_norm"], "layernorm")), want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_decode_stack_matches_jax(use_pallas):
    """The decoder alone on the reference's memory: sinusoidal positions
    and RoPE, the KV caches it publishes."""
    jcfg, tcfg, jp, tp = _models(seed=2)
    memory = np.asarray(JED.encode(jcfg, jp, jnp.asarray(_frames(jcfg))))
    toks = _prompts(jcfg.vocab_size)
    pos = np.arange(PROMPT)[None, :]
    want, jcaches = JED.decode_stack(jcfg, jp, jnp.asarray(toks), jnp.asarray(memory),
                                     jnp.asarray(pos), cache_max_len=PROMPT + 2,
                                     use_pallas=use_pallas)
    with torch.no_grad():
        got, tcaches = TED.decode_stack(tcfg, tp, _t(toks).long(), _t(memory), _t(pos),
                                        cache_max_len=PROMPT + 2)
    _close(got, want)
    _assert_caches({"self": tcaches}, {"self": jcaches})


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _assert_caches(tc, jc, tol=TOL):
    """The port's ``{"self": [KVCache] * L, "memory"?}`` against the
    reference's stacked KV caches and its memory; lengths equal."""
    assert set(tc) == set(jc)
    assert len(tc["self"]) == jc["self"].k.shape[0]
    for i, c in enumerate(tc["self"]):
        assert isinstance(c, TA.KVCache)
        for f in ("k", "v"):
            assert tuple(getattr(c, f).shape) == getattr(jc["self"], f).shape[1:]
            _close(getattr(c, f), getattr(jc["self"], f)[i], tol)
        assert c.length == int(jc["self"].length[i])
    if "memory" in jc:
        _close(tc["memory"], jc["memory"], tol)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_jax(use_pallas):
    jcfg, tcfg, jp, tp = _models()
    jmodel, model = jbuild_model(jcfg, use_pallas=use_pallas), build_model(tcfg)
    frames, toks = _frames(jcfg), _prompts(jcfg.vocab_size)
    max_len = PROMPT + STEPS + 1
    jlog, jcaches = jmodel.prefill(jp, {"frames": jnp.asarray(frames),
                                        "tokens": jnp.asarray(toks)}, max_len)
    ops.reset_launch_counts()
    with torch.no_grad():
        tlog, tcaches = model.prefill(tp, {"frames": _t(frames), "tokens": _t(toks).long()},
                                      max_len)
    assert ops.launch_counts()["flash_attention"] == 0          # the CPU path
    assert tuple(tlog.shape) == (BATCH, 1, jcfg.vocab_size)
    _close(tlog, jlog)
    _assert_caches(tcaches, jcaches)
    step = np.array([[5], [7]], np.int32)
    for i in range(STEPS):
        pos = np.full((BATCH, 1), PROMPT + i, np.int32)
        jlog, jcaches = jmodel.decode(
            jp, {"tokens": jnp.asarray(step), "positions": jnp.asarray(pos)}, jcaches)
        with torch.no_grad():
            tlog, tcaches = model.decode(
                tp, {"tokens": _t(step).long(), "positions": _t(pos).long()}, tcaches)
        _close(tlog, jlog)
        _assert_caches(tcaches, jcaches)
        step = step + 1


def _jax_greedy(jcfg, jp, toks, frames, gen, use_pallas=False):
    jmodel = jbuild_model(jcfg, use_pallas=use_pallas)
    jlog, jcaches = jmodel.prefill(jp, {"frames": jnp.asarray(frames, jcfg.jdtype),
                                        "tokens": jnp.asarray(toks)}, toks.shape[1] + gen)
    out = [np.asarray(jnp.argmax(jlog[:, -1], axis=-1))]
    for i in range(gen - 1):
        pos = jnp.full((toks.shape[0], 1), toks.shape[1] + i, jnp.int32)
        jlog, jcaches = jmodel.decode(
            jp, {"tokens": jnp.asarray(out[-1])[:, None].astype(jnp.int32),
                 "positions": pos}, jcaches)
        out.append(np.asarray(jnp.argmax(jlog[:, -1], axis=-1)))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_tokens_match_jax(use_pallas):
    """Prefill plus 4 greedy decode steps through ``generate(frames=...)``:
    the same tokens as the same loop on the JAX model."""
    jcfg, tcfg, jp, tp = _models(seed=4)
    toks, frames = _prompts(jcfg.vocab_size, seed=5), _frames(jcfg, seed=6)
    out = tserve.generate(build_model(tcfg), tp, _t(toks).long(), 5, frames=_t(frames))
    np.testing.assert_array_equal(out["generated"],
                                  _jax_greedy(jcfg, jp, toks, frames, 5, use_pallas))
    assert out["kernel_launches"]["prefill"]["flash_attention"] == 0
    assert out["logits_finite"]


def _assert_bf16_close(got, want):
    """Within rtol 2e-2 and one bf16 ulp at ``want``'s largest magnitude."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=ulp)


def _jax_enc_block(cfg, lp, h):
    """One step of the reference encoder's layer scan (``encode``'s ``one``),
    from the reference's own functions."""
    x = JL.apply_norm(h, lp["attn_norm"], "layernorm")
    b, s, _ = x.shape
    q, k, v = ((x @ lp["attn"][w]).reshape(b, s, cfg.n_heads, cfg.hd).swapaxes(1, 2)
               for w in ("wq", "wk", "wv"))
    o = JA.chunked_attention(q, k, v, causal=False, scale=cfg.hd ** -0.5)
    h = h + o.swapaxes(1, 2).reshape(b, s, -1) @ lp["attn"]["wo"]
    return h + JL.gelu_mlp_apply(lp["mlp"], JL.apply_norm(h, lp["mlp_norm"], "layernorm"))


def test_bf16_blocks_match_jax():
    """whisper SMOKE in bf16 in both packages, block by block: each encoder
    block on the reference's input to it (``_jax_enc_block``, the reference's
    scan body), then each decoder block on
    the reference's input and memory, with its own KV cache, through the
    prefill and 2 decode steps; the tied head on the reference's last h."""
    jcfg, tcfg, jp, tp = _models(dtype="bfloat16")
    frames = _frames(jcfg)
    with torch.no_grad():
        jh = jnp.asarray(frames, jnp.bfloat16)
        jh = jh + JED._sinusoid(jnp.arange(jcfg.n_frames)[None, :], jcfg.d_model).astype(
            jnp.bfloat16)
        th = TED._sinusoid(torch.arange(jcfg.n_frames)[None, :], tcfg.d_model)
        _assert_bf16_close(_bf16(frames) + th.to(torch.bfloat16), jh)
        for i, tl in enumerate(tp["enc_layers"]):
            th = TED._enc_block(tcfg, tl, _bf16(jh))
            jh = _jax_enc_block(jcfg, _layer(jp["enc_layers"], i), jh)
            assert th.dtype == torch.bfloat16
            _assert_bf16_close(th, jh)
        memory = JL.apply_norm(jh, jp["enc_norm"], "layernorm")
        tmem = _bf16(memory)

        toks = _prompts(jcfg.vocab_size)
        steps = [(toks, np.arange(PROMPT)[None, :])] + [
            (np.array([[5 + i], [7 + i]], np.int32), np.full((BATCH, 1), PROMPT + i, np.int32))
            for i in range(2)]
        jc, tc = [None] * jcfg.n_layers, [None] * jcfg.n_layers
        for call, (tok, pos) in enumerate(steps):
            max_len = PROMPT + 3 if call == 0 else None
            jh = jnp.asarray(jp["embed"])[jnp.asarray(tok)].astype(jnp.bfloat16)
            jh = jh + JED._sinusoid(jnp.asarray(pos), jcfg.d_model).astype(jnp.bfloat16)
            for i, tl in enumerate(tp["dec_layers"]):
                th, tc[i] = TED._dec_block(tcfg, tl, _bf16(jh), tmem, _t(pos).long(),
                                           cache=tc[i], cache_max_len=max_len)
                jh, jc[i] = JED._dec_block(jcfg, _layer(jp["dec_layers"], i), jh, memory,
                                           jnp.asarray(pos), cache=jc[i], cache_max_len=max_len)
                assert th.dtype == tc[i].k.dtype == torch.bfloat16
                assert tc[i].length == int(jc[i].length)
                _assert_bf16_close(th, jh)
                _assert_bf16_close(tc[i].k, jc[i].k)
                _assert_bf16_close(tc[i].v, jc[i].v)
            jlog = JL.apply_norm(jh, jp["dec_norm"], "layernorm") @ jp["embed"].T
            tlog = TL.apply_norm(_bf16(jh), tp["dec_norm"], "layernorm") @ tp["embed"].t()
            _assert_bf16_close(tlog, jlog)


def test_make_caches_and_init_match_reference_layout():
    """``make_caches``: ``self`` one zeroed ``KVCache`` per decoder layer,
    ``memory`` (B, n_frames, d_model), the reference's shapes and dtypes;
    the port's own init (from a torch generator) the reference's keys and
    shapes per layer."""
    jcfg, tcfg, jp, _ = _models()
    want = jbuild_model(jcfg).make_caches(BATCH, 20, jnp.bfloat16)
    model = build_model(tcfg)
    got = model.make_caches(BATCH, 20, torch.bfloat16)
    assert set(got) == set(want) == {"self", "memory"}
    assert len(got["self"]) == want["self"].k.shape[0] == jcfg.n_layers
    for c in got["self"]:
        assert isinstance(c, TA.KVCache) and c.length == 0
        assert tuple(c.k.shape) == want["self"].k.shape[1:] and c.k.dtype == torch.bfloat16
        assert not c.k.any() and not c.v.any()
    assert tuple(got["memory"].shape) == want["memory"].shape
    assert got["memory"].dtype == torch.bfloat16 and not got["memory"].any()

    init = model.init(torch.Generator().manual_seed(0))
    assert set(init) == set(jp)
    for key in ("enc_layers", "dec_layers"):
        assert len(init[key]) == jp[key]["attn"]["wq"].shape[0]
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp[key])[0]:
            got_leaf = init[key][1]
            for part in path:
                got_leaf = got_leaf[part.key]
            assert tuple(got_leaf.shape) == leaf.shape[1:], path
    assert tuple(init["embed"].shape) == jp["embed"].shape


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_lm_converter_round_trips_bitwise(dtype):
    """``enc_layers`` and ``dec_layers`` (L, ...) become one dict per layer;
    back again bit for bit."""
    cfg = jconfigs.get_smoke_config(ARCH)
    jp = _np(JED.encdec_init(cfg, jax.random.PRNGKey(6), dtype=dtype))
    tp = lm_params_from_numpy(jp, "cpu")
    assert tp["embed"].dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    assert len(tp["enc_layers"]) == cfg.n_enc_layers and len(tp["dec_layers"]) == cfg.n_layers
    assert set(tp["dec_layers"][1]) == {"attn_norm", "attn", "cross_norm", "cross", "mlp_norm",
                                        "mlp"}
    np.testing.assert_array_equal(tp["dec_layers"][1]["cross"]["wk"].float().numpy(),
                                  np.asarray(jp["dec_layers"]["cross"]["wk"][1], np.float32))
    back = lm_params_to_numpy(tp)
    w_leaves, w_def = jax.tree_util.tree_flatten(jp)
    g_leaves, g_def = jax.tree_util.tree_flatten(back)
    assert w_def == g_def
    for w, g in zip(w_leaves, g_leaves):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def test_serve_runs_end_to_end_on_cpu():
    """``serve`` on the CPU: the reference's keys and shapes; its frames are
    numpy's normal draws after the prompts from the seed's generator, as the
    reference's launcher draws them; its weights (the port's init from the
    seed) and those inputs through the reference's loop on the JAX model
    give the same tokens. No K6 launch on the CPU."""
    got = tserve.serve(ARCH, smoke=True, batch=2, prompt_len=8, gen=4, device="cpu", seed=3)
    assert {"generated", "prefill_s", "decode_s_per_tok"} <= set(got)
    assert got["generated"].shape == (2, 4) and got["generated"].dtype == np.int32
    assert got["logits_finite"] and got["prefill_s"] > 0 and got["decode_s_per_tok"] > 0
    assert got["kernel_launches"]["prefill"]["flash_attention"] == 0
    assert got["kernel_launches"]["decode"]["flash_attention"] == 0

    cfg = tconfigs.get_smoke_config(ARCH)
    prompts, extra = tserve.draw_inputs(cfg, 2, 8, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 8))
    frames = rng.normal(0, 1, (2, cfg.n_frames, cfg.d_model))
    assert set(extra) == {"frames"}
    np.testing.assert_array_equal(prompts.numpy(), toks)
    np.testing.assert_array_equal(extra["frames"].numpy(), frames.astype(np.float32))
    params = build_model(cfg).init(torch.Generator().manual_seed(3))
    want = _jax_greedy(jconfigs.get_smoke_config(ARCH), lm_params_to_numpy(params),
                       toks.astype(np.int32), frames, 4)
    np.testing.assert_array_equal(got["generated"], want)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_build_model_builds_every_family(arch):
    """Every family of the registry builds (encdec too, now ported): init,
    prefill, decode and make_caches; an unknown family raises."""
    cfg = tconfigs.get_smoke_config(arch)
    model = build_model(cfg)
    assert model.cfg is cfg
    assert all(callable(f) for f in (model.init, model.prefill, model.decode,
                                      model.make_caches))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="rnn"))
