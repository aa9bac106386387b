"""The port's Mamba2 block and its ssm and hybrid LMs against the JAX package's.

Same numpy weights (the reference's ``ssm_init``, ``ssm_lm_init`` and
``hybrid_init``, converted with ``repro_torch.convert.lm_params_from_numpy``
for the models) and the same inputs, made from a numpy seed, through both
packages on the CPU, at the SMOKE configs of mamba2-1.3b and zamba2-2.7b
(d_model 64: 8 SSM heads of 16, state 16, chunk 8, conv 4):

* ``ssm_apply``'s prefill at T = 1 and 3 (below the conv's K - 1 = 3 and at
  it), 13 (padded to two chunks of 8) and 16 (two whole chunks), with one
  group and two, then 3 decode steps: output and every ``SSMCache`` field
  within rtol 1e-5 / atol 1e-5 (fp32 sums in another order); in bf16
  against the reference's bf16 block at the bounds of
  ``tests/test_torch_ssm.py`` (rtol 2e-2, atol 1e-3): the projections,
  conv and gating round to bf16 on both sides, the state and the decay stay
  float32, and ``x * dt`` promotes to float32 in both;
* the models' prefill and 3 decode steps, logits and every cache (the
  hybrid's KV caches per application of its shared block too), with the
  reference's ``use_pallas`` False and True (its Pallas K6 in interpret
  mode; the shared block's scale is 1/sqrt(head_dim), which that path
  takes), and the greedy tokens of ``generate`` against the reference's
  loop;
* the bf16 models block by block, each block of the port fed the
  reference's input to it, within rtol 2e-2 and one bf16 ulp at the
  output's largest magnitude (the bound of ``tests/test_torch_lm.py``);
* each family's ``make_caches`` layout against the reference's, the
  converter's round trip bit for bit in fp32 and bf16, and ``serve`` on the
  CPU end to end against the reference's loop on the same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import hybrid as JHY
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import ssm_lm as JSL
from repro.models.model import build_model as jbuild_model
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import hybrid as THY
from repro_torch.models import ssm as TS
from repro_torch.models import ssm_lm as TSL
from repro_torch.models.model import build_model

SSM, HYBRID = "mamba2-1.3b", "zamba2-2.7b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=1e-3)
BATCH, PROMPT = 2, 13


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    return _t(np.asarray(a, np.float32)).to(torch.bfloat16)


def _cfgs(arch, **changes):
    return tuple(dataclasses.replace(pkg.get_smoke_config(arch), **changes)
                 for pkg in (jconfigs, tconfigs))


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def _block_params(jcfg, dtype, seed):
    """The reference's ``ssm_init`` with a_log, dt_bias, d_skip, conv_b and
    out_norm moved off their constant inits, as numpy; float32 leaves stay
    float32 in bf16 (a_log, dt_bias, d_skip)."""
    jp = _np(JS.ssm_init(jax.random.PRNGKey(seed), jcfg, dtype))
    rng = np.random.default_rng(seed)
    for k, (mu, sd) in (("a_log", (0, 0.5)), ("dt_bias", (0, 0.5)), ("d_skip", (1, 0.3)),
                        ("conv_b", (0, 0.1)), ("out_norm", (1, 0.1))):
        jp[k] = (rng.normal(mu, sd, jp[k].shape).astype(np.float32)).astype(jp[k].dtype)
    return jp


def _port_tree(jp):
    return {k: (_bf16(v) if v.dtype.name == "bfloat16" else _t(v)) for k, v in jp.items()}


def _assert_ssm_cache(tc, jc, tol):
    assert isinstance(tc, TS.SSMCache) and tc._fields == jc._fields
    assert tc.state.dtype == torch.float32 and tc.state.shape == jc.state.shape
    assert tc.conv.shape == jc.conv.shape
    np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state), **tol)
    np.testing.assert_allclose(tc.conv.float().numpy(), np.asarray(jc.conv, np.float32), **tol)


def _block_run(jcfg, tcfg, t_len, dtype, tol, seed):
    jp = _block_params(jcfg, dtype, seed)
    tp = _port_tree(jp)
    rng = np.random.default_rng(seed + 1)
    to_port = _bf16 if dtype == jnp.bfloat16 else _t
    steps = [rng.normal(0, 1, (BATCH, t_len, jcfg.d_model))] + [
        rng.normal(0, 1, (BATCH, 1, jcfg.d_model)) for _ in range(3)]
    jcache = tcache = None
    for u in steps:
        u = u.astype(np.float32)
        jout, jcache = JS.ssm_apply(jp, jcfg, jnp.asarray(u, dtype), cache=jcache)
        with torch.no_grad():
            tout, tcache = TS.ssm_apply(tp, tcfg, to_port(u), cache=tcache)
        assert tout.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        assert tout.shape == jout.shape
        np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32), **tol)
        _assert_ssm_cache(tcache, jcache, tol)
        assert tcache.conv.dtype == tout.dtype
    return tcache


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("t_len", [1, 3, 13, 16])
def test_ssm_apply_prefill_and_decode_match_jax(t_len, groups):
    """The chunked SSD over T (padded past 8 where T is not a chunk
    multiple), its final state and conv tail, then the recurrent step."""
    jcfg, tcfg = _cfgs(HYBRID, ssm_ngroups=groups)
    _block_run(jcfg, tcfg, t_len, jnp.float32, TOL, seed=t_len + 10 * groups)


@pytest.mark.parametrize("t_len", [3, 13, 16])
def test_ssm_apply_bf16_matches_jax_bf16(t_len):
    jcfg, tcfg = _cfgs(HYBRID, dtype="bfloat16")
    _block_run(jcfg, tcfg, t_len, jnp.bfloat16, BF16_TOL, seed=t_len)


def test_prefill_conv_tail_is_a_copy():
    """The cache's conv tail owns its storage: a view of the padded conv
    input would keep (B, T + K - 1, conv_dim) alive in every block's cache."""
    jcfg, tcfg = _cfgs(HYBRID)
    _, cache = TS.ssm_apply(_port_tree(_block_params(jcfg, jnp.float32, 3)), tcfg,
                            torch.ones((BATCH, 40, tcfg.d_model)))
    assert cache.conv.shape == (BATCH, tcfg.ssm_conv - 1, tcfg.d_inner + 2 * tcfg.ssm_state)
    assert cache.conv.untyped_storage().nbytes() == cache.conv.numel() * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_make_ssm_cache_matches_reference(dtype):
    jcfg, tcfg = _cfgs(SSM)
    want = JS.make_ssm_cache(jcfg, 3, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    got = TS.make_ssm_cache(tcfg, 3, dtype)
    assert got._fields == want._fields
    assert got.state.shape == want.state.shape and got.state.dtype == torch.float32
    assert got.conv.shape == want.conv.shape and got.conv.dtype == dtype
    assert not got.state.any() and not got.conv.any()


def test_ssm_init_layout_matches_reference():
    jcfg, tcfg = _cfgs(SSM)
    want = _np(JS.ssm_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    got = TS.ssm_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert (got[k].dtype == torch.float32) == (w.dtype == np.float32), k


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _models(arch, seed=0, **changes):
    jcfg, tcfg = _cfgs(arch, **changes)
    jp = _np(jbuild_model(jcfg).init(jax.random.PRNGKey(seed)))
    return jcfg, jp, build_model(tcfg), lm_params_from_numpy(jp, "cpu")


def _assert_caches(tc, jc, tol=TOL):
    """The port's nested lists of per-block caches against the reference's
    stacked ones, leaf by leaf; KV cache lengths equal."""
    if isinstance(jc, dict):
        assert set(tc) == set(jc)
        for k in jc:
            _assert_caches(tc[k], jc[k], tol)
    elif isinstance(tc, list):
        assert len(tc) == jc[0].shape[0]
        for i, c in enumerate(tc):
            _assert_caches(c, type(jc)(*(f[i] for f in jc)), tol)
    else:
        assert type(tc).__name__ == type(jc).__name__ and tc._fields == jc._fields
        for f in tc._fields:
            got, want = getattr(tc, f), getattr(jc, f)
            if f == "length":
                assert got == int(want)
                continue
            assert tuple(got.shape) == want.shape, f
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       **tol, err_msg=f)


def _prompts(vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_prefill_and_decode_match_jax(arch, use_pallas):
    jcfg, jp, model, tp = _models(arch)
    jmodel = jbuild_model(jcfg, use_pallas=use_pallas)
    toks = _prompts(jcfg.vocab_size)
    max_len = PROMPT + 4
    jlog, jcaches = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
    ops.reset_launch_counts()
    with torch.no_grad():
        tlog, tcaches = model.prefill(tp, {"tokens": _t(toks).long()}, max_len)
    assert ops.launch_counts()["flash_attention"] == 0          # the CPU path
    assert tlog.shape == (BATCH, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _assert_caches(tcaches, jcaches)
    step = np.array([[5], [7]], np.int32)
    for i in range(3):
        pos = np.full((BATCH, 1), PROMPT + i, np.int32)
        jlog, jcaches = jmodel.decode(
            jp, {"tokens": jnp.asarray(step), "positions": jnp.asarray(pos)}, jcaches)
        with torch.no_grad():
            tlog, tcaches = model.decode(
                tp, {"tokens": _t(step).long(), "positions": _t(pos).long()}, tcaches)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _assert_caches(tcaches, jcaches)
        step = step + 1


def _jax_greedy(jcfg, jp, toks, gen, use_pallas):
    jmodel = jbuild_model(jcfg, use_pallas=use_pallas)
    jlog, jcaches = jmodel.prefill(jp, {"tokens": jnp.asarray(toks)}, toks.shape[1] + gen)
    out = [np.asarray(jnp.argmax(jlog[:, -1], axis=-1))]
    for i in range(gen - 1):
        pos = jnp.full((toks.shape[0], 1), toks.shape[1] + i, jnp.int32)
        jlog, jcaches = jmodel.decode(
            jp, {"tokens": jnp.asarray(out[-1])[:, None].astype(jnp.int32),
                 "positions": pos}, jcaches)
        out.append(np.asarray(jnp.argmax(jlog[:, -1], axis=-1)))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_greedy_tokens_match_jax(arch, use_pallas):
    """Prefill plus 4 greedy decode steps through ``generate``: the same
    tokens as the same loop on the JAX model."""
    jcfg, jp, model, tp = _models(arch, seed=4)
    toks = _prompts(jcfg.vocab_size, seed=5)
    out = tserve.generate(model, tp, _t(toks).long(), 5)
    np.testing.assert_array_equal(out["generated"], _jax_greedy(jcfg, jp, toks, 5, use_pallas))
    assert out["kernel_launches"]["prefill"]["flash_attention"] == 0
    assert out["logits_finite"]


def _assert_bf16_close(got, want):
    """Within rtol 2e-2 and one bf16 ulp at ``want``'s largest magnitude."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=ulp)


def _bf16_steps(jcfg):
    toks = _prompts(jcfg.vocab_size)
    return [(toks, np.arange(PROMPT)[None, :])] + [
        (np.array([[5 + i], [7 + i]], np.int32), np.full((BATCH, 1), PROMPT + i, np.int32))
        for i in range(2)]


def test_ssm_lm_bf16_blocks_match_jax():
    """mamba2 SMOKE in bf16 in both packages, block by block: the prefill
    and 2 decode steps, each block of the port on the reference's input to
    it, with its own caches; then the logits on the reference's last h."""
    jcfg, jp, _, tp = _models(SSM, dtype="bfloat16")
    tcfg = _cfgs(SSM, dtype="bfloat16")[1]
    jlayers = [jax.tree_util.tree_map(lambda a, i=i: a[i], jp["layers"])
               for i in range(jcfg.n_layers)]
    jcaches, tcaches = [None] * jcfg.n_layers, [None] * jcfg.n_layers
    with torch.no_grad():
        for tok, _ in _bf16_steps(jcfg):
            jh = jnp.asarray(jp["embed"])[jnp.asarray(tok)].astype(jnp.bfloat16)
            for i, (jl, tl) in enumerate(zip(jlayers, tp["layers"])):
                th = _bf16(jh)
                jout, jcaches[i] = JS.ssm_apply(jl["ssm"], jcfg, JL.apply_norm(
                    jh, jl["norm"], jcfg.norm), cache=jcaches[i])
                th, tcaches[i] = TSL.run_blocks(tcfg, [tl], th, caches=(
                    None if tcaches[i] is None else [tcaches[i]]))
                tcaches[i] = tcaches[i][0]
                jh = jh + jout
                assert th.dtype == tcaches[i].conv.dtype == torch.bfloat16
                _assert_bf16_close(th, jh)
                _assert_bf16_close(tcaches[i].conv, jcaches[i].conv)
                np.testing.assert_allclose(tcaches[i].state.numpy(),
                                           np.asarray(jcaches[i].state), **BF16_TOL)
            jlog = JL.apply_norm(jh, jp["final_norm"], jcfg.norm) @ jp["lm_head"]
            _assert_bf16_close(TSL.logits(tcfg, tp, _bf16(jh)), jlog)


def test_hybrid_bf16_blocks_match_jax():
    """zamba2 SMOKE in bf16 in both packages, block by block: every Mamba2
    block and each application of the shared block (on ``concat(h, e0)``,
    its own KV cache) fed the reference's input, the prefill and 2 decode
    steps."""
    jcfg, jp, _, tp = _models(HYBRID, dtype="bfloat16")
    tcfg = _cfgs(HYBRID, dtype="bfloat16")[1]
    g, k = jcfg.n_layers // jcfg.attn_every, jcfg.attn_every
    jm = {}
    with torch.no_grad():
        for call, (tok, pos) in enumerate(_bf16_steps(jcfg)):
            max_len = PROMPT + 3 if call == 0 else None
            jh = jnp.asarray(jp["embed"])[jnp.asarray(tok)].astype(jnp.bfloat16)
            je0, te0 = jh, _bf16(jh)
            for gi in range(g):
                for ki in range(k):
                    jl = jax.tree_util.tree_map(lambda a: a[gi, ki], jp["mamba"])
                    tl = tp["mamba"][gi][ki]
                    jc, tc = jm.get((gi, ki), (None, None))
                    jout, jc = JS.ssm_apply(jl["ssm"], jcfg, JL.apply_norm(
                        jh, jl["norm"], jcfg.norm), cache=jc)
                    th, tc = TSL.run_blocks(tcfg, [tl], _bf16(jh),
                                            caches=None if tc is None else [tc])
                    jm[gi, ki] = (jc, tc[0])
                    jh = jh + jout
                    _assert_bf16_close(th, jh)
                    _assert_bf16_close(tc[0].conv, jc.conv)
                jc, tc = jm.get(("attn", gi), (None, None))
                th, tc = THY._shared_block(tcfg, tp["shared"], _bf16(jh), te0, _t(pos).long(),
                                           cache=tc, cache_max_len=max_len)
                jh, jc = JHY._shared_block(jcfg, jp["shared"], jh, je0, jnp.asarray(pos),
                                           cache=jc, cache_max_len=max_len)
                jm["attn", gi] = (jc, tc)
                assert th.dtype == tc.k.dtype == torch.bfloat16 and tc.length == int(jc.length)
                _assert_bf16_close(th, jh)
                _assert_bf16_close(tc.k, jc.k)
                _assert_bf16_close(tc.v, jc.v)


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_make_caches_match_reference_layout(arch):
    """ssm: one ``SSMCache`` per block; hybrid: ``mamba`` G lists of K and
    ``attn`` one ``KVCache`` per application; shapes and dtypes of the
    reference's stacked leaves."""
    jcfg, _, model, _ = _models(arch)
    want = jbuild_model(jcfg).make_caches(BATCH, 20, jnp.bfloat16)
    got = model.make_caches(BATCH, 20, torch.bfloat16)

    def check(t, j):
        if isinstance(j, dict):
            assert set(t) == set(j)
            for key in j:
                check(t[key], j[key])
        elif isinstance(t, list):
            assert len(t) == j[0].shape[0]
            for i, c in enumerate(t):
                check(c, type(j)(*(f[i] for f in j)))
        else:
            assert type(t).__name__ == type(j).__name__ and t._fields == j._fields
            for f in t._fields:
                if f == "length":
                    assert t.length == 0
                    continue
                leaf = getattr(t, f)
                assert tuple(leaf.shape) == getattr(j, f).shape and not leaf.any()
                assert str(leaf.dtype).split(".")[-1] == getattr(j, f).dtype.name

    check(got, want)
    if arch == HYBRID:
        assert isinstance(got["attn"][0], TA.KVCache)
        assert len(got["mamba"]) == 2 and len(got["mamba"][0]) == 2


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_lm_converter_round_trips_bitwise(arch, dtype):
    """ssm_lm's ``layers`` (L, ...) become one dict per block; the hybrid's
    ``mamba`` (G, K, ...) G lists of K beside the ``shared`` block, which is
    not stacked; back again bit for bit."""
    cfg = jconfigs.get_smoke_config(arch)
    init = JSL.ssm_lm_init if arch == SSM else JHY.hybrid_init
    jp = _np(init(cfg, jax.random.PRNGKey(6), dtype=dtype))
    tp = lm_params_from_numpy(jp, "cpu")
    want_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    assert tp["embed"].dtype == want_dtype
    if arch == SSM:
        assert len(tp["layers"]) == cfg.n_layers
        np.testing.assert_array_equal(tp["layers"][1]["ssm"]["w_in"].float().numpy(),
                                      np.asarray(jp["layers"]["ssm"]["w_in"][1], np.float32))
        assert tp["layers"][0]["ssm"]["a_log"].dtype == torch.float32
    else:
        g, k = cfg.n_layers // cfg.attn_every, cfg.attn_every
        assert len(tp["mamba"]) == g and all(len(grp) == k for grp in tp["mamba"])
        np.testing.assert_array_equal(tp["mamba"][1][0]["ssm"]["conv_w"].float().numpy(),
                                      np.asarray(jp["mamba"]["ssm"]["conv_w"][1, 0], np.float32))
        assert set(tp["shared"]) == {"w_concat", "attn_norm", "attn", "mlp_norm", "mlp"}
        assert tp["shared"]["w_concat"].shape == (2 * cfg.d_model, cfg.d_model)
    back = lm_params_to_numpy(tp)
    w_leaves, w_def = jax.tree_util.tree_flatten(jp)
    g_leaves, g_def = jax.tree_util.tree_flatten(back)
    assert w_def == g_def
    for w, got in zip(w_leaves, g_leaves):
        assert w.dtype == got.dtype and w.shape == got.shape
        np.testing.assert_array_equal(got.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_serve_runs_end_to_end_on_cpu(arch):
    """``serve`` on the CPU: its weights (the port's init from the seed) and
    prompts (numpy's generator from the seed, as the reference draws them)
    through the reference's loop on the JAX model give the same tokens."""
    got = tserve.serve(arch, smoke=True, batch=2, prompt_len=8, gen=4, device="cpu", seed=3)
    assert got["generated"].shape == (2, 4) and got["generated"].dtype == np.int32
    assert got["logits_finite"] and got["prefill_s"] > 0 and got["decode_s_per_tok"] > 0
    assert got["kernel_launches"]["prefill"]["flash_attention"] == 0
    assert got["kernel_launches"]["decode"]["flash_attention"] == 0
    cfg = tconfigs.get_smoke_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(3))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = _jax_greedy(jconfigs.get_smoke_config(arch), lm_params_to_numpy(params), toks, 4,
                       use_pallas=False)
    np.testing.assert_array_equal(got["generated"], want)
