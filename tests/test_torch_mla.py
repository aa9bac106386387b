"""The port's MLA attention (``repro_torch.models.attention.mla_*``) against the JAX package's.

Same numpy weights (``repro.models.attention.mla_init``) and the same numpy
input through both packages' ``mla_apply`` on the CPU, at deepseek-v2-lite's
SMOKE config (d_model 64, 4 heads, latent rank 32, q.k 16 + 8 wide, v 16):
train mode, a prefill into a cache of ``cache_max_len``, then 3 decode
steps with the absorbed decode and with the up-projected one. The
reference's prefill runs with ``use_pallas=False``: its Pallas kernel takes
only a v as wide as q (ROADMAP F4). fp32 outputs and caches within rtol
1e-5 / atol 1e-5 (sums of at most a few hundred terms in another order);
the port's two decodes agree within the same bound. A bf16 stream holds
the port within rtol 2e-2 and an atol of one bf16 ulp at 1 (2**-7) of the
reference in bf16, as the MoE layer's bf16 test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention as TA

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2.0 ** -7)
B, S, MAX_LEN, STEPS = 2, 9, 16, 3


def _setup(seed=0, dtype=jnp.float32):
    jcfg, tcfg = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    jp = jax.tree_util.tree_map(np.asarray, JA.mla_init(jax.random.PRNGKey(seed), jcfg, dtype))
    rng = np.random.default_rng(seed)
    # kv_norm away from 1, so the latent's scale is checked
    jp["kv_norm"] = (jp["kv_norm"].astype(np.float32)
                     + rng.normal(0, 0.5, jp["kv_norm"].shape)).astype(jp["kv_norm"].dtype)
    x = rng.normal(0, 1, (B, S + STEPS, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, x


def _torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dtype) for k, v in tree.items()}


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


def _assert_cache(tcache, jcache, tol=TOL):
    _close(tcache.c_kv, jcache.c_kv, tol)
    _close(tcache.k_rope, jcache.k_rope, tol)
    assert tcache.length == int(jcache.length)


def test_mla_init_layout_matches_reference():
    jcfg, tcfg, jp, _ = _setup()
    tp = TA.mla_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    assert torch.equal(tp["kv_norm"], torch.ones(tcfg.kv_lora_rank))
    cache = TA.make_mla_cache(tcfg, B, MAX_LEN, torch.float32)
    jc = JA.make_mla_cache(jcfg, B, MAX_LEN, jnp.float32)
    assert cache.c_kv.shape == jc.c_kv.shape and cache.k_rope.shape == jc.k_rope.shape
    assert cache.length == 0 and not cache.c_kv.any() and not cache.k_rope.any()


def test_mla_train_mode_matches_jax():
    jcfg, tcfg, jp, x = _setup(seed=1)
    pos = np.arange(S + STEPS)[None, :]
    jout, jcache = JA.mla_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tout, tcache = TA.mla_apply(_torch(jp), tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert jcache is None and tcache is None
    _close(tout, jout, TOL)


def test_mla_qkv_is_what_the_prefill_attends_over():
    """``mla_qkv``'s (qh, kh, vh) through the plain attention at MLA's scale
    give ``mla_apply``'s output before ``wo``; kh ends in k_rope, the same
    for every head."""
    jcfg, tcfg, jp, x = _setup(seed=2)
    tp, tx = _torch(jp), torch.from_numpy(x[:, :S])
    pos = torch.arange(S)[None, :]
    qh, kh, vh, c_kv, k_rope = TA.mla_qkv(tp, tcfg, tx, pos)
    dn, dr, dv, h = tcfg.qk_nope_dim, tcfg.qk_rope_dim, tcfg.v_head_dim, tcfg.n_heads
    assert qh.shape == kh.shape == (B, h, S, dn + dr) and vh.shape == (B, h, S, dv)
    assert torch.equal(kh[..., dn:], k_rope[:, None].expand(B, h, S, dr))
    out = TA.chunked_attention(qh, kh, vh, causal=True, scale=(dn + dr) ** -0.5)
    want, cache = TA.mla_apply(tp, tcfg, tx, pos, cache_max_len=MAX_LEN)
    torch.testing.assert_close(out.transpose(1, 2).reshape(B, S, h * dv) @ tp["wo"], want,
                               rtol=0, atol=0)
    assert torch.equal(cache.c_kv[:, :S], c_kv) and torch.equal(cache.k_rope[:, :S], k_rope)


def test_w_uk_and_w_uv_reshape_alike_in_both_packages():
    """``_mla_absorbed`` reads W_uk as (r, h, dn) and W_uv as (r, h, dv):
    row-major in both packages, through the converter bit for bit."""
    jcfg, tcfg, jp, _ = _setup(seed=3)
    tp = lm_params_from_numpy({"layers": {"attn": {k: v[None] for k, v in jp.items()}}},
                              "cpu")["layers"][0]["attn"]
    r, h = tcfg.kv_lora_rank, tcfg.n_heads
    for name, width in (("w_uk", tcfg.qk_nope_dim), ("w_uv", tcfg.v_head_dim)):
        np.testing.assert_array_equal(
            tp[name].reshape(r, h, width).numpy(),
            np.asarray(jnp.asarray(jp[name]).reshape(r, h, width)))


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_prefill_and_decode_match_jax(absorbed):
    """Prefill S positions into a cache of MAX_LEN, then STEPS one-token
    decode steps; output and caches after each call."""
    jcfg, tcfg, jp, x = _setup(seed=4)
    tp = _torch(jp)
    pos = np.arange(S)[None, :]
    jout, jcache = JA.mla_apply(jp, jcfg, jnp.asarray(x[:, :S]), jnp.asarray(pos),
                                cache_max_len=MAX_LEN)
    tout, tcache = TA.mla_apply(tp, tcfg, torch.from_numpy(x[:, :S]), torch.from_numpy(pos),
                                cache_max_len=MAX_LEN)
    _close(tout, jout, TOL)
    _assert_cache(tcache, jcache)
    assert tcache.c_kv.shape == (B, MAX_LEN, tcfg.kv_lora_rank)
    assert not tcache.c_kv[:, S:].any() and not tcache.k_rope[:, S:].any()
    for i in range(STEPS):
        xi = x[:, S + i:S + i + 1]
        pi = np.full((B, 1), S + i)
        jout, jcache = JA.mla_apply(jp, jcfg, jnp.asarray(xi), jnp.asarray(pi), cache=jcache,
                                    absorbed_decode=absorbed)
        storage = tcache.c_kv
        tout, tcache = TA.mla_apply(tp, tcfg, torch.from_numpy(xi), torch.from_numpy(pi),
                                    cache=tcache, absorbed_decode=absorbed)
        assert tcache.c_kv is storage          # written in place
        _close(tout, jout, TOL)
        _assert_cache(tcache, jcache)
    assert tcache.length == S + STEPS


def test_mla_absorbed_decode_equals_the_up_projected_one():
    """The port's two decodes on the same cache, at every step."""
    _, tcfg, jp, x = _setup(seed=5)
    tp = _torch(jp)
    _, cache = TA.mla_apply(tp, tcfg, torch.from_numpy(x[:, :S]), torch.arange(S)[None, :],
                            cache_max_len=MAX_LEN)
    for i in range(STEPS):
        xi = torch.from_numpy(x[:, S + i:S + i + 1])
        pi = torch.full((B, 1), S + i)
        plain, _ = TA.mla_apply(tp, tcfg, xi, pi, cache=cache, absorbed_decode=False)
        out, cache = TA.mla_apply(tp, tcfg, xi, pi, cache=cache)
        torch.testing.assert_close(out, plain, **TOL)


def test_mla_bf16_matches_jax_bf16():
    """Weights, input and cache in bf16 in both packages: prefill and two
    absorbed decode steps."""
    jcfg, tcfg, jp, x = _setup(seed=6, dtype=jnp.bfloat16)
    tp = _torch(jp, torch.bfloat16)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    tx = torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16)
    pos = np.arange(S)[None, :]
    jout, jcache = JA.mla_apply(jp, jcfg, jnp.asarray(xb[:, :S]), jnp.asarray(pos),
                                cache_max_len=MAX_LEN)
    tout, tcache = TA.mla_apply(tp, tcfg, tx[:, :S], torch.from_numpy(pos),
                                cache_max_len=MAX_LEN)
    assert tout.dtype == tcache.c_kv.dtype == torch.bfloat16
    _close(tout, jout, BF16_TOL)
    _assert_cache(tcache, jcache, BF16_TOL)
    for i in range(2):
        pi = np.full((B, 1), S + i)
        jout, jcache = JA.mla_apply(jp, jcfg, jnp.asarray(xb[:, S + i:S + i + 1]),
                                    jnp.asarray(pi), cache=jcache)
        tout, tcache = TA.mla_apply(tp, tcfg, tx[:, S + i:S + i + 1], torch.from_numpy(pi),
                                    cache=tcache)
        _close(tout, jout, BF16_TOL)
        _assert_cache(tcache, jcache, BF16_TOL)
