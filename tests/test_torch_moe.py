"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package's.

Same numpy weights (``repro.models.moe.moe_init``) and the same numpy input
through both packages' ``moe_apply`` on the CPU, at the SMOKE configs:
dropless, at forced capacities that drop assignments (some of them beside a
kept token in the last slot, where a scatter that overwrites would lose it),
at S = 1 (a decode step), with DeepSeek's shared experts, and with a bf16
stream. Output and aux loss within rtol 1e-5 / atol 1e-5 in fp32 (sums of a
few hundred terms in another order); top-k ids, buffer positions and
``keep`` equal to the reference's own lines. The bf16 stream within rtol
2e-2 and an atol of one bf16 ulp at 1 (2**-7): the output sums expert terms
of magnitude about 1, each rounded to bf16 after a SiLU that XLA and
PyTorch round differently (an ulp apart on about a fifth of inputs), so a
small output can sit an ulp of its terms away; both packages' bf16 outputs
are also held equally near the fp32 computation on the same bf16 values.
The reference test's dense per-expert loop, in torch, equals the port's
dropless dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.models import moe as JM
from repro_torch import configs as tconfigs
from repro_torch.models import moe as TM

QWEN, DEEPSEEK = "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2.0 ** -7)


def _setup(arch, shape, seed=0, dtype=jnp.float32):
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jp = jax.tree_util.tree_map(np.asarray, JM.moe_init(jax.random.PRNGKey(seed), jcfg, dtype))
    x = np.random.default_rng(seed).normal(0, 1, shape + (jcfg.d_model,)).astype(np.float32)
    return jcfg, tcfg, jp, x


def _torch(tree, dtype=None):
    """numpy leaves -> CPU tensors (bf16 through float32: exact)."""
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, np.float32))
    return t if dtype is None or tree.dtype == np.float32 else t.to(dtype)


def _jax_routing(p, cfg, x, c):
    """The reference's routing lines (``repro.models.moe.moe_apply``):
    top-k ids, positions within each expert's buffer, keep."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_ids = jax.lax.top_k(probs, k)
    one_hot = jax.nn.one_hot(top_ids, e, dtype=jnp.float32)
    flat = one_hot.reshape(b, s * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1).reshape(b, s, k)
    return np.asarray(top_ids), np.asarray(pos).astype(np.int64), np.asarray(pos < c)


def _check(arch, shape, capacity, seed=0):
    jcfg, tcfg, jp, x = _setup(arch, shape, seed)
    jy, jaux = JM.moe_apply(jp, jcfg, jnp.asarray(x), capacity=capacity)
    tp, tx = _torch(jp), torch.from_numpy(x)
    ty, taux = TM.moe_apply(tp, tcfg, tx, capacity=capacity)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    r = TM.moe_route(tp, tcfg, tx, capacity)
    c = capacity or JM._capacity(shape[1], jcfg)
    assert r.capacity == c
    ids, pos, keep = _jax_routing(jp, jcfg, jnp.asarray(x), c)
    np.testing.assert_array_equal(r.top_ids.numpy(), ids)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    return r


def _shares_last_slot(r) -> bool:
    """Some row has a kept assignment in an expert's last slot and a dropped
    one to the same expert."""
    last = (r.pos == r.capacity - 1) & r.keep
    for b in range(r.top_ids.shape[0]):
        kept_last = set(r.top_ids[b][last[b]].tolist())
        dropped = set(r.top_ids[b][~r.keep[b]].tolist())
        if kept_last & dropped:
            return True
    return False


def test_moe_apply_matches_jax_dropless():
    r = _check(QWEN, (2, 16), None)
    assert r.capacity == 16 and bool(r.keep.all())


@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_moe_apply_matches_jax_with_drops(capacity):
    """Forced capacities drop assignments; the dropped ones beside a kept
    token in slot c - 1 must leave it whole."""
    r = _check(QWEN, (2, 16), capacity, seed=capacity)
    assert not bool(r.keep.all())
    assert _shares_last_slot(r)


def test_moe_apply_matches_jax_at_one_position():
    """A decode step: S = 1, so the capacity is 1 and nothing drops (the K
    ids of a token are distinct)."""
    r = _check(QWEN, (3, 1), None)
    assert r.capacity == 1 and bool(r.keep.all())


@pytest.mark.parametrize("capacity", [None, 2])
def test_shared_experts_match_jax(capacity):
    """deepseek-v2-lite's MoE layer (routed + shared experts); its MLA
    attention is not needed here."""
    jcfg, tcfg, jp, _ = _setup(DEEPSEEK, (2, 8))
    assert "shared" in jp and tcfg.n_shared_experts == 1
    r = _check(DEEPSEEK, (2, 8), capacity, seed=1)
    assert bool(r.keep.all()) == (capacity is None)


def test_moe_init_layout_matches_reference():
    for arch in (QWEN, DEEPSEEK):
        jcfg, tcfg, jp, _ = _setup(arch, (1, 1))
        tp = TM.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
        flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
        flat_t = jax.tree_util.tree_flatten_with_path(tp)[0]
        assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
        for (path, a), (_, t) in zip(flat_j, flat_t):
            assert tuple(t.shape) == a.shape
            want = torch.float32 if path[0].key == "router" else torch.bfloat16
            assert t.dtype == want


def test_bf16_stream_matches_jax():
    jcfg, tcfg, jp, x = _setup(QWEN, (2, 16), seed=4, dtype=jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jy, jaux = JM.moe_apply(jp, jcfg, xb)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ty, taux = TM.moe_apply(_torch(jp, torch.bfloat16), tcfg, tx)
    assert ty.dtype == torch.bfloat16
    got, want = ty.float().numpy(), np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(got, want, **BF16_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # the fp32 computation on the same bf16-valued weights and input
    y32, _ = TM.moe_apply(_torch(jp), tcfg, tx.float())
    err_port, err_ref = (np.abs(a - y32.numpy()).max() for a in (got, want))
    assert err_port <= err_ref + BF16_TOL["atol"], (err_port, err_ref)


def _dense_reference(p, cfg, x):
    """``tests/models/test_moe.py``'s dense per-expert loop, in torch: no
    capacity, no dispatch."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    top_w, top_ids = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        fe = (F.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])) @ p["w_down"][e]
        w_e = torch.where(top_ids == e, top_w, 0.0).sum(-1)
        y = y + fe * w_e[..., None].to(x.dtype)
    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    return y


@pytest.mark.parametrize("arch", [QWEN, DEEPSEEK])
def test_dropless_dispatch_matches_dense_loop(arch):
    """The reference test's bound (rtol = atol = 2e-4)."""
    tcfg = tconfigs.get_smoke_config(arch)
    p = TM.moe_init(torch.Generator().manual_seed(3), tcfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 16, tcfg.d_model))
                         .astype(np.float32))
    y, aux = TM.moe_apply(p, tcfg, x, capacity=16)
    np.testing.assert_allclose(y.numpy(), _dense_reference(p, tcfg, x).numpy(),
                               rtol=2e-4, atol=2e-4)
    assert float(aux) >= 0.9       # the Switch aux loss is 1 at balance


def test_dropped_assignment_adds_nothing():
    """An assignment past the capacity contributes no expert output: the
    layer equals the dense loop with the dropped weights zeroed."""
    tcfg = tconfigs.get_smoke_config(QWEN)
    p = TM.moe_init(torch.Generator().manual_seed(5), tcfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (1, 24, tcfg.d_model))
                         .astype(np.float32))
    r = TM.moe_route(p, tcfg, x, 2)
    assert not bool(r.keep.all())
    y, _ = TM.moe_apply(p, tcfg, x, capacity=2)
    want = torch.zeros_like(x)
    w = r.top_w * r.keep
    for e in range(tcfg.n_experts):
        fe = (F.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])) @ p["w_down"][e]
        want = want + fe * torch.where(r.top_ids == e, w, 0.0).sum(-1)[..., None]
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
