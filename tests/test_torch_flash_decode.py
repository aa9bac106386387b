"""K6's decode route on the CPU: its split-and-combine and its launch plan.

A bf16 call at (D, DV) = (64, 64) with G * Tq <= 16 query rows a kv head
(whisper's cross-attention decode: G * Tq = 1) runs ``flash_decode_bf16``:
the keys split over blocks, each split's partial (m, l, acc) combined by a
second kernel. ``ref.attention_decode_ref`` is that arithmetic in plain
torch; here it is held against the JAX ``repro.kernels.ops.flash_attention``
(the Pallas kernel in interpret mode) and the JAX oracle
``repro.kernels.ref.attention_ref`` on the same numpy inputs, at Tq 1, 4
and 16, G 1 and 4, Tk 1, 127 and 1,500, causal and not, and 1, 3 and 7
splits, among them splits in which a row sees no key (Tk = 1 over 3 or 7
splits; the causal rows of Tq = 16 that end before the last split). The
kernel itself is held against the plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Tolerances as ``tests/test_torch_flash_attention.py`` states them: fp32
rtol = atol = 2e-5 (the splits' sums in another order); bf16 atol 2e-2 (the
probabilities rounded to bf16 before the product with V, against the JAX
kernel's own rounding of them).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention, ops, ref

TOL = dict(rtol=2e-5, atol=2e-5)
HKV = 2


def _qkv(hq, tq, tk, seed, d=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (1, hq, tq, d)).astype(np.float32),
            rng.normal(0, 1, (1, HKV, tk, d)).astype(np.float32),
            rng.normal(0, 1, (1, HKV, tk, d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _case(tq, group, tk, causal, dtype="float32"):
    """The inputs and both JAX results of one shape, shared by its splits."""
    qkv = _qkv(HKV * group, tq, tk, seed=tq * 1000 + tk * 10 + group + causal)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a, jdt) for a in qkv)
    kern = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal).astype(jnp.float32))
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal).astype(jnp.float32))
    return qkv, kern, oracle


def _decode_ref(qkv, causal, n_split, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in qkv)
    return ref.attention_decode_ref(q, k, v, causal=causal, n_split=n_split).float().numpy()


# causal needs Tq <= Tk (queries at the end of the key timeline)
_SHAPES = [(tq, group, tk, causal)
           for tq in (1, 4, 16) for group in (1, 4) for tk in (1, 127, 1500)
           for causal in (False, True) if not (causal and tq > tk)]


@pytest.mark.parametrize("n_split", [1, 3, 7])
@pytest.mark.parametrize("tq,group,tk,causal", _SHAPES)
def test_decode_ref_matches_jax_kernel_and_oracle(tq, group, tk, causal, n_split):
    qkv, kern, oracle = _case(tq, group, tk, causal)
    got = _decode_ref(qkv, causal, n_split)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("n_split", [1, 5, 7])
@pytest.mark.parametrize("tq,group,causal", [(1, 1, False), (4, 4, True), (16, 1, True)])
def test_decode_ref_bf16_matches_jax_kernel_and_oracle(tq, group, causal, n_split):
    """bf16 inputs, as the route runs them: whisper's one row over 1,500
    keys, a GQA group of 4 at Tq = 4, and 16 causal rows."""
    qkv, kern, oracle = _case(tq, group, 1500, causal, "bfloat16")
    got = _decode_ref(qkv, causal, n_split, torch.bfloat16)
    np.testing.assert_allclose(got, kern, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-2)


@pytest.mark.parametrize("tq,tk,n_split", [(1, 1, 7), (16, 127, 7), (16, 1500, 5)])
def test_decode_ref_keeps_splits_without_a_visible_key_out(tq, tk, n_split):
    """One split is the plain softmax; splits that hold no key (Tk = 1 over
    7), or none a causal row can see (row 0 of 16 over 127 keys ends at key
    111, before the last of 7 splits), add exactly nothing and no NaN."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, tq, tk, seed=tk))
    plain = ref.attention_ref(q, k, v, causal=True).numpy()
    for n in (1, n_split):
        got = ref.attention_decode_ref(q, k, v, causal=True, n_split=n)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), plain, **TOL)


# (kv rows of blocks B * Hkv, Tk): whisper's cross decode at batch 8 and at
# the parity cell's batch 2, one row, a GQA decode, short and long caches
_PLANS = [(64, 1500), (16, 1500), (8, 1500), (1, 1), (64, 1), (64, 127), (64, 128),
          (64, 4096), (2, 32768), (1, 100_000), (512, 2048), (7, 1000)]


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("bkv,tk", _PLANS)
def test_decode_plan_covers_every_key_once(bkv, tk, sm_count):
    plan = flash_attention.decode_plan(bkv, tk, sm_count)
    assert plan.splits >= 1 and plan.keys >= 1
    covered = [key for s in range(plan.splits)
               for key in range(s * plan.keys, min((s + 1) * plan.keys, tk))]
    assert covered == list(range(tk))
    assert (plan.splits - 1) * plan.keys < tk             # no split is empty
    if plan.splits > 1:
        assert plan.keys >= flash_attention.DECODE_MIN_KEYS
    # as many blocks as 2 an SM asks, where Tk has the keys for them
    want = flash_attention.DECODE_BLOCKS_PER_SM * sm_count
    assert bkv * plan.splits >= want or plan.splits >= tk // flash_attention.DECODE_MIN_KEYS


def test_decode_plan_at_whispers_cross_decode():
    """8 x 8 kv heads over 1,500 frames on an H100's 132 SMs: 5 splits of
    300 keys, 320 blocks (at least 2 x 132)."""
    plan = flash_attention.decode_plan(64, 1500, 132)
    assert plan == flash_attention.DecodePlan(5, 300)
    assert 64 * plan.splits >= 2 * 132


@pytest.mark.parametrize("dtype,hq,hkv,tq,d,dv,route", [
    (torch.bfloat16, 8, 8, 1, 64, 64, True),           # whisper's cross decode
    (torch.bfloat16, 32, 8, 4, 64, 64, True),          # G * Tq = 16
    (torch.bfloat16, 32, 8, 5, 64, 64, False),         # 20 rows: the prefill kernel
    (torch.bfloat16, 16, 1, 1, 64, 64, True),
    (torch.bfloat16, 8, 8, 2048, 64, 64, False),       # whisper's prefill
    (torch.bfloat16, 32, 4, 1, 128, 128, False),       # D 128
    (torch.bfloat16, 32, 32, 1, 80, 80, False),
    (torch.float32, 8, 8, 1, 64, 64, False),           # fp32: the SIMT kernel
])
def test_decode_route_is_chosen_by_shape(dtype, hq, hkv, tq, d, dv, route):
    assert flash_attention.takes_decode_route(dtype, hq, hkv, tq, d, dv) is route


def test_cpu_decode_shapes_take_the_plain_version():
    qkv = _qkv(8, 1, 300, seed=3)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in qkv)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=False)
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_decode"]) == (0, 0)
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=False), rtol=0, atol=0)
