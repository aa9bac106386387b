"""The port's attention (K6's plain version) against the JAX package's.

``repro_torch.kernels.ops.flash_attention`` on CPU tensors runs the plain
version ``ref.attention_ref``; it is held against the JAX
``repro.kernels.ops.flash_attention`` (the Pallas kernel in interpret mode on
the CPU) and the JAX oracle ``repro.kernels.ref.attention_ref``, on the same
numpy inputs. The CUDA kernel itself is held against the plain version on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

zamba2's head dim 80 (D = DV = 80, not a multiple of the bf16 kernel's
64-element TMA box) is held against both in fp32 and bf16. MLA's shape, a
v narrower than q and k ((D, DV) = (24, 16) and (192, 128)),
is held against the JAX ``chunked_attention`` with ``use_pallas=False``:
the JAX kernel takes only DV = D (ROADMAP F4).

Tolerances: fp32 rtol = atol = 2e-5, the JAX kernel test's (sums in another
order). bf16: the port's plain version and the JAX kernel both take fp32
logits from the bf16 inputs and cast the probabilities to bf16 before the
product with V, but the JAX kernel divides by the row sum after that
product and the plain version before it (and the JAX oracle rounds the
logits themselves to bf16): the outputs differ by one bf16 rounding. Early
rows see few keys, so |o| reaches 2-4, where one rounding is 2**-6: atol
2e-2 against both (the JAX test's bound is 0.05).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, hq, hkv, tq, tk, d, seed, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, hq, tq, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, tk, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, tk, dv or d)).astype(np.float32))


def _port(qkv, causal, dtype=torch.float32, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in qkv)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal, **kw)
    assert ops.launch_counts()["flash_attention"] == 0       # the plain version ran
    return out.float().numpy()


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(64, 64), (64, 128), (1, 96), (33, 96)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (16, 1)])
def test_attention_matches_jax_kernel_and_oracle(hq, hkv, tq, tk, causal, d):
    qkv = _qkv(1, hq, hkv, tq, tk, d, seed=hq * tq + tk + d + causal)
    got = _port(qkv, causal)
    jq, jk, jv = (jnp.asarray(a) for a in qkv)
    np.testing.assert_allclose(
        got, np.asarray(jops.flash_attention(jq, jk, jv, causal=causal)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.attention_ref(jq, jk, jv, causal=causal)), **TOL)


def test_bf16_matches_jax_kernel_and_oracle():
    qkv = _qkv(2, 8, 2, 64, 64, 64, seed=0)
    got = _port(qkv, True, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in qkv)
    kern = np.asarray(jops.flash_attention(jq, jk, jv, causal=True).astype(jnp.float32))
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=True).astype(jnp.float32))
    np.testing.assert_allclose(got, kern, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_80_matches_jax_kernel_and_oracle(causal):
    """zamba2's shared attention block: D = DV = 80 (d_model 2560 over 32
    heads), MHA, at its scale 1/sqrt(80), across a 32-row query chunk of the
    model's CPU path: the plain K6 through ``ops`` and ``chunked_attention``
    against the JAX kernel in interpret mode and its oracle; then in bf16."""
    from repro_torch.models.attention import chunked_attention

    tq, tk = (70, 70) if causal else (70, 90)
    qkv = _qkv(2, 4, 4, tq, tk, 80, seed=80 + causal)
    jq, jk, jv = (jnp.asarray(a) for a in qkv)
    kern = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal))
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal))
    got = _port(qkv, causal, scale=80 ** -0.5)
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    chunked = chunked_attention(*(torch.from_numpy(a) for a in qkv), causal=causal,
                                scale=80 ** -0.5, q_chunk=32)
    np.testing.assert_allclose(chunked.numpy(), kern, **TOL)
    got16 = _port(qkv, causal, torch.bfloat16, scale=80 ** -0.5)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in qkv)
    kern16 = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal).astype(jnp.float32))
    np.testing.assert_allclose(got16, kern16, rtol=0, atol=2e-2)


@pytest.mark.parametrize("tq,tk,causal", [(48, 80, True), (20, 20, False)])
def test_explicit_scale_matches_jax_oracle(tq, tk, causal):
    """The model's own scale (granite's attention_multiplier, 2**-7) reaches
    the plain version; the JAX Pallas path would drop it (ROADMAP F4)."""
    qkv = _qkv(2, 4, 2, tq, tk, 64, seed=tq)
    got = _port(qkv, causal, scale=0.0078125)
    want = jref.attention_ref(*(jnp.asarray(a) for a in qkv), causal=causal, scale=0.0078125)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_chunked_attention_matches_jax_chunked():
    """The model's CPU path (query chunks, grouped scores) against the JAX
    ``chunked_attention`` with ``use_pallas=False``, across a chunk border."""
    from repro.models.attention import chunked_attention as jchunked
    from repro_torch.models.attention import chunked_attention

    q, k, v = _qkv(2, 8, 4, 80, 80, 32, seed=9)
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                            scale=32 ** -0.5, q_chunk=32)
    want = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    scale=32 ** -0.5, q_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                       causal=True).numpy(), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv", [(24, 16), (192, 128)])
def test_v_head_dim_of_its_own_matches_jax_chunked(d, dv, causal):
    """MLA's shapes: the model's CPU path with Tq past the query chunk (the
    chunk loop and its tail) and the plain K6 through ``ops``, against the
    JAX ``chunked_attention(use_pallas=False)``, at MLA's scale."""
    from repro.models.attention import chunked_attention as jchunked
    from repro_torch.models.attention import chunked_attention

    tq, tk = 70, 70 if causal else 90
    q, k, v = _qkv(2, 4, 4, tq, tk, d, seed=d + causal, dv=dv)
    scale = d ** -0.5
    want = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               scale=scale, q_chunk=32))
    assert want.shape == (2, 4, tq, dv)
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                            scale=scale, q_chunk=32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(_port((q, k, v), causal, scale=scale), want, **TOL)
