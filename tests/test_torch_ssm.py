"""The port's SSD chunked scan (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU.

The same numpy inputs, made from a seed, go through both:

* ``segsum`` equal to ``_segsum`` (the -inf above the diagonal included);
* ``ssd_chunked`` in float32, one chunk and several, with as many groups as
  heads and with fewer (G < H: B and C repeated over the head groups): y and
  the final state within rtol 1e-5, atol 1e-6 (float32 einsums summed in
  another order);
* the scan through the ssm head's padding (P not a multiple of the chunk,
  padded with dt = 0): equal to the JAX head's padded scan, and gradients
  through it finite and within rtol 1e-4, atol 1e-5 of ``jax.grad`` (each a
  sum of products over every later position, in another order);
* in bf16 (the large operands in bf16, decay and state in float32) within
  rtol 2e-2, atol 1e-3 of JAX's bf16 scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

RTOL, ATOL = 1e-5, 1e-6


def _inputs(b, t, h, p, g, n, seed):
    """x, B and C at the scale the ssm head feeds the scan: projections of
    normalized windows and one-hot categories by a 1/sqrt(fan-in) weight,
    about 0.3; dt a softplus of such a projection (dt > 0)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 0.3, s).astype(np.float32)
    x = f(b, t, h, p)
    dt = np.log1p(np.exp(f(b, t, h)))
    a = -np.exp(rng.normal(0, 0.5, h)).astype(np.float32)
    return x, dt.astype(np.float32), a, f(b, t, g, n), f(b, t, g, n)


def _torch(*arrays, dtype=None):
    out = [torch.from_numpy(a) for a in arrays]
    return out if dtype is None else [t.to(dtype) for t in out]


@pytest.mark.parametrize("q", [1, 5, 32])
def test_segsum_matches_jax(q):
    a = np.random.default_rng(q).normal(0, 1, (3, 2, q)).astype(np.float32)
    got = tssm.segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,t,h,p,g,n,chunk", [
    (2, 32, 5, 8, 1, 8, 32),      # the quarterly ssm head: 5 heads x 8, one group
    (3, 64, 4, 8, 2, 8, 32),      # G < H, two chunks
    (2, 96, 6, 4, 3, 4, 16),      # six chunks, G = H / 2
    (1, 12, 2, 4, 2, 8, 32),      # T below the chunk: one chunk of T
])
def test_ssd_chunked_matches_jax(b, t, h, p, g, n, chunk):
    x, dt, a, bb, cc = _inputs(b, t, h, p, g, n, seed=t + h)
    y, s = tssm.ssd_chunked(*_torch(x, dt, a, bb, cc), chunk=chunk)
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk=chunk)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


def test_ssd_chunked_refuses_a_ragged_t():
    x, dt, a, bb, cc = _inputs(1, 40, 2, 4, 1, 8, seed=0)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.ssd_chunked(*_torch(x, dt, a, bb, cc), chunk=32)


def _padded_scan(mod, lib, x, dt, a, bb, cc, chunk):
    """The ssm head's use of the scan: P padded to a chunk multiple with
    dt = 0 (zeros in every stream), y cut back to P, plus the skip term."""
    t = x.shape[1]
    pad = (-t) % chunk
    if lib is torch:
        padt = lambda z: torch.cat([z, z.new_zeros((z.shape[0], pad) + z.shape[2:])], dim=1)
    else:
        padt = lambda z: jnp.pad(z, ((0, 0), (0, pad)) + ((0, 0),) * (z.ndim - 2))
    y, _ = mod.ssd_chunked(padt(x), padt(dt), a, padt(bb), padt(cc), chunk=chunk)
    return y[:, :t] + x


@pytest.mark.parametrize("t", [33, 45, 121])
def test_padding_matches_jax_and_has_finite_gradients(t):
    x, dt, a, bb, cc = _inputs(2, t, 4, 4, 2, 8, seed=t)
    weights = np.random.default_rng(1).normal(0, 1, (2, t, 4, 4)).astype(np.float32)
    tx, tdt, ta, tbb, tcc = [v.requires_grad_(True) for v in _torch(x, dt, a, bb, cc)]
    y = _padded_scan(tssm, torch, tx, tdt, ta, tbb, tcc, 32)
    (y * torch.from_numpy(weights)).sum().backward()
    jy = _padded_scan(jssm, jnp, *map(jnp.asarray, (x, dt, a, bb, cc)), 32)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    want = jax.grad(
        lambda *args: jnp.sum(_padded_scan(jssm, jnp, *args, 32) * weights),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, dt, a, bb, cc)))
    for name, got, w in zip(("x", "dt", "a", "B", "C"), (tx, tdt, ta, tbb, tcc), want):
        assert torch.isfinite(got.grad).all(), name
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-4, atol=ATOL * 10,
                                   err_msg=name)


def test_ssd_chunked_bf16_matches_jax():
    x, dt, a, bb, cc = _inputs(2, 64, 5, 8, 1, 8, seed=3)
    bf = torch.bfloat16
    y, s = tssm.ssd_chunked(*_torch(x, dtype=bf), *_torch(dt, a),
                            *_torch(bb, cc, dtype=bf), chunk=32)
    j16 = lambda v: jnp.asarray(v, jnp.bfloat16)
    jy, js = jssm.ssd_chunked(j16(x), jnp.asarray(dt), jnp.asarray(a), j16(bb), j16(cc),
                              chunk=32)
    assert y.dtype == bf and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-2, atol=1e-3)
