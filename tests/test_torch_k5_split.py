"""The split behind K5 in bf16 on the tensor cores, on the CPU.

``csrc/lstm_cell_bwd_tc.cu`` feeds each float32 gate cotangent to
``mma.sync`` as three bf16 terms, ``lstm_cell.split_bf16``. These tests
hold that split exact (so the products of its terms with bf16 values are
exact in float32, and the kernel may differ from the plain version only in
summation order), and hold products taken through the split terms, summed in
float32, to the card tests' bounds against ``ref.lstm_cell_bwd_ref``: dx,
dh_prev and dc_prev within 1 bf16 ulp or atol 1e-5, the float32 weight
gradients within 1e-5 sqrt(B). Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import lstm_cell, ref

hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies

# bf16's largest finite value is (2 - 2**-7) 2**127; float32 values from
# halfway to the next power of two round to infinity, so the split's first
# term is finite below (2 - 2**-8) 2**127
_TOP = float(np.float32((2 - 2 ** -8) * 2.0 ** 127))
_floats = st.floats(width=32, allow_nan=False, allow_infinity=False).filter(
    lambda v: v == 0 or 2.0 ** -100 <= abs(v) < _TOP)


@hypothesis.given(st.lists(_floats, min_size=1, max_size=64))
@hypothesis.settings(max_examples=400, deadline=None)
def test_split_bf16_is_exact(values):
    d = torch.tensor(values, dtype=torch.float32)
    terms = lstm_cell.split_bf16(d)
    assert len(terms) == lstm_cell.BWD_TC_TERMS
    assert all(t.dtype == torch.bfloat16 for t in terms)
    d0, d1, d2 = (t.float() for t in terms)
    # each partial sum exact in float32: the terms add back to d in any order
    assert torch.equal(d0 + d1 + d2, d) and torch.equal(d0 + (d1 + d2), d)
    # zero stays zero, in every term
    zero = d == 0
    assert not (d0[zero].any() or d1[zero].any() or d2[zero].any())
    # each term's product with a bf16 value is exact in float32 (16
    # significant bits) wherever it lies in float32's normal range
    w = torch.tensor(np.random.default_rng(len(values)).uniform(-2, 2, len(values)),
                     dtype=torch.float32).to(torch.bfloat16).float()
    for t in (d0, d1, d2):
        exact = t.double() * w.double()
        normal = (exact == 0) | ((exact.abs() >= 2.0 ** -126) & (exact.abs() < 2.0 ** 127))
        assert torch.equal((t * w).double()[normal], exact[normal])


def test_split_bf16_near_the_bounds():
    edge = torch.tensor([2.0 ** -100, -(2.0 ** -100), 1.0 + 2.0 ** -23, -3.0 + 2.0 ** -22,
                         _TOP * (1 - 2 ** -24), 0.0, -0.0, 1e-30, 3.3e38], dtype=torch.float32)
    d0, d1, d2 = (t.float() for t in lstm_cell.split_bf16(edge))
    assert torch.equal(d0 + d1 + d2, edge)
    assert torch.isfinite(d0).all()


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.uniform(-1, 1, shape) * scale).astype(np.float32)).to(
        torch.bfloat16)


def _split_products(wx, wh, x, h, c, c_new, act, dh, dc):
    """K5's arithmetic on the CPU: the float32 cotangents split into bf16
    terms, each term's products with the bf16 operands summed in float32."""
    dgates, dc_prev = ref.lstm_cell_bwd_cotangents(c, c_new, act, dh, dc)
    terms = [t.float() for t in lstm_cell.split_bf16(dgates)]
    assert torch.equal(terms[0] + terms[1] + terms[2], dgates)
    wx, wh, x, h = (t.float() for t in (wx, wh, x, h))
    dx = sum(t @ wx.t() for t in terms)
    dh_prev = sum(t @ wh.t() for t in terms)
    ones = torch.ones((1, x.shape[0]))
    return (dx.to(torch.bfloat16), dh_prev.to(torch.bfloat16), dc_prev.to(torch.bfloat16),
            sum(x.t() @ t for t in terms), sum(h.t() @ t for t in terms),
            sum((ones @ t)[0] for t in terms))


# the card tests' bf16 train-step cells: every train shape (rows = batch x
# dilation at batch 256, 2,048 and the fine-tune's 8), the odd width and the
# widths past the presets
_BF16_TRAIN_CELLS = ([(b * d, i, 40) for b in (256, 2_048, 8)
                      for d, i in ((1, 14), (2, 40), (4, 40), (8, 40))]
                     + [(128, 7, 50), (333, 62, 50)]
                     + [(rows, hid, hid) for hid in (64, 128, 256) for rows in (1, 256)]
                     + [(33, 1030, 1030)])


@pytest.mark.parametrize("rows,in_size,hidden", _BF16_TRAIN_CELLS)
def test_products_of_the_split_terms_hold_the_card_bounds(rows, in_size, hidden):
    rng = np.random.default_rng(rows + hidden)
    wx = _bf16(rng, (in_size, 4 * hidden), in_size ** -0.5)
    wh = _bf16(rng, (hidden, 4 * hidden), hidden ** -0.5)
    b = _bf16(rng, (4 * hidden,), 0.1)
    x, h, c = _bf16(rng, (rows, in_size)), _bf16(rng, (rows, hidden)), _bf16(rng, (rows, hidden), 2)
    _, c_new, act = ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
    dh, dc = (torch.from_numpy(rng.standard_normal((rows, hidden)).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    args = (wx, wh, x, h, c, c_new, act, dh, dc)
    got, want = _split_products(*args), ref.lstm_cell_bwd_ref(*args)
    for name, g, w in zip(("dx", "dh_prev", "dc_prev"), got[:3], want[:3]):
        past = (ref.bf16_ulps(g, w) > 1) & ((g.float() - w.float()).abs() > 1e-5)
        assert not past.any(), f"{name}: {int(past.sum())} past 1 bf16 ulp and atol 1e-5"
    for g, w in zip(got[3:], want[3:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * max(1.0, rows ** 0.5))
