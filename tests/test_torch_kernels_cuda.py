"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA GPU
(the decision is taken inside the ``card`` fixture, never at import). This
file imports only torch and the port -- no JAX -- so it runs on the card's
host, where the repo's ``tests/conftest.py`` (which imports JAX) is left out:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K1 rtol 1e-5 (same operations, same order, IEEE rounding);
K3 atol 1e-5 (the gate dots sum in another order than the plain matmul).
"""

import pytest
import torch

from repro_torch import strict_fp32
from repro_torch.kernels import hw_scan, lstm_cell, ref


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    strict_fp32()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_len,m", [(300, 40, 4), (129, 9, 1), (5, 3, 12)])
def test_hw_scan_kernel_matches_plain_on_card(card, n, t_len, m):
    g = torch.Generator().manual_seed(n)
    y = torch.rand((n, t_len), generator=g) * 50 + 1
    alpha, gamma = torch.rand(n, generator=g), torch.rand(n, generator=g)
    init_seas = torch.rand((n, m), generator=g) + 0.5
    want = ref.hw_scan_ref(y, alpha, gamma, init_seas)
    with torch.no_grad():
        lev, seas = hw_scan.hw_scan_tm(*(a.to(card) for a in (
            y.t().contiguous(), alpha, gamma, init_seas.t().contiguous())))
    torch.testing.assert_close(lev.t().cpu(), want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(seas.t().cpu(), want[1], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,in_size,hidden", [(1, 14, 40), (333, 40, 40), (70, 62, 50)])
def test_lstm_cell_kernel_matches_plain_on_card(card, rows, in_size, hidden):
    g = torch.Generator().manual_seed(rows)
    u = lambda *s: torch.rand(s, generator=g) * 2 - 1
    args = [u(in_size, 4 * hidden) * 0.2, u(hidden, 4 * hidden) * 0.2, u(4 * hidden),
            u(rows, in_size), u(rows, hidden), u(rows, hidden)]
    want = ref.lstm_cell_ref(*args)
    with torch.no_grad():
        got = lstm_cell.lstm_cell(*(a.to(card) for a in args))
    for gt, w in zip(got, want):
        torch.testing.assert_close(gt.cpu(), w, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernels_raise_on_other_dtypes_on_card(card):
    x = torch.ones((2, 3), dtype=torch.float64, device=card)
    with pytest.raises(TypeError, match="float32 only"):
        hw_scan.hw_scan_tm(x, x[0], x[0], x)
