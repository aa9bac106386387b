"""The plain backward versions of K2, K4 and K5, and their autograd wiring (CPU).

* ``hw_scan_bwd_ref`` (the plain K2) against ``torch.autograd`` of the plain
  forward scan (atol 1e-5 relative to the gradient's scale: the adjoint and
  autograd add the same terms in other orders) and, through
  ``kernels.ops.hw_scan`` (the ``HWScan`` Function on its CPU route), against
  ``jax.grad`` of the JAX plain scan ``hw_smooth(..., use_pallas=False)``
  (rtol 1e-4 through sigmoid/exp of the logits). The JAX Pallas K2 cannot
  run here: interpret mode needs ``pl.load``, which the installed JAX lacks.
* ``lstm_cell_fwd_ref`` / ``lstm_cell_bwd_ref`` (the plain K4, K5), through
  ``kernels.ops.lstm_cell`` (the ``LSTMCell`` Function), against ``jax.grad``
  through ``repro.kernels.ops.lstm_cell``, whose Pallas K4/K5 run in
  interpret mode: atol 1e-5 (float32 products in other orders).
* ``torch.autograd.gradcheck`` in float64 on both Functions' CPU routes.

The CUDA kernels themselves are held against these plain versions on the
card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import holt_winters as jhw
from repro.kernels import ops as jops
from repro_torch.core import holt_winters as thw
from repro_torch.kernels import hw_scan, lstm_cell, ops, ref


def _hw_case(n, t_len, m, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(0.5, 2.0, (n, 1)) * np.exp(rng.normal(0, 0.1, (n, t_len)))).astype(dtype)
    logits = dict(alpha_logit=rng.normal(0, 1, n), gamma_logit=rng.normal(-1, 1, n),
                  init_seas_logit=rng.normal(0, 0.2, (n, m)))
    w_lev = rng.normal(0, 1, (n, t_len)).astype(dtype)
    w_seas = rng.normal(0, 1, (n, t_len + m)).astype(dtype)
    return y, {k: v.astype(dtype) for k, v in logits.items()}, w_lev, w_seas


@pytest.mark.parametrize("n,t_len,m", [(5, 12, 4), (130, 9, 1), (3, 2, 4), (7, 20, 12)])
def test_hw_scan_bwd_ref_matches_autograd(n, t_len, m):
    y, logits, w_lev, w_seas = _hw_case(n, t_len, m, seed=n + m)
    y_t = torch.from_numpy(y).requires_grad_(True)
    alpha = torch.sigmoid(torch.from_numpy(logits["alpha_logit"])).requires_grad_(True)
    gamma = torch.sigmoid(torch.from_numpy(logits["gamma_logit"])).requires_grad_(True)
    init = torch.exp(torch.from_numpy(logits["init_seas_logit"])).requires_grad_(True)
    levels, seas = ref.hw_scan_ref(y_t, alpha, gamma, init)
    dlev, dseas = torch.from_numpy(w_lev), torch.from_numpy(w_seas)
    want = torch.autograd.grad((levels * dlev).sum() + (seas * dseas).sum(),
                               (y_t, alpha, gamma, init))
    got = ref.hw_scan_bwd_ref(y_t.detach(), alpha.detach(), gamma.detach(),
                              levels.detach(), seas.detach(), dlev, dseas)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("n,t_len,m", [(5, 16, 4), (131, 10, 1), (4, 6, 12),
                                       (3, 340, 168)])    # two weekly seasons, hourly data
def test_hw_scan_grad_matches_jax(n, t_len, m):
    y, logits, w_lev, w_seas = _hw_case(n, t_len, m, seed=10 + n)

    def jax_loss(y, params):
        lev, seas = jhw.hw_smooth(y, params, seasonality=m, use_pallas=False)
        return jnp.sum(lev * w_lev) + jnp.sum(seas * w_seas)

    jp = jhw.HWParams(**{k: jnp.asarray(v) for k, v in logits.items()})
    want_y, want_p = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(y), jp)

    tp = thw.HWParams(**{k: torch.from_numpy(v).requires_grad_(True)
                         for k, v in logits.items()})
    y_t = torch.from_numpy(y).requires_grad_(True)
    ops.reset_launch_counts()
    lev, seas = ops.hw_scan(y_t, tp, seasonality=m)
    loss = (lev * torch.from_numpy(w_lev)).sum() + (seas * torch.from_numpy(w_seas)).sum()
    loss.backward()
    assert ops.launch_counts()["hw_scan_bwd"] == 0          # the plain route
    np.testing.assert_allclose(y_t.grad.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-5)
    for name in ("alpha_logit", "gamma_logit", "init_seas_logit"):
        got = getattr(tp, name).grad
        want = np.asarray(getattr(want_p, name))
        if got is None:                     # m == 1: gamma and the ring are unused
            assert m == 1 and not want.any()
            continue
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=name)


def _cell_case(rows, in_size, hidden, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    u = lambda *s, scale=1.0: (rng.uniform(-1, 1, s) * scale).astype(dtype)
    args = [u(in_size, 4 * hidden, scale=in_size ** -0.5), u(hidden, 4 * hidden, scale=hidden ** -0.5),
            u(4 * hidden, scale=0.1), u(rows, in_size), u(rows, hidden), u(rows, hidden, scale=2.0)]
    return args, u(rows, hidden), u(rows, hidden)


@pytest.mark.parametrize("rows,in_size,hidden", [(6, 14, 8), (33, 8, 8), (4, 5, 3),
                                                 (5, 64, 64), (3, 18, 128)])
def test_lstm_cell_grads_match_jax_pallas(rows, in_size, hidden):
    args, w_h, w_c = _cell_case(rows, in_size, hidden, seed=rows)

    def jax_loss(*a):
        h, c = jops.lstm_cell(*a)
        return jnp.sum(h * w_h) + jnp.sum(c * w_c)

    want_h, want_c = jops.lstm_cell(*(jnp.asarray(a) for a in args))
    want = jax.grad(jax_loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    h, c = ops.lstm_cell(*targs)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(want_c), rtol=0, atol=1e-5)
    ((h * torch.from_numpy(w_h)).sum() + (c * torch.from_numpy(w_c)).sum()).backward()
    for name, t, w in zip(("wx", "wh", "b", "x", "h", "c"), targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_lstm_cell_fwd_ref_matches_plain_forward():
    args, _, _ = _cell_case(9, 7, 5, seed=1)
    targs = [torch.from_numpy(a) for a in args]
    h, c, act = ref.lstm_cell_fwd_ref(*targs)
    h0, c0 = ref.lstm_cell_ref(*targs)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)
    torch.testing.assert_close(c, c0, rtol=0, atol=0)
    assert act.shape == (9, 20) and float(act[:, 10:15].abs().max()) < 1.0   # tanh g


def test_no_grad_cell_takes_the_inference_path():
    args, _, _ = _cell_case(3, 4, 2, seed=2)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    with torch.no_grad():
        h, _ = ops.lstm_cell(*targs)
    assert h.grad_fn is None
    h, _ = ops.lstm_cell(*targs)
    assert type(h.grad_fn).__name__ == "LSTMCellBackward"


def test_functions_gradcheck_float64():
    y, logits, _, _ = _hw_case(4, 7, 3, seed=0, dtype=np.float64)
    y_tm = torch.from_numpy(y.T.copy()).requires_grad_(True)
    alpha = torch.sigmoid(torch.from_numpy(logits["alpha_logit"])).requires_grad_(True)
    gamma = torch.sigmoid(torch.from_numpy(logits["gamma_logit"])).requires_grad_(True)
    init = torch.exp(torch.from_numpy(logits["init_seas_logit"].T.copy())).requires_grad_(True)
    assert torch.autograd.gradcheck(hw_scan.HWScan.apply, (y_tm, alpha, gamma, init))
    args, _, _ = _cell_case(5, 4, 3, seed=3, dtype=np.float64)
    assert torch.autograd.gradcheck(
        lstm_cell.LSTMCell.apply, [torch.from_numpy(a).requires_grad_(True) for a in args])


def test_hw_scan_function_handles_an_unused_output():
    y, logits, w_lev, _ = _hw_case(3, 8, 4, seed=5)
    tp = thw.HWParams(**{k: torch.from_numpy(v).requires_grad_(True) for k, v in logits.items()})
    lev, _ = ops.hw_scan(torch.from_numpy(y), tp, seasonality=4)
    (lev * torch.from_numpy(w_lev)).sum().backward()      # seas unused: zero cotangent
    for name in ("alpha_logit", "gamma_logit", "init_seas_logit"):
        assert torch.isfinite(getattr(tp, name).grad).all()
