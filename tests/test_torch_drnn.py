"""Parity of the port's LSTM cell and dilated stack with the JAX reference.

Weights are drawn with numpy from a seed, shaped as the JAX params pytree and
converted leaf by leaf (``repro_torch.convert``). The JAX side runs both its
plain path and its Pallas cell kernel (interpret mode on the CPU, as the JAX
package's own kernel tests run it). Tolerance atol 1e-5: the gate products
sum in another order than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import drnn as jdrnn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import params_from_numpy
from repro_torch.core import drnn as tdrnn
from repro_torch.kernels import ops as tops

ATOL = 1e-5


def _rnn_tree(in_size, hidden, dilations, seed=0):
    rng = np.random.default_rng(seed)
    u = lambda *shape, s: rng.uniform(-s, s, shape).astype(np.float32)
    tree, fan_in = [], in_size
    for block in dilations:
        cells = []
        for _ in block:
            cells.append({"wx": u(fan_in, 4 * hidden, s=fan_in ** -0.5),
                          "wh": u(hidden, 4 * hidden, s=hidden ** -0.5),
                          "b": u(4 * hidden, s=0.1)})
            fan_in = hidden
        tree.append(cells)
    return tree


def _port_rnn(tree):
    return params_from_numpy({"hw": {"alpha_logit": np.zeros(1, np.float32),
                                     "gamma_logit": np.zeros(1, np.float32),
                                     "init_seas_logit": np.zeros((1, 1), np.float32)},
                              "rnn": tree}, "cpu")["rnn"]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("rows,in_size,hidden", [(5, 14, 8), (16, 40, 40), (3, 7, 50)])
def test_lstm_cell_matches_jax_kernel_and_reference(rows, in_size, hidden):
    rng = np.random.default_rng(rows)
    cell = _rnn_tree(in_size, hidden, ((1,),), seed=rows)[0][0]
    x = rng.normal(0, 1, (rows, in_size)).astype(np.float32)
    h = rng.normal(0, 0.5, (rows, hidden)).astype(np.float32)
    c = rng.normal(0, 1.5, (rows, hidden)).astype(np.float32)
    args = [cell["wx"], cell["wh"], cell["b"], x, h, c]
    want_kernel = jops.lstm_cell(*(jnp.asarray(a) for a in args))   # Pallas
    want_ref = jref.lstm_cell_ref(*(jnp.asarray(a) for a in args))
    port_cell = _port_rnn([[cell]])[0][0]
    got = tdrnn.lstm_cell(port_cell, *(torch.from_numpy(a) for a in (x, h, c)))
    got_ops = tops.lstm_cell(*(torch.from_numpy(a) for a in args))
    for g, g_ops, wk, wr in zip(got, got_ops, want_kernel, want_ref):
        assert torch.equal(g, g_ops)
        _close(g.detach(), wk)
        _close(g.detach(), wr)


@pytest.mark.parametrize("dilations,t_len", [
    (((1, 2), (4, 8)), 13),       # quarterly stack, T not a multiple of d
    (((1, 3), (6, 12)), 30),      # monthly stack
    (((1, 2), (2, 6)), 8),        # yearly stack
])
def test_drnn_apply_matches_jax(dilations, t_len):
    rng = np.random.default_rng(t_len)
    b, in_size, hidden = 3, 10, 8
    tree = _rnn_tree(in_size, hidden, dilations, seed=t_len)
    xs = rng.normal(0, 1, (b, t_len, in_size)).astype(np.float32)
    want, want_c = jdrnn.drnn_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                    jnp.asarray(xs), dilations=dilations)
    with torch.no_grad():
        got, got_c = tdrnn.drnn_apply(_port_rnn(tree), torch.from_numpy(xs),
                                      dilations=dilations)
    assert got.shape == (b, t_len, hidden)
    _close(got, want)
    _close(got_c, want_c)


def test_drnn_apply_matches_jax_pallas_cells():
    dilations = ((1, 2), (4,))
    rng = np.random.default_rng(3)
    tree = _rnn_tree(6, 8, dilations, seed=3)
    xs = rng.normal(0, 1, (2, 9, 6)).astype(np.float32)
    want, want_c = jdrnn.drnn_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                    jnp.asarray(xs), dilations=dilations,
                                    use_pallas=True)
    with torch.no_grad():
        got, got_c = tdrnn.drnn_apply(_port_rnn(tree), torch.from_numpy(xs),
                                      dilations=dilations)
    _close(got, want)
    _close(got_c, want_c)


@pytest.mark.parametrize("dilations,t_len", [(((1, 2), (4, 8)), 19), (((1, 3), (6, 12)), 25)])
def test_interleaved_matches_ring_buffer_reference(dilations, t_len):
    rng = np.random.default_rng(11)
    tree = _rnn_tree(5, 8, dilations, seed=11)
    xs = torch.from_numpy(rng.normal(0, 1, (4, t_len, 5)).astype(np.float32))
    rnn = _port_rnn(tree)
    with torch.no_grad():
        got, got_c = tdrnn.drnn_apply(rnn, xs, dilations=dilations)
        want, want_c = tdrnn.drnn_apply_reference(rnn, xs, dilations=dilations)
    _close(got, want)
    _close(got_c, want_c)
    # and the JAX oracle agrees with the port's
    j_want, j_c = jdrnn.drnn_apply_reference(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(xs.numpy()),
        dilations=dilations)
    _close(want, j_want)
    _close(want_c, j_c)


def test_drnn_init_shapes_bounds_and_seed():
    dil = ((1, 2), (4, 8))
    gen = lambda: torch.Generator().manual_seed(5)
    a = tdrnn.drnn_init(gen(), 14, 40, dil, device="cpu")
    b = tdrnn.drnn_init(gen(), 14, 40, dil, device="cpu")
    jax_shapes = jax.tree_util.tree_map(
        lambda x: x.shape, jdrnn.drnn_init(jax.random.PRNGKey(0), 14, 40, dil))
    for bi, block in enumerate(a):
        for li, cell in enumerate(block):
            for name in ("wx", "wh", "b"):
                w = getattr(cell, name)
                assert tuple(w.shape) == jax_shapes[bi][li][name]
                assert torch.equal(w, getattr(b[bi][li], name))
            fan_in = cell.wx.shape[0]
            assert float(cell.wx.detach().abs().max()) <= fan_in ** -0.5
            assert float(cell.wh.detach().abs().max()) <= 40 ** -0.5
            assert not cell.b.detach().any()
