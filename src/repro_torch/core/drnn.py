"""Dilated residual LSTM stack (paper section 3.2, Table 1, Figure 1).

PyTorch counterpart of ``repro.core.drnn``. Blocks of LSTM layers; the layer
with dilation ``d`` connects cell/hidden state from step ``t - d`` to step
``t``. Blocks after the first add a residual connection from block input to
block output.

The shared weights live in ``nn.Module``s in the JAX orientation (``wx``
``(I, 4H)``, ``wh`` ``(H, 4H)``, ``b`` ``(4H,)``, gate order i, f, g, o), so
the JAX params pytree converts leaf by leaf (:mod:`repro_torch.convert`).

Two formulations:

* :func:`drnn_apply` -- the *interleaved* one: a dilation-d LSTM over T
  steps is d independent LSTMs over the stride-d sub-sequences, folded into
  the batch as ``(B*d, T/d)``. One :func:`lstm_cell` call per step of each
  layer; on the card each is one launch of the fused-cell kernel K3, or,
  when a gradient is needed, of K4 forward and K5 backward.
* :func:`drnn_apply_reference` -- the direct ring-buffer formulation, kept as
  the numerical oracle.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops


class LSTMCell(nn.Module):
    """One LSTM layer's weights: ``wx (I, 4H)``, ``wh (H, 4H)``, ``b (4H,)``."""

    def __init__(self, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.wx = nn.Parameter(wx)
        self.wh = nn.Parameter(wh)
        self.b = nn.Parameter(b)


def lstm_cell(cell: LSTMCell, x, h_prev, c_prev):
    """One fused LSTM step. x:(B,I) h,c:(B,H) -> (h,c):(B,H).

    Dispatches by device through ``kernels.ops.lstm_cell``: the CUDA kernel
    K3 for tensors on the card (K4/K5 when a gradient is needed), its plain
    version on the CPU.
    """
    return kernel_ops.lstm_cell(cell.wx, cell.wh, cell.b, x, h_prev, c_prev)


def uniform_init(generator, shape, scale):
    """Uniform in ``(-scale, scale)``, drawn on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * 2.0 - 1.0) * scale


def drnn_init(
    generator: torch.Generator,
    input_size: int,
    hidden_size: int,
    dilations: Sequence[Sequence[int]],
    *,
    dtype=torch.float32,
    device=None,
) -> nn.ModuleList:
    """Weights for the dilated stack: blocks of :class:`LSTMCell`.

    ``dilations`` e.g. ((1, 2), (4, 8)). Weights are uniform in
    ``(-1, 1) / sqrt(fan_in)`` per matrix, biases zero, drawn from
    ``generator`` and placed on ``device``.
    """
    dev = resolve_device(device)
    blocks = nn.ModuleList()
    in_size = input_size
    for block in dilations:
        cells = nn.ModuleList()
        for _d in block:
            wx = uniform_init(generator, (in_size, 4 * hidden_size),
                              1.0 / math.sqrt(in_size))
            wh = uniform_init(generator, (hidden_size, 4 * hidden_size),
                              1.0 / math.sqrt(hidden_size))
            cells.append(LSTMCell(wx.to(dev, dtype), wh.to(dev, dtype),
                                  torch.zeros(4 * hidden_size, dtype=dtype, device=dev)))
            in_size = hidden_size
        blocks.append(cells)
    return blocks


# ---------------------------------------------------------------------------
# interleaved (production) formulation
# ---------------------------------------------------------------------------


def _dilated_layer(cell: LSTMCell, xs, d: int, *, keep_cells: bool):
    """One dilation-d LSTM layer over xs (B, T, F) via stride-d interleave.

    Returns the hidden sequence (B, T, H) and, if ``keep_cells``, the cell
    sequence (else None).
    """
    b, t, f = xs.shape
    hidden = cell.wh.shape[0]
    if d == 1:
        xr = xs
        bd = b
    else:
        # right zero-pad of time to a multiple of d, then
        # (B, T/d, d, F) -> (B, d, T/d, F) -> (B*d, T/d, F): row j is the
        # stride-d sub-sequence starting at offset j -- an independent chain
        xp = F.pad(xs, (0, 0, 0, (-t) % d))
        tp = xp.shape[1]
        xr = (xp.reshape(b, tp // d, d, f).permute(0, 2, 1, 3)
              .reshape(b * d, tp // d, f))
        bd = b * d

    # time-major and contiguous, so every step's (B*d, F) slice is dense
    x_tm = xr.transpose(0, 1).contiguous()
    h = torch.zeros((bd, hidden), dtype=xs.dtype, device=xs.device)
    c = torch.zeros((bd, hidden), dtype=xs.dtype, device=xs.device)
    hs, cs = [], []
    for x_t in x_tm:
        h, c = lstm_cell(cell, x_t, h, c)
        hs.append(h)
        if keep_cells:
            cs.append(c)

    def untangle(seq):
        out = torch.stack(seq, dim=1)                    # (B*d, T/d, H)
        if d > 1:
            tp = out.shape[1] * d
            out = (out.reshape(b, d, tp // d, hidden).permute(0, 2, 1, 3)
                   .reshape(b, tp, hidden))[:, :t]
        return out

    return untangle(hs), (untangle(cs) if keep_cells else None)


def drnn_apply(
    params: nn.ModuleList,
    xs: torch.Tensor,
    *,
    dilations: Tuple[Tuple[int, ...], ...],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the stack over a sequence.

    Args:
      params: from :func:`drnn_init`.
      xs: ``(B, T, input_size)``.

    Returns:
      outputs ``(B, T, hidden)`` and the mean squared cell state of the
      *first layer of each block* (scalar) -- the section 8.4 Krueger &
      Memisevic stabilization penalty term.
    """
    inp = xs
    cstate_sq = torch.zeros((), dtype=torch.float32, device=xs.device)
    n_terms = 0
    for bi, (block, bparams) in enumerate(zip(dilations, params)):
        block_in = inp
        for li, (d, cell) in enumerate(zip(block, bparams)):
            inp, cs = _dilated_layer(cell, inp, d, keep_cells=li == 0)
            if li == 0:
                cstate_sq = cstate_sq + torch.mean(torch.square(cs.float()))
                n_terms += 1
        if bi > 0:  # residual between blocks (dims match at hidden)
            inp = inp + block_in
    return inp, cstate_sq / max(n_terms, 1)


# ---------------------------------------------------------------------------
# ring-buffer reference (numerical oracle for the interleaved path)
# ---------------------------------------------------------------------------


def drnn_apply_reference(
    params: nn.ModuleList,
    xs: torch.Tensor,
    *,
    dilations: Tuple[Tuple[int, ...], ...],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct formulation: per-layer rings of d (B, H) states, slot t mod d."""
    b, t_len, _ = xs.shape
    hidden = params[0][0].wh.shape[0]
    zeros = lambda: torch.zeros((b, hidden), dtype=xs.dtype, device=xs.device)
    cells = [cell for blk in params for cell in blk]
    layer_dils = [d for blk in dilations for d in blk]
    rings = [([zeros() for _ in range(d)], [zeros() for _ in range(d)])
             for d in layer_dils]
    first_layer_idx, acc = [], 0
    for blk in dilations:
        first_layer_idx.append(acc)
        acc += len(blk)

    outs, cstate_sqs = [], []
    for t in range(t_len):
        inp = xs[:, t].contiguous()
        cstate_sq = torch.zeros((), dtype=torch.float32, device=xs.device)
        li = 0
        for bi, blk in enumerate(dilations):
            block_in = inp
            for _ in blk:
                h_ring, c_ring = rings[li]
                slot = t % layer_dils[li]
                h, c = lstm_cell(cells[li], inp, h_ring[slot], c_ring[slot])
                h_ring[slot], c_ring[slot] = h, c
                if li == first_layer_idx[bi]:
                    cstate_sq = cstate_sq + torch.mean(torch.square(c.float()))
                inp = h
                li += 1
            if bi > 0:
                inp = inp + block_in
        outs.append(inp)
        cstate_sqs.append(cstate_sq)
    return (torch.stack(outs, dim=1),
            torch.mean(torch.stack(cstate_sqs)) / max(len(dilations), 1))
