"""K3, K4, K5: the fused LSTM cell, its training forward and its backward.

All three live in ``csrc/lstm_cell.cu`` and replace the Pallas TPU kernels
of ``src/repro/kernels/lstm_cell.py``: K3 ``_lstm_kernel`` (the inference
forward), K4 ``_lstm_fwd_kernel`` (the same forward, also writing the gate
activations ``(B, 4H)`` the backward needs) and K5 ``_lstm_bwd_kernel``.
K3 and K4 are one kernel: the weights in shared memory, each thread one
hidden unit of 8 rows, a persistent grid over row tiles; both keep the
``(B, 4H)`` gates out of device memory. K5 forms the gate cotangents,
``dx``, ``dh_prev`` and ``dc_prev`` per row tile and sums the weight
gradients over the batch in a fixed order (two passes, no float atomics),
so it is deterministic. See the source for the design and bounds.

:class:`LSTMCell` is the ``torch.autograd.Function`` around K4/K5 (the
counterpart of the JAX ``custom_vjp``); the plain versions are
:func:`~repro_torch.kernels.ref.lstm_cell_ref`,
:func:`~repro_torch.kernels.ref.lstm_cell_fwd_ref` and
:func:`~repro_torch.kernels.ref.lstm_cell_bwd_ref`, which the same Function
runs on CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

BLOCK = 256                      # threads per block of K5 (K3/K4 pick their own)
ROWS_PER_TILE = 32               # K5's row tile (one block each)
_MAX_STATIC_SMEM = 48 * 1024     # K5's tile must fit without opt-in smem

# launches since the last reset (kernels.ops.reset_launch_counts)
launches = 0                     # K3
fwd_launches = 0                 # K4
bwd_launches = 0                 # K5


def _cell_shapes(kernel, wx, wh, b, x, h, c):
    rows, in_size = x.shape
    hidden = h.shape[1]
    dev = x.device
    build.check_inputs(kernel, [
        ("wx", wx, (in_size, 4 * hidden)), ("wh", wh, (hidden, 4 * hidden)),
        ("b", b, (4 * hidden,)), ("x", x, (rows, in_size)),
        ("h", h, (rows, hidden)), ("c", c, (rows, hidden))], dev)
    if rows < 1 or hidden < 1:
        raise ValueError(f"{kernel}: empty problem (B={rows}, H={hidden})")
    return rows, in_size, hidden, dev


def lstm_cell(wx, wh, b, x, h, c):
    """Launch K3. wx:(I,4H) wh:(H,4H) b:(4H,) x:(B,I) h,c:(B,H) -> h', c'.

    All float32, contiguous, on one CUDA device; gate order (i, f, g, o).
    Raises on anything else -- it never computes on the CPU.
    """
    global launches
    rows, in_size, hidden, dev = _cell_shapes("lstm_cell", wx, wh, b, x, h, c)
    h_out = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    c_out = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_cell_f32(
            wx.data_ptr(), wh.data_ptr(), b.data_ptr(), x.data_ptr(),
            h.data_ptr(), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            rows, in_size, hidden, BLOCK, stream)
    build.check(err, "lstm_cell")
    launches += 1
    return h_out, c_out


def lstm_cell_fwd(wx, wh, b, x, h, c):
    """Launch K4: K3 that also returns ``act = [sig i | sig f | tanh g | sig o]``
    (B, 4H). Same inputs and checks as :func:`lstm_cell`."""
    global fwd_launches
    rows, in_size, hidden, dev = _cell_shapes("lstm_cell_fwd", wx, wh, b, x, h, c)
    h_out = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    c_out = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
    act = torch.empty((rows, 4 * hidden), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_cell_fwd_f32(
            wx.data_ptr(), wh.data_ptr(), b.data_ptr(), x.data_ptr(),
            h.data_ptr(), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            act.data_ptr(), rows, in_size, hidden, BLOCK, stream)
    build.check(err, "lstm_cell_fwd")
    fwd_launches += 1
    return h_out, c_out, act


def lstm_cell_bwd(wx, wh, x, h, c, c_new, act, dh, dc):
    """Launch K5: ``(dh, dc)`` -> ``dx (B,I), dh_prev (B,H), dc_prev (B,H),
    dwx (I,4H), dwh (H,4H), db (4H,)``, all float32 on the card.

    The weight gradients are summed over B deterministically: per-tile
    partials in a scratch buffer, then a fixed-order second pass.
    """
    global bwd_launches
    rows, in_size = x.shape
    hidden = h.shape[1]
    dev = x.device
    g4 = 4 * hidden
    build.check_inputs("lstm_cell_bwd", [
        ("wx", wx, (in_size, g4)), ("wh", wh, (hidden, g4)),
        ("x", x, (rows, in_size)), ("h", h, (rows, hidden)), ("c", c, (rows, hidden)),
        ("c_new", c_new, (rows, hidden)), ("act", act, (rows, g4)),
        ("dh", dh, (rows, hidden)), ("dc", dc, (rows, hidden))], dev)
    if rows < 1 or hidden < 1:
        raise ValueError(f"lstm_cell_bwd: empty problem (B={rows}, H={hidden})")
    if ROWS_PER_TILE * (g4 + 1 + in_size + hidden) * 4 > _MAX_STATIC_SMEM:
        raise ValueError(
            f"lstm_cell_bwd: a tile of I={in_size}, H={hidden} does not fit shared memory")
    tiles = -(-rows // ROWS_PER_TILE)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((rows, in_size), **f32)
    dh_prev = torch.empty((rows, hidden), **f32)
    dc_prev = torch.empty((rows, hidden), **f32)
    dwx = torch.empty((in_size, g4), **f32)
    dwh = torch.empty((hidden, g4), **f32)
    db = torch.empty((g4,), **f32)
    scratch = torch.empty((tiles, in_size + hidden + 1, g4), **f32)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_cell_bwd_f32(
            wx.data_ptr(), wh.data_ptr(), x.data_ptr(), h.data_ptr(), c.data_ptr(),
            c_new.data_ptr(), act.data_ptr(), dh.data_ptr(), dc.data_ptr(),
            dx.data_ptr(), dh_prev.data_ptr(), dc_prev.data_ptr(), dwx.data_ptr(),
            dwh.data_ptr(), db.data_ptr(), scratch.data_ptr(),
            rows, in_size, hidden, ROWS_PER_TILE, BLOCK, stream)
    build.check(err, "lstm_cell_bwd")
    bwd_launches += 1
    return dx, dh_prev, dc_prev, dwx, dwh, db


class LSTMCell(torch.autograd.Function):
    """Differentiable fused cell: K4 forward, K5 backward on the card; the
    plain versions on the CPU. ``apply(wx, wh, b, x, h, c) -> (h', c')``."""

    @staticmethod
    def forward(ctx, wx, wh, b, x, h, c):
        if x.device.type == "cuda":
            h_new, c_new, act = lstm_cell_fwd(wx, wh, b, x, h, c)
        else:
            h_new, c_new, act = ref.lstm_cell_fwd_ref(wx, wh, b, x, h, c)
        ctx.save_for_backward(wx, wh, x, h, c, c_new, act)
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh, dc):
        wx, wh, x, h, c, c_new, act = ctx.saved_tensors
        # set_materialize_grads is on (the default): the cotangent of an
        # unused output (the last step's c) comes in as zeros, never None
        if x.device.type == "cuda":
            dx, dhp, dcp, dwx, dwh, db = lstm_cell_bwd(
                wx, wh, x, h, c, c_new, act, dh.contiguous(), dc.contiguous())
        else:
            dx, dhp, dcp, dwx, dwh, db = ref.lstm_cell_bwd_ref(
                wx, wh, x, h, c, c_new, act, dh, dc)
        return dwx, dwh, db, dx, dhp, dcp
