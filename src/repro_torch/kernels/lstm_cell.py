"""K3: the fused LSTM cell as a CUDA kernel (``csrc/lstm_cell.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/lstm_cell.py:_lstm_kernel``
(the inference forward; ``_lstm_fwd_kernel`` and ``_lstm_bwd_kernel`` come
with training). One thread per (row, hidden unit) forms the four gate dots in
fp32 and does the cell update, so the ``(B, 4H)`` gates never reach device
memory; the weights are read through L1. Its plain version is
:func:`repro_torch.kernels.ref.lstm_cell_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

BLOCK = 256                      # threads per block, one per (row, unit)

# launches of the kernel since the last reset (kernels.ops.reset_launch_counts)
launches = 0


def lstm_cell(wx, wh, b, x, h, c):
    """Launch K3. wx:(I,4H) wh:(H,4H) b:(4H,) x:(B,I) h,c:(B,H) -> h', c'.

    All float32, contiguous, on one CUDA device; gate order (i, f, g, o).
    Raises on anything else -- it never computes on the CPU.
    """
    global launches
    rows, in_size = x.shape
    hidden = h.shape[1]
    dev = x.device
    build.check_inputs("lstm_cell", [
        ("wx", wx, (in_size, 4 * hidden)), ("wh", wh, (hidden, 4 * hidden)),
        ("b", b, (4 * hidden,)), ("x", x, (rows, in_size)),
        ("h", h, (rows, hidden)), ("c", c, (rows, hidden))], dev)
    if rows < 1 or hidden < 1:
        raise ValueError(f"lstm_cell: empty problem (B={rows}, H={hidden})")

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
