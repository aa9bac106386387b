"""Plain PyTorch versions of the port's CUDA kernels.

Each kernel in ``csrc/`` is held against the function here: the wrappers in
:mod:`repro_torch.kernels.ops` take these for tensors on the CPU (the parity
tests), and ``chip_smoke.py`` compares every kernel with its plain version on
the card. They repeat the kernels' arithmetic in the same order of
operations and are no yardstick of speed.
"""

from __future__ import annotations

import torch


def hw_scan_ref(y, alpha, gamma, init_seas):
    """Constrained-space Holt-Winters recurrence (see core/holt_winters.py).

    y: (N, T) > 0; alpha, gamma: (N,) in (0,1); init_seas: (N, M) > 0.
    Returns levels (N, T), seas (N, T+M)  [seas[:, t] = s_t applied to y_t].
    """
    t_len = y.shape[1]
    ring = list(init_seas.unbind(1))          # ring[0] is the current s_t
    l_prev = y[:, 0] / ring[0]
    one_minus_a = 1.0 - alpha
    one_minus_g = 1.0 - gamma
    levels, seas_used = [], []
    for t in range(t_len):
        y_t = y[:, t]
        s_t = ring.pop(0)
        l_t = alpha * y_t / s_t + one_minus_a * l_prev
        ring.append(gamma * y_t / l_t + one_minus_g * s_t)
        levels.append(l_t)
        seas_used.append(s_t)
        l_prev = l_t
    return (torch.stack(levels, dim=1),
            torch.stack(seas_used + ring, dim=1))


def lstm_cell_ref(wx, wh, b, x, h, c):
    """Fused LSTM cell. wx:(I,4H) wh:(H,4H) b:(4H,) x:(B,I) h,c:(B,H).

    Gate order (i, f, g, o)."""
    gates = x @ wx + h @ wh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new
