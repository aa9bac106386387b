"""Public wrappers around the port's kernels: dispatch by device.

A tensor on a CUDA device launches the hand-written kernel
(:mod:`~repro_torch.kernels.hw_scan`, :mod:`~repro_torch.kernels.lstm_cell`,
:mod:`~repro_torch.kernels.flash_attention`);
a tensor on the CPU takes the kernel's plain PyTorch version
(:mod:`~repro_torch.kernels.ref`). That is the only rule: there is no flag,
and a CUDA tensor never falls back to the plain version -- the kernel
launches or raises.

Both wrappers are differentiable. The HW scan always runs through the
``torch.autograd.Function`` :class:`~repro_torch.kernels.hw_scan.HWScan`
(K1 forward, K2 backward on the card). The LSTM cell runs through
:class:`~repro_torch.kernels.lstm_cell.LSTMCell` (K4 forward, K5 backward,
or K5's dx-only launch when the weights need no gradient) only when a
gradient is needed, and through K3 otherwise -- the JAX
package's ``custom_vjp`` rule, whose primal is the activation-free kernel.
On CPU tensors the same Functions run the plain forward and backward, so
the CPU tests exercise the wiring the card uses.

Every entry point reports each call's ``(kernel, input shapes, dtype)`` to
the launch-shape hook (:mod:`~repro_torch.kernels.shapes`) before it runs,
the plain versions too: what a launch-shape counter counts.

The constrained-space transforms (sigmoid/exp) and the layout changes
(time-major for the HW scan) run here, outside the kernels, as in the JAX
package's ``kernels/ops.py``. The CUDA kernels mask their ragged edges
themselves, so nothing is padded.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hw_scan as _hw
from repro_torch.kernels import lstm_cell as _lstm
from repro_torch.kernels import ref, shapes


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch kernels run on cuda or cpu, not {t.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`, by
    kernel and stream dtype: the names without a suffix count float32
    launches, ``_bf16`` the bf16 policy's (K1 and K2 with a bf16 y, K3, K4
    and K5 in bf16). K5 counts its two launches apart: ``lstm_cell_bwd``
    forms the weight gradients too, ``lstm_cell_bwd_dx`` only dx, dh_prev
    and dc_prev (a step whose weights need no gradient, the esn head's).
    K6 counts every call in ``flash_attention`` and, of those, the calls
    that took its decode route (bf16, D 64, G * Tq <= 16) in
    ``flash_attention_decode``."""
    return {"hw_scan": _hw.launches, "hw_scan_bf16": _hw.bf16_launches,
            "hw_scan_bwd": _hw.bwd_launches, "hw_scan_bwd_bf16": _hw.bwd_bf16_launches,
            "lstm_cell": _lstm.launches, "lstm_cell_bf16": _lstm.bf16_launches,
            "lstm_cell_fwd": _lstm.fwd_launches, "lstm_cell_fwd_bf16": _lstm.fwd_bf16_launches,
            "lstm_cell_bwd": _lstm.bwd_launches, "lstm_cell_bwd_bf16": _lstm.bwd_bf16_launches,
            "lstm_cell_bwd_dx": _lstm.bwd_dx_launches,
            "lstm_cell_bwd_dx_bf16": _lstm.bwd_dx_bf16_launches,
            "flash_attention": _fa.launches,
            "flash_attention_decode": _fa.decode_launches}


def reset_launch_counts() -> None:
    _hw.launches = _hw.bf16_launches = _hw.bwd_launches = _hw.bwd_bf16_launches = 0
    _lstm.launches = _lstm.bf16_launches = 0
    _lstm.fwd_launches = _lstm.fwd_bf16_launches = 0
    _lstm.bwd_launches = _lstm.bwd_bf16_launches = 0
    _lstm.bwd_dx_launches = _lstm.bwd_dx_bf16_launches = 0
    _fa.launches = _fa.decode_launches = 0


# ---------------------------------------------------------------------------


def hw_scan(y, params, *, seasonality: int):
    """Kernel-backed equivalent of core.holt_winters.hw_smooth (single ring).

    y: (N, T); params: HWParams. Returns levels (N, T), seas (N, T+m).
    """
    n = y.shape[0]
    m = max(seasonality, 1)
    c = params.constrained()
    alpha, gamma = c["alpha"], c["gamma"]
    # flat ring in the param dtype; for m == 1 a zero gamma keeps s == 1
    init_seas = (c["init_seas"] if seasonality > 1
                 else torch.ones((n, m), dtype=alpha.dtype, device=alpha.device))
    if seasonality <= 1:
        gamma = torch.zeros_like(gamma)
    _on_cuda(y)                   # raises on a device other than cuda or cpu
    levels_tm, seas_tm = _hw.HWScan.apply(
        y.t().contiguous(), alpha.contiguous(), gamma.contiguous(),
        init_seas.t().contiguous())
    return levels_tm.t(), seas_tm.t()


def lstm_cell(wx, wh, b, x, h, c):
    """Fused LSTM cell; signature mirrors ref.lstm_cell_ref."""
    cuda = _on_cuda(x)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (wx, wh, b, x, h, c)):
        return _lstm.LSTMCell.apply(wx, wh, b, x, h, c)
    shapes.note("lstm_cell", wx, wh, b, x, h, c)
    if not cuda:
        return ref.lstm_cell_ref(wx, wh, b, x, h, c)
    return _lstm.lstm_cell(wx, wh, b, x, h, c)


def flash_attention(q, k, v, *, causal: bool, scale=None):
    """GQA attention, end-aligned causal; signature mirrors ref.attention_ref.

    q: (B, Hq, Tq, D); k: (B, Hkv, Tk, D); v: (B, Hkv, Tk, DV) -> (B, Hq,
    Tq, DV). A CUDA tensor launches K6 (no gradient: the JAX kernel has none
    either); a CPU tensor takes the plain version. Unlike the JAX wrapper
    nothing is padded: the kernel masks ragged Tq and Tk itself.
    """
    shapes.note("flash_attention", q, k, v)
    if not _on_cuda(q):
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale)
