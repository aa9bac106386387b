"""K1 and K2: the Holt-Winters smoothing scan and its adjoint as CUDA kernels.

K1 (``csrc/hw_scan.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/hw_scan.py:_hw_scan_kernel``, K2 (``csrc/hw_scan_bwd.cu``)
its backward ``_hw_scan_bwd_kernel``. Both run one thread per series with the
time loop in registers and an m-slot ring (seasonality forward, its
cotangent backward) that :func:`ring_plan` places by its size: shared
memory, opted-in shared memory with fewer series per block, or a device
buffer. Both are bound by the bytes they stream (see the sources for the
design). :class:`HWScan` is the
``torch.autograd.Function`` around the pair, the counterpart of the JAX
``custom_vjp``: it saves ``(y, alpha, gamma, levels, seas)`` and its
backward runs K2. On CPU tensors the same Function runs the plain versions
:func:`~repro_torch.kernels.ref.hw_scan_ref` and
:func:`~repro_torch.kernels.ref.hw_scan_bwd_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

BLOCK = 128                      # series per thread block
MIN_BLOCK = 32                   # the fewest series per block an opted-in ring takes
DEFAULT_SMEM = 48 * 1024         # dynamic shared memory without an opt-in

# launches since the last reset (kernels.ops.reset_launch_counts)
launches = 0                     # K1
bwd_launches = 0                 # K2


def ring_plan(m: int, smem_optin: int):
    """Where K1/K2 keep an m-slot ring of fp32 per series, and how many
    series a block takes: ``(block, where)``.

    * ``"shared"``: 128 series per block while the m x 128 ring fits 48 KB
      (m <= 96, every preset);
    * ``"optin"``: the most series per block, 128 down to 32 by halving,
      whose ring fits the device's opt-in shared memory ``smem_optin``
      (232,448 bytes on an H100: m <= 1,816 at 32 series);
    * ``"global"``: past that, 128 series per block and the ring in a
      ``(m, N)`` device buffer the wrapper allocates.

    The arithmetic is the same in all three.
    """
    if m * BLOCK * 4 <= DEFAULT_SMEM:
        return BLOCK, "shared"
    block = BLOCK
    while block >= MIN_BLOCK:
        if m * block * 4 <= smem_optin:
            return block, "optin"
        block //= 2
    return BLOCK, "global"


def _ring(kernel: str, t_len: int, n: int, m: int, dev):
    """The launch's block and ring buffer (None: the ring is in shared memory)."""
    if t_len < 1 or n < 1 or m < 1:
        raise ValueError(f"{kernel}: empty problem (T={t_len}, N={n}, M={m})")
    block, where = ring_plan(m, build.device_limits(dev).smem_optin)
    if where != "global":
        return block, None
    return block, torch.empty((m, n), dtype=torch.float32, device=dev)


def hw_scan_tm(y_tm, alpha, gamma, init_seas_tm):
    """Launch K1. y_tm: (T, N); alpha/gamma: (N,); init_seas_tm: (M, N).

    All float32, contiguous, on one CUDA device. Returns levels_tm (T, N) and
    seas_tm (T+M, N). Raises on anything else -- it never computes on the CPU.
    """
    global launches
    t_len, n = y_tm.shape
    m = init_seas_tm.shape[0]
    dev = y_tm.device
    build.check_inputs("hw_scan", [
        ("y_tm", y_tm, (t_len, n)), ("alpha", alpha, (n,)), ("gamma", gamma, (n,)),
        ("init_seas_tm", init_seas_tm, (m, n))], dev)
    block, ring = _ring("hw_scan", t_len, n, m, dev)

    levels = torch.empty((t_len, n), dtype=torch.float32, device=dev)
    seas = torch.empty((t_len + m, n), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hw_scan_f32(
            y_tm.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
            init_seas_tm.data_ptr(), levels.data_ptr(), seas.data_ptr(),
            None if ring is None else ring.data_ptr(), t_len, n, m, block, stream)
    build.check(err, "hw_scan")
    launches += 1
    return levels, seas


def hw_scan_bwd_tm(y_tm, alpha, gamma, levels_tm, seas_tm, dlev_tm, dseas_tm):
    """Launch K2: the adjoint of :func:`hw_scan_tm`.

    y_tm, levels_tm, dlev_tm: (T, N); alpha/gamma: (N,); seas_tm, dseas_tm:
    (T+M, N); all float32, contiguous, on one CUDA device. Returns dy_tm
    (T, N), dalpha (N,), dgamma (N,), d init_seas_tm (M, N). Raises on
    anything else.
    """
    global bwd_launches
    t_len, n = y_tm.shape
    m = seas_tm.shape[0] - t_len
    dev = y_tm.device
    build.check_inputs("hw_scan_bwd", [
        ("y_tm", y_tm, (t_len, n)), ("alpha", alpha, (n,)), ("gamma", gamma, (n,)),
        ("levels_tm", levels_tm, (t_len, n)), ("seas_tm", seas_tm, (t_len + m, n)),
        ("dlev_tm", dlev_tm, (t_len, n)), ("dseas_tm", dseas_tm, (t_len + m, n))], dev)
    block, ring = _ring("hw_scan_bwd", t_len, n, m, dev)

    dy = torch.empty((t_len, n), dtype=torch.float32, device=dev)
    dalpha = torch.empty((n,), dtype=torch.float32, device=dev)
    dgamma = torch.empty((n,), dtype=torch.float32, device=dev)
    dinit = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hw_scan_bwd_f32(
            y_tm.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
            levels_tm.data_ptr(), seas_tm.data_ptr(), dlev_tm.data_ptr(),
            dseas_tm.data_ptr(), dy.data_ptr(), dalpha.data_ptr(),
            dgamma.data_ptr(), dinit.data_ptr(),
            None if ring is None else ring.data_ptr(), t_len, n, m, block, stream)
    build.check(err, "hw_scan_bwd")
    bwd_launches += 1
    return dy, dalpha, dgamma, dinit


class HWScan(torch.autograd.Function):
    """Differentiable time-major HW scan: K1 forward, K2 backward on the card;
    the plain versions on the CPU. ``apply(y_tm, alpha, gamma, init_seas_tm)
    -> (levels_tm, seas_tm)``."""

    @staticmethod
    def forward(ctx, y_tm, alpha, gamma, init_seas_tm):
        if y_tm.device.type == "cuda":
            levels, seas = hw_scan_tm(y_tm, alpha, gamma, init_seas_tm)
        else:
            lev, sea = ref.hw_scan_ref(y_tm.t(), alpha, gamma, init_seas_tm.t())
            levels, seas = lev.t().contiguous(), sea.t().contiguous()
        # residuals: the inputs plus the (levels, seas) the forward emits
        # (seas row 0 is init_seas row 0, so the ring itself is not saved)
        ctx.save_for_backward(y_tm, alpha, gamma, levels, seas)
        return levels, seas

    @staticmethod
    def backward(ctx, dlev, dseas):
        y_tm, alpha, gamma, levels, seas = ctx.saved_tensors
        # set_materialize_grads is on (the default): an unused output comes
        # in as zeros, never None
        if y_tm.device.type == "cuda":
            return hw_scan_bwd_tm(y_tm, alpha, gamma, levels, seas,
                                  dlev.contiguous(), dseas.contiguous())
        dy, da, dg, dinit = ref.hw_scan_bwd_ref(
            y_tm.t(), alpha, gamma, levels.t(), seas.t(), dlev.t(), dseas.t())
        return dy.t(), da, dg, dinit.t()
