"""K1: the Holt-Winters smoothing scan as a CUDA kernel (``csrc/hw_scan.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/hw_scan.py:_hw_scan_kernel``
(forward only; its backward, ``_hw_scan_bwd_kernel``, comes with training).
The kernel runs one thread per series with the time loop in registers and
the m-slot seasonality ring in shared memory; it is bound by the bytes it
streams (see the source for the design). Its plain version is
:func:`repro_torch.kernels.ref.hw_scan_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

BLOCK = 128                      # series per thread block
_MAX_STATIC_SMEM = 48 * 1024     # the ring must fit without opt-in smem

# launches of the kernel since the last reset (kernels.ops.reset_launch_counts)
launches = 0


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
    if t_len < 1 or n < 1 or m < 1:
        raise ValueError(f"hw_scan: empty problem (T={t_len}, N={n}, M={m})")
    if m * BLOCK * 4 > _MAX_STATIC_SMEM:
        raise ValueError(f"hw_scan: a ring of {m} slots does not fit shared memory")

    levels = torch.empty((t_len, n), dtype=torch.float32, device=dev)
    seas = torch.empty((t_len + m, n), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hw_scan_f32(
            y_tm.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
            init_seas_tm.data_ptr(), levels.data_ptr(), seas.data_ptr(),
            t_len, n, m, BLOCK, stream)
    build.check(err, "hw_scan")
    launches += 1
    return levels, seas
