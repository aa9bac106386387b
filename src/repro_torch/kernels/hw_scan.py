"""K1 and K2: the Holt-Winters smoothing scan and its adjoint as CUDA kernels.

K1 (``csrc/hw_scan.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/hw_scan.py:_hw_scan_kernel``, K2 (``csrc/hw_scan_bwd.cu``)
its backward ``_hw_scan_bwd_kernel``. Both run one thread per series with the
time loop in registers, blocks of 32 series that stage time tiles of their
input streams in shared memory by ``cp.async`` ahead of the walk (K2 from
the end backwards), and an m-slot ring (seasonality forward, its cotangent
backward) in shared memory, opted-in shared memory or a device buffer. They
walk groups of four or eight steps, dividing by IEEE division's fast path
without its per-division branch and redoing a group with ``/`` when an
operand is out of that path's range, so the outputs are the same bits as
one operation at a time. :func:`scan_plan` sizes each launch; both are bound by
the bytes they stream at large N and by the chain of steps at small N (see
the sources for the design). :class:`HWScan` is the
``torch.autograd.Function`` around the pair, the counterpart of the JAX
``custom_vjp``: it saves ``(y, alpha, gamma, levels, seas)`` and its
backward runs K2. On CPU tensors the same Function runs the plain versions
:func:`~repro_torch.kernels.ref.hw_scan_ref` and
:func:`~repro_torch.kernels.ref.hw_scan_bwd_ref`.

Both also take y in bf16 (the bf16 policy's observation stream): each
kernel, templated on y's element type, stages half-width y tiles and widens
each y_t; alpha, gamma, the ring, the state and every other stream and
output stay float32, except K2's dy, which is rounded to bf16 once as it is
stored. Widening is exact, so both give the plain versions' bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref, shapes

SCAN_BLOCK = 32                  # series per block: one warp, a thread per series
SCAN_TILES = (128, 64, 32, 16, 8)   # rows per staged tile, the plan takes the largest that fits
SCAN_PIPE = 3                    # tiles in flight or walked (csrc/hw_scan.cuh)
DEFAULT_SMEM = 48 * 1024         # dynamic shared memory without an opt-in
BLOCK_RESERVED = 1024            # shared memory an SM keeps per resident block
FWD_STREAMS = 1                  # K1 stages y
BWD_STREAMS = 5                  # K2 stages y, levels, seas, dlev, dseas
RING_PLACES = ("shared", "optin", "global")   # ScanPlan.ring, by index

# launches since the last reset (kernels.ops.reset_launch_counts)
launches = 0                     # K1, float32 y
bf16_launches = 0                # K1, bf16 y
bwd_launches = 0                 # K2, float32 y
bwd_bf16_launches = 0            # K2, bf16 y


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ScanPlan(NamedTuple):
    """A K1/K2 launch; the kernel takes these ints in this order
    (``csrc/hw_scan.cuh``, ``ScanPlan``)."""
    block: int       # series per block, one thread each
    tile: int        # rows per staged tile
    stages: int      # tile buffers: min(SCAN_PIPE, tiles of T)
    copy: int        # bytes per copy of y: 16 where its rows are 16-byte aligned, else one element
    copy_rest: int   # the same for K2's float streams (levels, seas, dlev, dseas); 0 in K1
    ring: int        # where the m-slot ring lives: an index of RING_PLACES
    smem: int        # dynamic shared memory, bytes
    blocks: int      # the grid


def _copy_bytes(n: int, elem: int, aligned: bool) -> int:
    """16-byte copies where every row of an ``elem``-byte stream of ``n``
    series starts on 16 bytes, else one element a copy."""
    return 16 if aligned and (n * elem) % 16 == 0 else elem


@functools.lru_cache(maxsize=4096)
def scan_plan(n: int, t_len: int, m: int, smem_optin: int, sm_count: int,
              streams: int = FWD_STREAMS, aligned: bool = True, elem: int = 4) -> ScanPlan:
    """K1's (``streams=FWD_STREAMS``) or K2's (``BWD_STREAMS``) launch for
    ``n`` series of ``t_len`` steps and an ``m``-slot ring, on a device with
    ``sm_count`` SMs and ``smem_optin`` bytes of opt-in shared memory per
    block (an SM holds that and 1 KB per block). The first staged stream is
    y, of ``elem`` bytes an element (4, or 2 under the bf16 policy); K2's
    other four are float32, as is the ring. A tile row of a block stages
    ``elem + 4 * (streams - 1)`` bytes per series.

    * 32 series per block, so that large batches spread over every SM in
      one even wave (750 blocks at the forecast's 24,000 series) and small
      ones over as many SMs as they have warps;
    * ``min(SCAN_PIPE, tiles)`` tile buffers of ``streams`` tiles each;
    * the ring after the tiles in shared memory wherever it fits beside the
      smallest tiles: without an opt-in up to 48 KB, opted in above;
      else in an ``(m, N)`` device buffer the wrapper allocates;
    * tiles of the most rows of SCAN_TILES, no more than T needs, with which
      every block of the grid is resident at once (each tile boundary costs
      the walk a wait and a barrier, so fewer tiles are faster);
    * per stream, 16-byte copies where its rows are 16-byte aligned (``N``
      a multiple of 4 for a float32 stream, of 8 for bf16, and ``aligned``
      base pointers), else one element per copy.

    The arithmetic and its order are the same in every plan.
    """
    block = SCAN_BLOCK
    blocks = _cdiv(n, block)
    per_sm = _cdiv(blocks, sm_count)
    ring_bytes = 4 * m * block
    row_bytes = elem + 4 * (streams - 1)      # staged bytes per series and tile row

    def layout(tile):
        stages = min(SCAN_PIPE, _cdiv(t_len, tile))
        return stages, row_bytes * stages * tile * block

    ring_shared = layout(SCAN_TILES[-1])[1] + ring_bytes <= smem_optin
    cap = next((t for t in reversed(SCAN_TILES) if t >= t_len), SCAN_TILES[0])
    for tile in SCAN_TILES:
        stages, tiles_bytes = layout(tile)
        smem = tiles_bytes + (ring_bytes if ring_shared else 0)
        resident = per_sm * (smem + BLOCK_RESERVED) <= smem_optin + BLOCK_RESERVED
        if tile <= cap and smem <= smem_optin and resident:
            break
    where = "global" if not ring_shared else ("shared" if smem <= DEFAULT_SMEM else "optin")
    copy_rest = _copy_bytes(n, 4, aligned) if streams > 1 else 0
    return ScanPlan(block, tile, stages, _copy_bytes(n, elem, aligned), copy_rest,
                    RING_PLACES.index(where), smem, blocks)


_plan_ints = build.plan_ints


def _launch_plan(kernel: str, t_len: int, n: int, m: int, dev, streams: int, staged):
    """The launch's plan and ring buffer (None: the ring is in shared memory)."""
    if t_len < 1 or n < 1 or m < 1:
        raise ValueError(f"{kernel}: empty problem (T={t_len}, N={n}, M={m})")
    limits = build.device_limits(dev)
    aligned = all(t.data_ptr() % 16 == 0 for t in staged)
    # staged[0] is y, the only stream that may be bf16 (the rest are float32)
    plan = scan_plan(n, t_len, m, limits.smem_optin, limits.sm_count, streams, aligned,
                     staged[0].element_size())
    ring = (torch.empty((m, n), dtype=torch.float32, device=dev)
            if RING_PLACES[plan.ring] == "global" else None)
    return plan, ring


def hw_scan_tm(y_tm, alpha, gamma, init_seas_tm):
    """Launch K1. y_tm: (T, N); alpha/gamma: (N,); init_seas_tm: (M, N).

    y float32 or bfloat16, the rest float32; all contiguous, on one CUDA
    device. Returns float32 levels_tm (T, N) and seas_tm (T+M, N). Raises on
    anything else -- it never computes on the CPU.
    """
    global launches, bf16_launches
    t_len, n = y_tm.shape
    m = init_seas_tm.shape[0]
    dev = y_tm.device
    build.check_inputs("hw_scan", [("y_tm", y_tm, (t_len, n))], dev,
                       dtypes=(torch.float32, torch.bfloat16))
    build.check_inputs("hw_scan", [
        ("alpha", alpha, (n,)), ("gamma", gamma, (n,)),
        ("init_seas_tm", init_seas_tm, (m, n))], dev)
    bf16 = y_tm.dtype == torch.bfloat16
    plan, ring = _launch_plan("hw_scan", t_len, n, m, dev, FWD_STREAMS, [y_tm])

    levels = torch.empty((t_len, n), dtype=torch.float32, device=dev)
    seas = torch.empty((t_len + m, n), dtype=torch.float32, device=dev)
    plan_ints = _plan_ints(plan)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = (lib.hw_scan_bf16 if bf16 else lib.hw_scan_f32)(
            y_tm.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
            init_seas_tm.data_ptr(), levels.data_ptr(), seas.data_ptr(),
            None if ring is None else ring.data_ptr(), ctypes.addressof(plan_ints),
            len(plan_ints), t_len, n, m, stream)
    build.check(err, "hw_scan")
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return levels, seas


def hw_scan_bwd_tm(y_tm, alpha, gamma, levels_tm, seas_tm, dlev_tm, dseas_tm):
    """Launch K2: the adjoint of :func:`hw_scan_tm`.

    y_tm, levels_tm, dlev_tm: (T, N); alpha/gamma: (N,); seas_tm, dseas_tm:
    (T+M, N); y float32 or bfloat16, the rest float32; all contiguous, on
    one CUDA device. Returns dy_tm (T, N) in y's dtype, and float32 dalpha
    (N,), dgamma (N,), d init_seas_tm (M, N). Raises on anything else.
    """
    global bwd_launches, bwd_bf16_launches
    t_len, n = y_tm.shape
    m = seas_tm.shape[0] - t_len
    dev = y_tm.device
    build.check_inputs("hw_scan_bwd", [("y_tm", y_tm, (t_len, n))], dev,
                       dtypes=(torch.float32, torch.bfloat16))
    build.check_inputs("hw_scan_bwd", [
        ("alpha", alpha, (n,)), ("gamma", gamma, (n,)),
        ("levels_tm", levels_tm, (t_len, n)), ("seas_tm", seas_tm, (t_len + m, n)),
        ("dlev_tm", dlev_tm, (t_len, n)), ("dseas_tm", dseas_tm, (t_len + m, n))], dev)
    bf16 = y_tm.dtype == torch.bfloat16
    plan, ring = _launch_plan("hw_scan_bwd", t_len, n, m, dev, BWD_STREAMS,
                              [y_tm, levels_tm, seas_tm, dlev_tm, dseas_tm])

    dy = torch.empty((t_len, n), dtype=y_tm.dtype, device=dev)
    dalpha = torch.empty((n,), dtype=torch.float32, device=dev)
    dgamma = torch.empty((n,), dtype=torch.float32, device=dev)
    dinit = torch.empty((m, n), dtype=torch.float32, device=dev)
    plan_ints = _plan_ints(plan)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = (lib.hw_scan_bwd_bf16 if bf16 else lib.hw_scan_bwd_f32)(
            y_tm.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
            levels_tm.data_ptr(), seas_tm.data_ptr(), dlev_tm.data_ptr(),
            dseas_tm.data_ptr(), dy.data_ptr(), dalpha.data_ptr(),
            dgamma.data_ptr(), dinit.data_ptr(),
            None if ring is None else ring.data_ptr(), ctypes.addressof(plan_ints),
            len(plan_ints), t_len, n, m, stream)
    build.check(err, "hw_scan_bwd")
    if bf16:
        bwd_bf16_launches += 1
    else:
        bwd_launches += 1
    return dy, dalpha, dgamma, dinit


class HWScan(torch.autograd.Function):
    """Differentiable time-major HW scan: K1 forward, K2 backward on the card;
    the plain versions on the CPU. ``apply(y_tm, alpha, gamma, init_seas_tm)
    -> (levels_tm, seas_tm)``."""

    @staticmethod
    def forward(ctx, y_tm, alpha, gamma, init_seas_tm):
        shapes.note("hw_scan", y_tm, alpha, gamma, init_seas_tm)
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
        shapes.note("hw_scan_bwd", y_tm, alpha, gamma, levels, seas)
        if y_tm.device.type == "cuda":
            return hw_scan_bwd_tm(y_tm, alpha, gamma, levels, seas,
                                  dlev.contiguous(), dseas.contiguous())
        dy, da, dg, dinit = ref.hw_scan_bwd_ref(
            y_tm.t(), alpha, gamma, levels.t(), seas.t(), dlev.t(), dseas.t())
        return dy.t(), da, dg, dinit.t()
