"""K6: GQA flash attention as a CUDA kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py:_flash_kernel``: online-softmax
attention with fp32 ``(m, l, acc)``, an end-aligned causal mask and GQA as
an index map. V has a head dim of its own, ``DV <= D`` (MLA's prefill: q and
k 192 wide, v 128); the reference's kernel takes only ``DV == D``. One
block owns one (batch x query head, query tile) and walks the key tiles
itself (the TPU's sequential grid axis becomes a loop in the block). bf16
is warp-specialised: a producer warpgroup feeds Q and a ring of K/V tiles
by TMA, two consumer warpgroups run both products as ``wgmma``; fp32 runs
on the CUDA cores. The kernel masks ragged Tq and Tk itself, so nothing is
padded; a bf16 head dim of 80 (zamba2) runs the 128-wide tile over rows of
80, the tile's columns past 80 zero-filled by TMA. At (D, DV) = (64, 64)
the bf16 kernel runs its own schedule (``flash_tc_bf16_overlap``): each
warpgroup issues S_j = Q . K_j^T beside P_{j-1} . V_{j-1} and runs tile j's
softmax under the latter, the two warpgroups take turns to issue
(pingpong), and the K/V ring is 4 stages deep, so the exponentials run
under the tensor-core work that D = 64 makes as short as they are.

A bf16 call at (D, DV) = (64, 64) with at most 16 query rows a kv head
(G * Tq <= 16, G = Hq / Hkv: whisper's cross-attention decode, G * Tq = 1)
takes the decode route instead (``flash_decode_bf16``): one block per
(batch x kv head, key split) scores the GQA group's rows as one m16 tile
with ``mma.sync`` and writes a partial (m, l, acc) in fp32 to a workspace;
a second kernel combines the splits. :func:`decode_plan` picks the splits.
Each call counts once in ``launches``, a decode-route call once more in
``decode_launches``. See the source for the design and the bound. The
plain version is :func:`~repro_torch.kernels.ref.attention_ref`, which
:func:`repro_torch.kernels.ops.flash_attention` takes for CPU tensors;
:func:`~repro_torch.kernels.ref.attention_decode_ref` is the decode route's
split-and-combine in plain torch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

MMA_BQ = 128                     # query rows per block, bf16 (tensor cores)
SIMT_BQ = 16                     # query rows per block, fp32
SIMT_MAX_D, SIMT_MAX_DV = 192, 128
# the (D, DV) of flash_tc_bf16; (80, 80) runs the (128, 128) tile, TMA
# zero-filling the columns past 80
MMA_HEAD_DIMS = ((64, 64), (128, 128), (192, 128), (80, 80))
_MAX_GRID_Y = 65535
# the decode route (csrc/flash_attention.cu, flash_decode_bf16)
DECODE_HEAD_DIMS = (64, 64)
DECODE_MAX_ROWS = 16             # G * Tq query rows a kv head: one m16 tile
DECODE_MIN_KEYS = 128            # keys a split at least
DECODE_BLOCKS_PER_SM = 2         # splits enough for this many blocks an SM

# launches since the last reset (kernels.ops.reset_launch_counts): every
# K6 call, and those of them that took the decode route
launches = 0
decode_launches = 0


class DecodePlan(NamedTuple):
    """A decode-route launch: ``splits`` blocks a (batch, kv head), split
    ``s`` taking keys ``[s * keys, min((s + 1) * keys, Tk))``."""
    splits: int
    keys: int


def decode_plan(bkv: int, tk: int, sm_count: int) -> DecodePlan:
    """Split ``tk`` keys of each of ``bkv`` (batch x kv head) rows of blocks
    so that the grid holds ``DECODE_BLOCKS_PER_SM`` blocks an SM where every
    split keeps ``DECODE_MIN_KEYS`` keys; every key in exactly one split,
    none empty. whisper's cross decode (64 kv heads x 1,500 keys on 132
    SMs): 5 splits of 300 keys, 320 blocks."""
    want = -(-DECODE_BLOCKS_PER_SM * sm_count // bkv)
    splits = max(1, min(want, tk // DECODE_MIN_KEYS))
    keys = -(-tk // splits)
    return DecodePlan(-(-tk // keys), keys)


def takes_decode_route(dtype, hq: int, hkv: int, tq: int, d: int, dv: int) -> bool:
    """Whether a call of these shapes runs ``flash_decode_bf16``: bf16 at
    ``DECODE_HEAD_DIMS`` with G * Tq <= ``DECODE_MAX_ROWS``. Shape only."""
    return (dtype == torch.bfloat16 and (d, dv) == DECODE_HEAD_DIMS
            and hq // hkv * tq <= DECODE_MAX_ROWS)


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """Launch K6. q: (B, Hq, Tq, D); k: (B, Hkv, Tk, D); v: (B, Hkv, Tk, DV)
    -> (B, Hq, Tq, DV).

    All three contiguous, of one dtype (bfloat16 with (D, DV) in
    ``MMA_HEAD_DIMS``, or float32 with D <= 192 and DV <= min(D, 128)), on
    one CUDA device; Hq % Hkv == 0; under the causal mask Tq <= Tk (queries
    sit at the end of the key timeline). ``scale`` defaults to 1/sqrt(D)
    and must not be negative (the row max is taken over the unscaled
    scores).
    Raises on anything else -- it never computes on the CPU.
    """
    global launches, decode_launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k and v must be 4-D, got {q.dim()}-D, "
                         f"{k.dim()}-D and {v.dim()}-D")
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dv = v.shape[3]
    dtype = q.dtype
    build.check_inputs("flash_attention", [
        ("q", q, (b, hq, tq, d)), ("k", k, (b, hkv, tk, d)), ("v", v, (b, hkv, tk, dv))],
        q.device, dtypes=(torch.bfloat16, torch.float32))
    if k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"flash_attention: q, k, v are {dtype}, {k.dtype}, {v.dtype}; "
                        f"the kernel takes one dtype")
    if min(b, hq, hkv, tq, tk, d, dv) < 1:
        raise ValueError(f"flash_attention: empty problem {tuple(q.shape)} x {tuple(k.shape)}")
    if hq % hkv:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of Hkv={hkv}")
    if causal and tq > tk:
        raise ValueError(f"flash_attention: causal with Tq={tq} > Tk={tk} leaves rows "
                         f"with no visible key")
    if dtype == torch.bfloat16:
        if (d, dv) not in MMA_HEAD_DIMS:
            raise ValueError(f"flash_attention: bf16 head dims (D, DV) = ({d}, {dv}) not in "
                             f"{MMA_HEAD_DIMS}")
        block_q, entry = MMA_BQ, "flash_attention_bf16"
    else:
        if d > SIMT_MAX_D or dv > min(d, SIMT_MAX_DV):
            raise ValueError(f"flash_attention: fp32 head dims (D, DV) = ({d}, {dv}); the "
                             f"kernel takes D <= {SIMT_MAX_D} and DV <= min(D, {SIMT_MAX_DV})")
        block_q, entry = SIMT_BQ, "flash_attention_f32"
    if -(-tq // block_q) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: Tq={tq} needs more than {_MAX_GRID_Y} query tiles")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start 16-byte aligned")
    scale = float(d ** -0.5 if scale is None else scale)
    if not scale >= 0:
        raise ValueError(f"flash_attention: scale {scale}; the kernels fold a scale >= 0 into "
                         f"their exponentials")

    out = q.new_empty((b, hq, tq, dv))
    lib = build.library()
    decode = takes_decode_route(dtype, hq, hkv, tq, d, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if decode:
            plan = decode_plan(b * hkv, tk, build.device_limits(q.device).sm_count)
            rows = b * hkv * plan.splits * (hq // hkv) * tq
            part_acc = torch.empty((rows, dv), dtype=torch.float32, device=q.device)
            part_ml = torch.empty((rows, 2), dtype=torch.float32, device=q.device)
            err = lib.flash_attention_decode_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                part_ml.data_ptr(), b, hq, hkv, tq, tk, plan.splits, plan.keys, int(causal),
                scale, stream)
        else:
            err = getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, tq, tk, d, dv, int(causal), scale, stream)
    build.check(err, "flash_attention")
    launches += 1
    decode_launches += decode
    return out
