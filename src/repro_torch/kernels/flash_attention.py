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
80, the tile's columns past 80 zero-filled by TMA. See the source for the design and the bound. The plain version is
:func:`~repro_torch.kernels.ref.attention_ref`, which
:func:`repro_torch.kernels.ops.flash_attention` takes for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

MMA_BQ = 128                     # query rows per block, bf16 (tensor cores)
SIMT_BQ = 16                     # query rows per block, fp32
SIMT_MAX_D, SIMT_MAX_DV = 192, 128
# the (D, DV) of flash_tc_bf16; (80, 80) runs the (128, 128) tile, TMA
# zero-filling the columns past 80
MMA_HEAD_DIMS = ((64, 64), (128, 128), (192, 128), (80, 80))
_MAX_GRID_Y = 65535

# launches since the last reset (kernels.ops.reset_launch_counts)
launches = 0


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """Launch K6. q: (B, Hq, Tq, D); k: (B, Hkv, Tk, D); v: (B, Hkv, Tk, DV)
    -> (B, Hq, Tq, DV).

    All three contiguous, of one dtype (bfloat16 with (D, DV) in
    ``MMA_HEAD_DIMS``, or float32 with D <= 192 and DV <= min(D, 128)), on
    one CUDA device; Hq % Hkv == 0; under the causal mask Tq <= Tk (queries
    sit at the end of the key timeline). ``scale`` defaults to 1/sqrt(D).
    Raises on anything else -- it never computes on the CPU.
    """
    global launches
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

    out = q.new_empty((b, hq, tq, dv))
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, tq, tk, d, dv, int(causal), scale, stream)
    build.check(err, "flash_attention")
    launches += 1
    return out
