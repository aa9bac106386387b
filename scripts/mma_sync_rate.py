#!/usr/bin/env python3
"""The rate at which one SM of the card issues mma.sync m16n8k16 (bf16 in,
float32 sums) and ldmatrix.x4, by warps per block: the instructions the
tensor-core cell kernels (K3/K4/K5 in bf16) are built from.

    python3 scripts/mma_sync_rate.py

Builds a one-block microbenchmark with nvcc (the kernels' own fragment
helpers, ``src/repro_torch/kernels/csrc/tc_common.cuh``) into the kernels'
build directory, runs it on the current CUDA device and prints one JSON
object: the card's name and power limit, and for 1 to 16 warps the SM
cycles (``clock64``) per loop iteration of four ldmatrix.x4, of six
independent mma.sync, and of both, with the cycles per mma on one SM
sub-partition (four sub-partitions an SM, warp w on sub-partition w % 4).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BUILD = ROOT / "src" / "repro_torch" / "kernels" / "_build"

SOURCE = r"""
#include <cuda_bf16.h>
#include <cstdio>
#include "tc_common.cuh"

// mode 1: four ldmatrix.x4; mode 2: six mma.sync on six accumulators; 3: both
__global__ void bench(int mode, int iters, long long* cycles, float* sink) {
    __shared__ __align__(16) unsigned char sm[16 * 1024];
    for (int i = threadIdx.x; i < 16 * 1024 / 4; i += blockDim.x)
        reinterpret_cast<unsigned*>(sm)[i] = 0x3f803f80u;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const unsigned base = smem_addr(sm) + (lane & 15) * 336 + (lane >> 4) * 16;
    float acc[6][4] = {};
    unsigned a[3][4], b[4];
    for (int k = 0; k < 3; ++k) ldmatrix_x4(a[k], base + k * 32);
    ldmatrix_x4(b, base + 96);
    __syncthreads();
    const long long t0 = clock64();
    for (int it = 0; it < iters; ++it) {
        if (mode & 1) {
            for (int k = 0; k < 3; ++k) ldmatrix_x4(a[k], base + ((it + k) & 7) * 32);
            ldmatrix_x4(b, base + ((it + 5) & 7) * 32 + 1344);
        }
        if (mode & 2) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                mma_bf16(acc[2 * k], a[k], b[0], b[1]);
                mma_bf16(acc[2 * k + 1], a[k], b[2], b[3]);
            }
        }
    }
    const long long t1 = clock64();
    float s = __uint_as_float(a[0][0] ^ b[0]);
    for (int i = 0; i < 6; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
    sink[threadIdx.x] = s;
    if (threadIdx.x == 0) *cycles = t1 - t0;
}

int main() {
    long long* cycles;
    float* sink;
    if (cudaMalloc(&cycles, 8) != cudaSuccess) return 1;
    if (cudaMalloc(&sink, 4096 * 4) != cudaSuccess) return 1;
    const int iters = 2000;
    for (int warps : {1, 2, 4, 8, 16}) {
        for (int mode : {1, 2, 3}) {
            for (int rep = 0; rep < 2; ++rep) bench<<<1, 32 * warps>>>(mode, iters, cycles, sink);
            if (cudaDeviceSynchronize() != cudaSuccess) return 1;
            long long c = 0;
            cudaMemcpy(&c, cycles, 8, cudaMemcpyDeviceToHost);
            printf("%d %d %.2f\n", warps, mode, double(c) / iters);
        }
    }
    return 0;
}
"""


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    BUILD.mkdir(parents=True, exist_ok=True)
    src, exe = BUILD / "mma_sync_rate.cu", BUILD / "mma_sync_rate"
    src.write_text(SOURCE)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import _nvcc

    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                    "-I", str(CSRC), "-o", str(exe), str(src)], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    names = {1: "ldmatrix_x4_4", 2: "mma_6", 3: "both"}
    rows = {}
    for line in out.split("\n"):
        if not line.strip():
            continue
        warps, mode, per_iter = line.split()
        rec = rows.setdefault(int(warps), {})
        rec[names[int(mode)] + "_cycles_per_iter"] = float(per_iter)
        if int(mode) == 2:   # six mma a warp an iteration; warp w on sub-partition w % 4
            per_sp = -(-int(warps) // 4)
            rec["cycles_per_mma_per_subpartition"] = float(per_iter) / (6 * per_sp)
    print(json.dumps({"card": smi, "by_warps": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
