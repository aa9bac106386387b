// K1: batched Holt-Winters smoothing scan (forward), fp32, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hw_scan.py:_hw_scan_kernel.
//
// Recurrence (Smyl variant, multiplicative seasonality, no trend), per series:
//   l_{-1}  = y_0 / s_0                                   (primer level)
//   l_t     = alpha * y_t / s_t + (1 - alpha) * l_{t-1}
//   s_{t+m} = gamma * y_t / l_t + (1 - gamma) * s_t
// Outputs: levels (T, N) and seas (T + m, N), time-major; seas[t] is the s_t
// applied to y_t, rows T .. T+m-1 are the future factors left in the ring.
//
// Bound on the card: bytes. Each step does a handful of flops per series and
// moves 12 bytes (y_t in, l_t and s_t out), so the kernel can at best stream
// its 4 * N * (3T + 2m + 2) bytes at the HBM rate. Design for that:
// * one thread per series, the time loop in registers; series are independent
//   so nothing is shared between threads;
// * time-major (T, N) arrays make each step's loads and stores coalesced
//   across the warp (neighbouring threads touch neighbouring series);
// * the m-slot seasonality ring is indexed by a rotating slot (a register
//   array indexed by t mod m would spill to local memory). Where it lives
//   is the wrapper's choice (kernels/hw_scan.py:ring_plan, by m and the
//   device's opt-in limit): in shared memory as [m][blockDim] floats, 128
//   series per block while that fits 48 KB (m <= 96; the presets' m <= 24
//   take 12 KB at most), fewer series (down to 32) and opted-in shared
//   memory above that; past the opt-in limit in a [m][N] device buffer the
//   wrapper allocates, where neighbouring threads touch neighbouring
//   series, so each step's ring access is coalesced like y's. The
//   arithmetic is the same in all three;
// * the ragged last block is masked (threads past N return at once; no
//   thread reads another's ring column, so no barrier is needed).
//
// Rounding: the additions and products go through __fmul_rn / __fadd_rn so
// that nvcc cannot contract them into FMAs; with IEEE division (no
// --use_fast_math) every step then rounds exactly as the plain PyTorch
// version does, operation for operation.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

template <bool GLOBAL_RING>
__global__ void hw_scan_kernel(const float* __restrict__ y,
                               const float* __restrict__ alpha,
                               const float* __restrict__ gamma,
                               const float* __restrict__ init_seas,
                               float* __restrict__ levels,
                               float* __restrict__ seas,
                               float* __restrict__ ring_buf,
                               int t_len, int n, int m) {
    extern __shared__ float smem_ring[];   // [m][blockDim.x], unless GLOBAL_RING
    const long col = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (col >= n) return;
    // slot k of this series' ring is ring[k * bd]: a shared-memory column,
    // or a column of the [m][N] device buffer
    float* ring = GLOBAL_RING ? ring_buf + col : smem_ring + threadIdx.x;
    const long bd = GLOBAL_RING ? static_cast<long>(n) : static_cast<long>(blockDim.x);

    const float a = alpha[col];
    const float g = gamma[col];
    const float one_minus_a = __fadd_rn(1.0f, -a);
    const float one_minus_g = __fadd_rn(1.0f, -g);
    for (int k = 0; k < m; ++k) ring[k * bd] = init_seas[k * static_cast<long>(n) + col];

    float level = y[col] / ring[0];   // primer l_{-1} = y_0 / s_0
    int slot = 0;
    for (int t = 0; t < t_len; ++t) {
        const long at = t * static_cast<long>(n) + col;
        const float y_t = y[at];
        const float s_t = ring[slot * bd];
        const float l_t = __fadd_rn(__fmul_rn(a, y_t) / s_t, __fmul_rn(one_minus_a, level));
        const float s_new = __fadd_rn(__fmul_rn(g, y_t) / l_t, __fmul_rn(one_minus_g, s_t));
        ring[slot * bd] = s_new;
        levels[at] = l_t;
        seas[at] = s_t;
        level = l_t;
        slot = (slot + 1 == m) ? 0 : slot + 1;
    }
    // future factors s_T .. s_{T+m-1} sit in ring slots (T + k) mod m
    for (int k = 0; k < m; ++k) {
        seas[(t_len + k) * static_cast<long>(n) + col] = ring[((t_len + k) % m) * bd];
    }
}

}  // namespace

// ring: null for a shared-memory ring of m x block floats (opted in above
// 48 KB), else a [m][n] float buffer; the block is the wrapper's ring_plan
extern "C" int hw_scan_f32(const void* y, const void* alpha, const void* gamma,
                           const void* init_seas, void* levels, void* seas, void* ring,
                           int t_len, int n, int m, int block, void* stream) {
    const int grid = (n + block - 1) / block;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto args = [&](auto kernel, size_t smem) {
        kernel<<<grid, block, smem, st>>>(
            static_cast<const float*>(y), static_cast<const float*>(alpha),
            static_cast<const float*>(gamma), static_cast<const float*>(init_seas),
            static_cast<float*>(levels), static_cast<float*>(seas), static_cast<float*>(ring),
            t_len, n, m);
    };
    if (ring != nullptr) {
        args(hw_scan_kernel<true>, 0);
    } else {
        static repro::SmemOptIn opt_in;      // per device (common.cuh)
        const size_t smem = static_cast<size_t>(m) * block * sizeof(float);
        cudaError_t err = opt_in.ensure(reinterpret_cast<const void*>(hw_scan_kernel<false>), smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        args(hw_scan_kernel<false>, smem);
    }
    return static_cast<int>(cudaGetLastError());
}
