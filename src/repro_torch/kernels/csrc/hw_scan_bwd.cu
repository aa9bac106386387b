// K2: adjoint of the Holt-Winters smoothing scan (time-reversed), fp32, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hw_scan.py:_hw_scan_bwd_kernel.
//
// With lam_t the level cotangent and sig_t the seasonality cotangent, the
// forward recurrence of K1 (hw_scan.cu) reverses to, for t = T-1 .. 0:
//   lam_t = dl_t + (1 - a) lam_{t+1} - sig_{t+m} g y_t / l_t^2
//   sig_t = ds_t + (1 - g) sig_{t+m} - lam_t a y_t / s_t^2
//   dy_t  = lam_t a / s_t + sig_{t+m} g / l_t    (+ (1 - a) lam_0 / s_0 at t = 0)
//   da   += lam_t (y_t / s_t - l_{t-1})          (l_{-1} = y_0 / s_0)
//   dg   += sig_{t+m} (y_t / l_t - s_t)
// The sigma ring is seeded with the trailing cotangents ds_T .. ds_{T+m-1};
// after the loop slot k holds sig_k = d init_seas_k, less the primer-level
// term (1 - a) lam_0 y_0 / s_0^2 on slot 0.
//
// Shapes, all time-major fp32: y, levels, dlev (T, N); seas, dseas (T+m, N);
// alpha, gamma (N,) in; dy (T, N), dalpha, dgamma (N,), dinit (m, N) out.
//
// Bound on the card: bytes. Each reverse step reads y_t, l_t, l_{t-1}, s_t,
// dl_t, ds_t and writes dy_t (the l_{t-1} read is the next step's l_t and
// comes from L1), a dozen flops and three divisions per series. Only seas
// rows 0..T-1 are read, so the kernel must stream at best
// 4 * N * (6T + 2m + 4) bytes: y, levels, dlev, seas, dy (T rows each),
// dseas (T+m), dinit (m), alpha, gamma, dalpha, dgamma (1 each). Design, as K1:
// * one thread per series walking t = T-1 .. 0 with lam, da, dg in registers;
// * time-major arrays, so each step's loads and stores are coalesced across
//   the warp;
// * the m-slot sigma ring, one column per thread (a register array indexed
//   by t mod m would spill), placed as K1 places its ring
//   (kernels/hw_scan.py:ring_plan): shared memory as [m][blockDim] floats,
//   opted in above 48 KB, or past the opt-in limit a [m][N] device buffer;
// * the ragged last block is masked (threads past N return at once).
//
// Rounding: every product and sum goes through __fmul_rn / __fadd_rn in the
// plain version's order (kernels/ref.py:hw_scan_bwd_ref), so nvcc cannot
// contract them into FMAs; with IEEE division the kernel rounds as the plain
// version does, operation for operation.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <bool GLOBAL_RING>
__global__ void hw_scan_bwd_kernel(const float* __restrict__ y,
                                   const float* __restrict__ alpha,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ levels,
                                   const float* __restrict__ seas,
                                   const float* __restrict__ dlev,
                                   const float* __restrict__ dseas,
                                   float* __restrict__ dy,
                                   float* __restrict__ dalpha,
                                   float* __restrict__ dgamma,
                                   float* __restrict__ dinit,
                                   float* __restrict__ ring_buf,
                                   int t_len, int n, int m) {
    extern __shared__ float smem_ring[];   // [m][blockDim.x], unless GLOBAL_RING
    const long col = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (col >= n) return;
    const long ln = n;
    // slot k of this series' ring is ring[k * bd] (as in K1)
    float* ring = GLOBAL_RING ? ring_buf + col : smem_ring + threadIdx.x;
    const long bd = GLOBAL_RING ? ln : static_cast<long>(blockDim.x);

    const float a = alpha[col];
    const float g = gamma[col];
    const float one_minus_a = __fadd_rn(1.0f, -a);
    const float one_minus_g = __fadd_rn(1.0f, -g);
    const float s00 = seas[col];
    const float y0 = y[col];
    for (int k = 0; k < m; ++k) {
        ring[((t_len + k) % m) * bd] = dseas[(t_len + k) * ln + col];
    }

    float lam = 0.0f, da = 0.0f, dg = 0.0f;
    int slot = (t_len - 1) % m;
    for (int t = t_len - 1; t >= 0; --t) {
        const long at = t * ln + col;
        const float y_t = y[at];
        const float l_t = levels[at];
        const float s_t = seas[at];
        const float l_prev = t > 0 ? levels[at - ln] : y0 / s00;
        const float sig_tpm = ring[slot * bd];
        lam = sub(add(dlev[at], mul(one_minus_a, lam)),
                  mul(mul(sig_tpm, g), y_t) / mul(l_t, l_t));
        const float sig_t = sub(add(dseas[at], mul(one_minus_g, sig_tpm)),
                                mul(mul(lam, a), y_t) / mul(s_t, s_t));
        ring[slot * bd] = sig_t;
        float dy_t = add(mul(lam, a) / s_t, mul(sig_tpm, g) / l_t);
        if (t == 0) dy_t = add(dy_t, mul(one_minus_a, lam) / s00);
        dy[at] = dy_t;
        da = add(da, mul(lam, sub(y_t / s_t, l_prev)));
        dg = add(dg, mul(sig_tpm, sub(y_t / l_t, s_t)));
        slot = (slot == 0) ? m - 1 : slot - 1;
    }
    dalpha[col] = da;
    dgamma[col] = dg;
    const float corr = mul(mul(one_minus_a, lam), y0) / mul(s00, s00);
    for (int k = 0; k < m; ++k) {
        const float v = ring[k * bd];
        dinit[k * ln + col] = k == 0 ? sub(v, corr) : v;
    }
}

}  // namespace

// ring: as in hw_scan_f32 (null: shared memory; else a [m][n] buffer)
extern "C" int hw_scan_bwd_f32(const void* y, const void* alpha, const void* gamma,
                               const void* levels, const void* seas,
                               const void* dlev, const void* dseas,
                               void* dy, void* dalpha, void* dgamma, void* dinit, void* ring,
                               int t_len, int n, int m, int block, void* stream) {
    const int grid = (n + block - 1) / block;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto args = [&](auto kernel, size_t smem) {
        kernel<<<grid, block, smem, st>>>(
            static_cast<const float*>(y), static_cast<const float*>(alpha),
            static_cast<const float*>(gamma), static_cast<const float*>(levels),
            static_cast<const float*>(seas), static_cast<const float*>(dlev),
            static_cast<const float*>(dseas), static_cast<float*>(dy),
            static_cast<float*>(dalpha), static_cast<float*>(dgamma),
            static_cast<float*>(dinit), static_cast<float*>(ring), t_len, n, m);
    };
    if (ring != nullptr) {
        args(hw_scan_bwd_kernel<true>, 0);
    } else {
        static repro::SmemOptIn opt_in;      // per device (common.cuh)
        const size_t smem = static_cast<size_t>(m) * block * sizeof(float);
        cudaError_t err =
            opt_in.ensure(reinterpret_cast<const void*>(hw_scan_bwd_kernel<false>), smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        args(hw_scan_bwd_kernel<false>, smem);
    }
    return static_cast<int>(cudaGetLastError());
}
