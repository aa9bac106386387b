// K1: batched Holt-Winters smoothing scan (forward), sm_90a; y in fp32 or
// bf16, the state and the outputs in fp32.
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
// its 4 * N * (3T + 2m + 2) bytes at the HBM rate: 37.8 MB, 0.0113 ms at
// the forecast's N = 24,000, T = 128, m = 4. That rate needs about 20 KB in
// flight per SM (3.35 TB/s x ~0.8 us of latency, over 132 SMs). A thread
// that loads y_t when it reaches step t has 4 bytes in flight and pays a
// round trip per step; at small N (a serve bucket, B <= 64) nothing but the
// chain of steps is left. So the design moves the loads ahead of the walk
// and shortens the chain:
// * one thread per series walks t = 0 .. T-1 with the state in registers
//   (the order of every operation is fixed; series are independent);
// * a block of `block` series (32, one warp) stages `tile` x block tiles
//   of y in shared memory by cp.async, through a pipeline of up to
//   SCAN_PIPE = 3 tiles (hw_scan.cuh): while it walks tile j, tiles j + 1
//   and j + 2 are on their way. The plan (kernels/hw_scan.py:scan_plan)
//   takes the longest tile, up to 128 rows, with which every block is
//   resident: at the forecast's shape one 128-row tile, 16 KB a block, 750
//   blocks, 5-6 per SM in one wave, so about 100 KB of y is requested per
//   SM at once. Rows 16-byte aligned (N a multiple of 4) copy 16 bytes at a
//   time; other rows (N = 1, 3, ...) 4 bytes per series and row, never
//   through a padded copy;
// * the walk takes groups of steps (repro::by_group: 8 at m = 4 and at
//   m >= 8, 4 at m = 1 and 5..7): it reads their y_t and the ring slots
//   written m or more steps earlier, carries in registers the s_{t+m} a
//   step of the group hands a later one, and runs the group as one
//   straight block, dividing by repro::FastDiv (hw_scan.cuh): the
//   five-FFMA fast path of IEEE division without its per-division branch,
//   so the divisions of a group overlap and the range checks and the ring's
//   round trip through shared memory come once a group. An operand outside
//   FastDiv's range sends the group back through IEEE division; either way
//   each quotient is IEEE's;
// * levels and seas rows are stored straight from the thread: neighbouring
//   threads write neighbouring series, so each step's stores are coalesced;
// * the m-slot seasonality ring is indexed by a rotating slot (a register
//   array indexed by t mod m would spill to local memory). Where it lives
//   is the plan's choice, by m and the device's opt-in limit: in shared
//   memory after the tiles as [m][block] floats, opted in past 48 KB, or
//   past the opt-in limit in a [m][N] device buffer the wrapper allocates
//   (coalesced like y);
// * threads past N stay for the copies and barriers and compute nothing.
//
// Rounding: the additions and products go through __fmul_rn / __fadd_rn so
// that nvcc cannot contract them into FMAs; with IEEE division (no
// --use_fast_math; FastDiv gives the same quotients) every step then rounds
// exactly as the plain PyTorch version does, operation for operation. Only
// where y sits, when it is read and how the divisions are scheduled changed
// from the one-load-per-step kernel before this design: the outputs are the
// same bits.
//
// bf16 y (the bf16 policy's observation stream; the reference kernel widens
// each loaded row, hw_scan.py:60-63): the kernel is templated on y's element
// type. The tiles stage bf16 rows (half the bytes; 16-byte copies take 8
// series where N is a multiple of 8, else each thread loads its own 2-byte
// element), each y_t is widened to float as the walk reads it, and the
// ring, levels and seas stay float. Widening is exact, so the outputs are
// the plain version's on the same bf16 y (torch promotes bf16 x fp32 to
// fp32 the same way), bit for bit. The bytes fall to 2N(T) + 4N(2T + 2m +
// 2): 31.7 MB at the forecast's shape, 0.0094 ms at the HBM rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hw_scan.cuh"

namespace {

using repro::SCAN_PIPE;

// U steps of the recurrence from `level`, with the y_t of each and the s_t
// of the first F (F = 0: of all): writes each step's l_t and s_{t+m}, and
// the s_t of steps k >= F, which step k - F wrote (F = m). The operations
// and their order are the plain version's; Div is the division
// (repro::FastDiv, which checks each operand, or IeeeDiv).
template <int U, int F, class Div>
__device__ __forceinline__ void hw_steps(const float (&y)[U], float (&s)[U], float level,
                                         float a, float g, float one_minus_a, float one_minus_g,
                                         float (&l_out)[U], float (&s_new)[U], Div& div) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
        if (F > 0 && k >= F) s[k] = s_new[k - F];
        level = __fadd_rn(div(__fmul_rn(a, y[k]), s[k]), __fmul_rn(one_minus_a, level));
        l_out[k] = level;
        s_new[k] = __fadd_rn(div(__fmul_rn(g, y[k]), level), __fmul_rn(one_minus_g, s[k]));
    }
}

template <bool GLOBAL_RING, int COPY, class T>
__global__ void hw_scan_kernel(const T* __restrict__ y,
                               const float* __restrict__ alpha,
                               const float* __restrict__ gamma,
                               const float* __restrict__ init_seas,
                               float* __restrict__ levels,
                               float* __restrict__ seas,
                               float* __restrict__ ring_buf,
                               int t_len, int n, int m, int tile) {
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    T* smem = reinterpret_cast<T*>(smem_bytes);     // [stages][tile][bs] of y, then the ring
    const int bs = blockDim.x;
    const long ln = n;
    const long col0 = static_cast<long>(blockIdx.x) * bs;
    const long col = col0 + threadIdx.x;
    const bool live = col < n;
    const int tiles = (t_len + tile - 1) / tile;
    const int tile_elems = tile * bs;
    const repro::Stager copier = repro::Stager::make<COPY, T>();
    const auto stage = [&](int j) {
        const int t0 = j * tile;
        repro::stage_rows<COPY>(copier, smem + (j % SCAN_PIPE) * tile_elems, y, t0,
                                min(tile, t_len - t0), n, col0);
    };
    for (int j = 0; j < SCAN_PIPE - 1; ++j) {
        if (j < tiles) stage(j);
        __pipeline_commit();
    }

    // slot k of this series' ring is ring[k * bd]: a shared-memory column
    // after the tile buffers, or a column of the [m][N] device buffer
    const int stages = min(SCAN_PIPE, tiles);
    float* ring = GLOBAL_RING ? ring_buf + col
                              : reinterpret_cast<float*>(smem + stages * tile_elems) + threadIdx.x;
    const long bd = GLOBAL_RING ? ln : static_cast<long>(bs);
    float a = 0.0f, g = 0.0f, one_minus_a = 0.0f, one_minus_g = 0.0f, level = 0.0f;
    if (live) {
        a = alpha[col];
        g = gamma[col];
        one_minus_a = __fadd_rn(1.0f, -a);
        one_minus_g = __fadd_rn(1.0f, -g);
        for (int k = 0; k < m; ++k) ring[k * bd] = init_seas[k * ln + col];
        level = repro::widen(y[col]) / ring[0];   // primer l_{-1} = y_0 / s_0
    }

    int slot = 0;
    // a group of steps from tile row r (time t): read y_t and the ring
    // slots (repro::Group), run the steps with FastDiv, redo them with IEEE
    // division if an operand was out of its range (hw_scan.cuh), then write
    // the ring (in step order, so a slot keeps its latest value), levels
    // and seas
    const auto walk = [&](auto group, const T* yt, int r, long t) {
        constexpr int U = decltype(group)::U;
        constexpr int F = decltype(group)::F;
        float yv[U], sv[U], lv[U], sn[U];
        int sl[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            sl[k] = slot;
            yv[k] = repro::widen(yt[(r + k) * bs]);
            if (F == 0 || k < F) sv[k] = ring[slot * bd];
            slot = slot + 1 == m ? 0 : slot + 1;
        }
        repro::FastDiv fast;
        hw_steps<U, F>(yv, sv, level, a, g, one_minus_a, one_minus_g, lv, sn, fast);
        if (fast.bad) {
            repro::IeeeDiv ieee;
            hw_steps<U, F>(yv, sv, level, a, g, one_minus_a, one_minus_g, lv, sn, ieee);
        }
        level = lv[U - 1];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            ring[sl[k] * bd] = sn[k];
            levels[(t + k) * ln + col] = lv[k];
            seas[(t + k) * ln + col] = sv[k];
        }
    };
    for (int j = 0; j < tiles; ++j) {
        __pipeline_wait_prior(SCAN_PIPE - 2);   // tile j has landed (this thread's copies)
        __syncthreads();                        // ... everyone's; tile j - 1 is walked
        if (j + SCAN_PIPE - 1 < tiles) stage(j + SCAN_PIPE - 1);
        __pipeline_commit();
        if (!live) continue;
        const T* yt = smem + (j % SCAN_PIPE) * tile_elems + threadIdx.x;
        const int t0 = j * tile;
        const int rows = min(tile, t_len - t0);
        int r = 0;
        repro::by_group(m, [&](auto group) {
            constexpr int U = decltype(group)::U;
            for (; r + U <= rows; r += U) walk(group, yt, r, t0 + r);
        });
        for (; r < rows; ++r) walk(repro::Group<1, 0>{}, yt, r, t0 + r);
    }
    if (!live) return;
    // future factors s_T .. s_{T+m-1} sit in ring slots (T + k) mod m
    for (int k = 0; k < m; ++k) seas[(t_len + k) * ln + col] = ring[((t_len + k) % m) * bd];
}

// one launch; each instantiation keeps its own opt-in table (common.cuh)
template <bool GLOBAL_RING, int COPY, class T>
int launch(const repro::ScanPlan& p, cudaStream_t st, const T* y, const float* alpha,
           const float* gamma, const float* init_seas, float* levels, float* seas, float* ring,
           int t_len, int n, int m) {
    static repro::SmemOptIn opt_in;
    const auto kernel = hw_scan_kernel<GLOBAL_RING, COPY, T>;
    cudaError_t err = opt_in.ensure(reinterpret_cast<const void*>(kernel), p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<p.blocks, p.block, p.smem, st>>>(y, alpha, gamma, init_seas, levels, seas, ring,
                                              t_len, n, m, p.tile);
    return static_cast<int>(cudaGetLastError());
}

// plan: kernels/hw_scan.py:scan_plan's ints (hw_scan.cuh:ScanPlan); ring:
// null unless the plan puts the ring in a [m][n] device buffer
template <class T>
int hw_scan_entry(const void* y, const void* alpha, const void* gamma, const void* init_seas,
                  void* levels, void* seas, void* ring, const int* plan, int plan_len, int t_len,
                  int n, int m, void* stream) {
    constexpr int ELEM = sizeof(T);
    repro::ScanPlan p;
    const void* staged[] = {y};
    cudaError_t err =
        repro::read_scan_plan(plan, plan_len, n, t_len, m, 1, ring, staged, 1, &p, ELEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto go = [&](auto run) {
        return run(p, static_cast<cudaStream_t>(stream), static_cast<const T*>(y),
                   static_cast<const float*>(alpha), static_cast<const float*>(gamma),
                   static_cast<const float*>(init_seas), static_cast<float*>(levels),
                   static_cast<float*>(seas), static_cast<float*>(ring), t_len, n, m);
    };
    const bool global_ring = p.ring == repro::RING_GLOBAL;
    if (p.copy == 16)
        return global_ring ? go(launch<true, 16, T>) : go(launch<false, 16, T>);
    return global_ring ? go(launch<true, ELEM, T>) : go(launch<false, ELEM, T>);
}

}  // namespace

extern "C" int hw_scan_f32(const void* y, const void* alpha, const void* gamma,
                           const void* init_seas, void* levels, void* seas, void* ring,
                           const int* plan, int plan_len, int t_len, int n, int m,
                           void* stream) {
    return hw_scan_entry<float>(y, alpha, gamma, init_seas, levels, seas, ring, plan, plan_len,
                                t_len, n, m, stream);
}

// y in bf16; alpha, gamma, init_seas and the outputs float, as above
extern "C" int hw_scan_bf16(const void* y, const void* alpha, const void* gamma,
                            const void* init_seas, void* levels, void* seas, void* ring,
                            const int* plan, int plan_len, int t_len, int n, int m,
                            void* stream) {
    return hw_scan_entry<__nv_bfloat16>(y, alpha, gamma, init_seas, levels, seas, ring, plan,
                                        plan_len, t_len, n, m, stream);
}
