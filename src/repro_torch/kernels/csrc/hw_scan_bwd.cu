// K2: adjoint of the Holt-Winters smoothing scan (time-reversed), sm_90a; y
// and dy in fp32 or bf16, the state and every other stream in fp32.
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
// Bound on the card: bytes. Each reverse step reads y_t, l_{t-1}, s_t, dl_t,
// ds_t and writes dy_t, a dozen flops and six divisions per series. Only
// seas rows 0..T-1 are read, so the kernel must stream at best
// 4 * N * (6T + 2m + 4) bytes: y, levels, dlev, seas, dy (T rows each),
// dseas (T+m), dinit (m), alpha, gamma, dalpha, dgamma (1 each). At the
// train batch (N = 256, T = 72) that is 0.45 MB, under a microsecond: what
// is left is a 72-step chain per series, so the design keeps memory out of
// that chain, shortens it and spreads the series:
// * one thread per series walks t = T-1 .. 0 with lam, da, dg in registers,
//   in the plain version's order (dalpha and dgamma summed in reverse time);
// * a block of `block` series (32, one warp: 8 blocks at N = 256, 64 at
//   N = 2,048, each on its own SM) stages the five input streams (y,
//   levels, seas, dlev, dseas) as `tile` x block tiles in shared memory by
//   cp.async, taken from the end of the series backwards through a pipeline
//   of up to SCAN_PIPE = 3 stages (hw_scan.cuh). The plan
//   (kernels/hw_scan.py:scan_plan) takes the longest tile, up to 128 rows,
//   with which every block is resident: at the train batches one 128-row
//   tile holds all 72 steps (80 KB, one load of every stream per block).
//   16-byte copies where rows are 16-byte aligned, else 4 bytes per series
//   and row;
// * the levels tile is staged one row back (rows t0-1 .. t0+tile-2), so
//   l_{t-1} comes from the tile and l_t is the previous step's l_{t-1},
//   kept in a register: one read of the levels stream, not two;
// * the walk takes groups of steps as K1 does (repro::by_group: 8 at
//   m = 4 and m >= 8, 4 at m = 1 and 5..7, carrying in registers the
//   sig_{t+m} a step hands a later one) and runs each as one straight
//   block, dividing by repro::FastDiv: IEEE division's fast path without
//   its per-division branch, so the six divisions of a step, four of them
//   off the lam chain, overlap across the group. An operand outside
//   FastDiv's range sends the group back through IEEE division. The step
//   t = 0 (the primer level's terms) runs alone;
// * the m-slot sigma ring, one column per thread (a register array indexed
//   by t mod m would spill), placed as K1 places its ring: shared memory
//   after the tiles as [m][block] floats, opted in past 48 KB, or past the
//   opt-in limit a [m][N] device buffer;
// * dy rows are stored straight from the thread, coalesced across the warp;
//   threads past N stay for the copies and barriers and compute nothing.
//
// Rounding: every product and sum goes through __fmul_rn / __fadd_rn in the
// plain version's order (kernels/ref.py:hw_scan_bwd_ref), so nvcc cannot
// contract them into FMAs; with IEEE division (FastDiv gives the same
// quotients) the kernel rounds as the plain version does, operation for
// operation, and as the one-load-per-step kernel before this design did.
//
// bf16 y (the bf16 policy's observation stream; the reference kernel widens
// each y row and emits dy in y's dtype, hw_scan.py:195-197 and :216): the
// kernel is templated on y's element type, as K1 is. The y tile is staged
// at half width (16-byte copies of 8 series where N is a multiple of 8,
// else each thread loads its own 2-byte element; the four float streams
// keep their own copy width, 16 bytes where N is a multiple of 4), each
// y_t is widened to float as the walk reads it, and dy is rounded once as
// it is stored (__float2bfloat16_rn). Levels, seas, dlev, dseas, the ring,
// dalpha, dgamma and d init_seas stay float, and the walk's arithmetic and
// order do not change: the outputs are the plain version's on the same
// bf16 y, bit for bit (torch promotes bf16 x fp32 to fp32 the same way, and
// rounds the float dy to bf16 once). The bytes fall by 2N(T) (y) and 2N(T)
// (dy): 0.36 MB at the train batch (256, 72, 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "hw_scan.cuh"

namespace {

using repro::SCAN_PIPE;

constexpr int STREAMS = 5;   // y, levels (one row back), seas, dlev, dseas
constexpr int FLOATS = STREAMS - 1;   // the float streams, staged after y

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the walk's state between steps: the cotangents and sums, and l_t
struct State {
    float lam, da, dg, l_t;
};

// what a step reads: y_t, l_{t-1}, s_t, dl_t, ds_t from the tile and
// sig_{t+m} from the ring
struct In {
    float y, l_prev, s, dl, ds, sig;
};

struct Params {
    float a, g, one_minus_a, one_minus_g, s00, y0;
};

// U reverse steps t, t - 1, .. from `st`: writes each step's dy_t and
// sig_t, and the sig_{t+m} of steps k >= F, which step k - F wrote (F = m;
// F = 0: every step read its own). The operations and their order are the
// plain version's; Div is the division (repro::FastDiv, which checks each
// operand, or IeeeDiv). AT_ZERO: the last step is t = 0, with the primer
// level's terms (U = 1 only).
template <int U, int F, bool AT_ZERO, class Div>
__device__ __forceinline__ State bwd_steps(State st, In (&in)[U], const Params& p,
                                           float (&dy)[U], float (&sig_out)[U], Div& div) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
        if (F > 0 && k >= F) in[k].sig = sig_out[k - F];
        const In& v = in[k];
        const float l_prev = AT_ZERO ? div(p.y0, p.s00) : v.l_prev;
        st.lam = sub(add(v.dl, mul(p.one_minus_a, st.lam)),
                     div(mul(mul(v.sig, p.g), v.y), mul(st.l_t, st.l_t)));
        sig_out[k] = sub(add(v.ds, mul(p.one_minus_g, v.sig)),
                         div(mul(mul(st.lam, p.a), v.y), mul(v.s, v.s)));
        float dy_t = add(div(mul(st.lam, p.a), v.s), div(mul(v.sig, p.g), st.l_t));
        if (AT_ZERO) dy_t = add(dy_t, div(mul(p.one_minus_a, st.lam), p.s00));
        dy[k] = dy_t;
        st.da = add(st.da, mul(st.lam, sub(div(v.y, v.s), l_prev)));
        st.dg = add(st.dg, mul(v.sig, sub(div(v.y, st.l_t), v.s)));
        st.l_t = l_prev;
    }
    return st;
}

template <bool GLOBAL_RING, int COPY_Y, int COPY_F, class T>
__global__ void hw_scan_bwd_kernel(const T* __restrict__ y,
                                   const float* __restrict__ alpha,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ levels,
                                   const float* __restrict__ seas,
                                   const float* __restrict__ dlev,
                                   const float* __restrict__ dseas,
                                   T* __restrict__ dy,
                                   float* __restrict__ dalpha,
                                   float* __restrict__ dgamma,
                                   float* __restrict__ dinit,
                                   float* __restrict__ ring_buf,
                                   int t_len, int n, int m, int tile) {
    // [stages][the y tile (tile x bs of T), then the FLOATS float tiles], then the ring
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    const int bs = blockDim.x;
    const long ln = n;
    const long col0 = static_cast<long>(blockIdx.x) * bs;
    const long col = col0 + threadIdx.x;
    const bool live = col < n;
    const int tiles = (t_len + tile - 1) / tile;
    const int tile_elems = tile * bs;
    const long stage_bytes = static_cast<long>(tile_elems) * (sizeof(T) + FLOATS * sizeof(float));
    const auto y_tile = [&](int j) {
        return reinterpret_cast<T*>(smem_bytes + (j % SCAN_PIPE) * stage_bytes);
    };
    const auto f_tiles = [&](int j) {       // levels, seas, dlev, dseas: [FLOATS][tile][bs]
        return reinterpret_cast<float*>(smem_bytes + (j % SCAN_PIPE) * stage_bytes +
                                        tile_elems * sizeof(T));
    };
    const repro::Stager y_copier = repro::Stager::make<COPY_Y, T>();
    const repro::Stager f_copier = repro::Stager::make<COPY_F, float>();
    // the j-th tile walked is time tile tiles - 1 - j: rows [t0, t0 + rows)
    const auto stage = [&](int j) {
        const int t0 = (tiles - 1 - j) * tile;
        const int rows = min(tile, t_len - t0);
        repro::stage_rows<COPY_Y>(y_copier, y_tile(j), y, t0, rows, n, col0);
        float* buf = f_tiles(j);
        const auto copy = [&](int k, const float* src, long row0, int n_rows, int skip) {
            repro::stage_rows<COPY_F>(f_copier, buf + k * tile_elems + skip, src, row0, n_rows,
                                      n, col0);
        };
        if (t0 > 0) copy(0, levels, t0 - 1, rows, 0);
        else copy(0, levels, 0, rows - 1, bs);      // row -1 is the primer, never read
        copy(1, seas, t0, rows, 0);
        copy(2, dlev, t0, rows, 0);
        copy(3, dseas, t0, rows, 0);
    };
    for (int j = 0; j < SCAN_PIPE - 1; ++j) {
        if (j < tiles) stage(j);
        __pipeline_commit();
    }

    // slot k of this series' ring is ring[k * bd] (as in K1)
    const int stages = min(SCAN_PIPE, tiles);
    float* ring = GLOBAL_RING ? ring_buf + col
                              : reinterpret_cast<float*>(smem_bytes + stages * stage_bytes) +
                                    threadIdx.x;
    const long bd = GLOBAL_RING ? ln : static_cast<long>(bs);
    Params p{};
    State st{0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
        p.a = alpha[col];
        p.g = gamma[col];
        p.one_minus_a = __fadd_rn(1.0f, -p.a);
        p.one_minus_g = __fadd_rn(1.0f, -p.g);
        p.s00 = seas[col];
        p.y0 = repro::widen(y[col]);
        st.l_t = levels[(t_len - 1) * ln + col];
        for (int k = 0; k < m; ++k) ring[((t_len + k) % m) * bd] = dseas[(t_len + k) * ln + col];
    }

    int slot = (t_len - 1) % m;
    // a group of reverse steps from tile row r (time t) down: read their
    // tile rows and sigma slots (repro::Group; slots written at t + m or
    // seeded), run them with FastDiv, redo them with IEEE division if an
    // operand was out of its range (hw_scan.cuh), then write the ring (in
    // step order, so a slot keeps its latest value) and dy
    const auto walk = [&](auto group, auto at_zero, const T* yb, const float* fb, int r,
                          long t) {
        constexpr int U = decltype(group)::U;
        constexpr int F = decltype(group)::F;
        constexpr bool AT_ZERO = decltype(at_zero)::value;
        In in[U];
        float dy_v[U], sig_v[U];
        int sl[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const int e = (r - k) * bs;
            sl[k] = slot;
            in[k] = In{repro::widen(yb[e]), fb[e], fb[tile_elems + e], fb[2 * tile_elems + e],
                       fb[3 * tile_elems + e], F == 0 || k < F ? ring[slot * bd] : 0.0f};
            slot = slot == 0 ? m - 1 : slot - 1;
        }
        repro::FastDiv fast;
        State out = bwd_steps<U, F, AT_ZERO>(st, in, p, dy_v, sig_v, fast);
        if (fast.bad) {
            repro::IeeeDiv ieee;
            out = bwd_steps<U, F, AT_ZERO>(st, in, p, dy_v, sig_v, ieee);
        }
        st = out;
#pragma unroll
        for (int k = 0; k < U; ++k) {
            ring[sl[k] * bd] = sig_v[k];
            dy[(t - k) * ln + col] = repro::narrow<T>(dy_v[k]);
        }
    };
    using One = repro::Group<1, 0>;
    for (int j = 0; j < tiles; ++j) {
        __pipeline_wait_prior(SCAN_PIPE - 2);   // tile j has landed (this thread's copies)
        __syncthreads();                        // ... everyone's; tile j - 1 is walked
        if (j + SCAN_PIPE - 1 < tiles) stage(j + SCAN_PIPE - 1);
        __pipeline_commit();
        if (!live) continue;
        const T* yb = y_tile(j) + threadIdx.x;
        const float* fb = f_tiles(j) + threadIdx.x;
        const int t0 = (tiles - 1 - j) * tile;
        int r = min(tile, t_len - t0) - 1;
        const int last = t0 == 0 ? 1 : 0;       // t = 0 takes the primer's terms, alone
        repro::by_group(m, [&](auto group) {
            constexpr int U = decltype(group)::U;
            for (; r - U + 1 >= last; r -= U) walk(group, std::false_type{}, yb, fb, r, t0 + r);
        });
        for (; r >= last; --r) walk(One{}, std::false_type{}, yb, fb, r, t0 + r);
        if (r == 0) walk(One{}, std::true_type{}, yb, fb, 0, 0);
    }
    if (!live) return;
    dalpha[col] = st.da;
    dgamma[col] = st.dg;
    const float corr = mul(mul(p.one_minus_a, st.lam), p.y0) / mul(p.s00, p.s00);
    for (int k = 0; k < m; ++k) {
        const float v = ring[k * bd];
        dinit[k * ln + col] = k == 0 ? sub(v, corr) : v;
    }
}

// one launch; each instantiation keeps its own opt-in table (common.cuh)
template <bool GLOBAL_RING, int COPY_Y, int COPY_F, class T>
int launch(const repro::ScanPlan& p, cudaStream_t st, const T* y, const float* alpha,
           const float* gamma, const float* levels, const float* seas, const float* dlev,
           const float* dseas, T* dy, float* dalpha, float* dgamma, float* dinit,
           float* ring, int t_len, int n, int m) {
    static repro::SmemOptIn opt_in;
    const auto kernel = hw_scan_bwd_kernel<GLOBAL_RING, COPY_Y, COPY_F, T>;
    cudaError_t err = opt_in.ensure(reinterpret_cast<const void*>(kernel), p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<p.blocks, p.block, p.smem, st>>>(y, alpha, gamma, levels, seas, dlev, dseas, dy,
                                              dalpha, dgamma, dinit, ring, t_len, n, m, p.tile);
    return static_cast<int>(cudaGetLastError());
}

// plan and ring: as in hw_scan_f32 (hw_scan.cuh:ScanPlan, five streams, y
// first); T: y's and dy's element type
template <class T>
int hw_scan_bwd_entry(const void* y, const void* alpha, const void* gamma, const void* levels,
                      const void* seas, const void* dlev, const void* dseas, void* dy,
                      void* dalpha, void* dgamma, void* dinit, void* ring, const int* plan,
                      int plan_len, int t_len, int n, int m, void* stream) {
    constexpr int ELEM = sizeof(T);
    repro::ScanPlan p;
    const void* staged[] = {y, levels, seas, dlev, dseas};
    cudaError_t err = repro::read_scan_plan(plan, plan_len, n, t_len, m, STREAMS, ring, staged,
                                            STREAMS, &p, ELEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto f = [](const void* q) { return static_cast<const float*>(q); };
    const auto w = [](void* q) { return static_cast<float*>(q); };
    const auto go = [&](auto run) {
        return run(p, static_cast<cudaStream_t>(stream), static_cast<const T*>(y), f(alpha),
                   f(gamma), f(levels), f(seas), f(dlev), f(dseas), static_cast<T*>(dy),
                   w(dalpha), w(dgamma), w(dinit), w(ring), t_len, n, m);
    };
    const bool global_ring = p.ring == repro::RING_GLOBAL;
    // the copy widths scan_plan gives: y and the float streams both 16 bytes
    // a copy, or y one element a copy and the float streams 16 bytes (a bf16
    // y with N a multiple of 4, not of 8) or 4
    if (p.copy == 16 && p.copy_rest == 16)
        return global_ring ? go(launch<true, 16, 16, T>) : go(launch<false, 16, 16, T>);
    if (p.copy == ELEM && p.copy_rest == 4)
        return global_ring ? go(launch<true, ELEM, 4, T>) : go(launch<false, ELEM, 4, T>);
    if constexpr (ELEM < 4) {
        if (p.copy == ELEM && p.copy_rest == 16)
            return global_ring ? go(launch<true, ELEM, 16, T>) : go(launch<false, ELEM, 16, T>);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int hw_scan_bwd_f32(const void* y, const void* alpha, const void* gamma,
                               const void* levels, const void* seas,
                               const void* dlev, const void* dseas,
                               void* dy, void* dalpha, void* dgamma, void* dinit, void* ring,
                               const int* plan, int plan_len, int t_len, int n, int m,
                               void* stream) {
    return hw_scan_bwd_entry<float>(y, alpha, gamma, levels, seas, dlev, dseas, dy, dalpha,
                                    dgamma, dinit, ring, plan, plan_len, t_len, n, m, stream);
}

// y and dy in bf16; alpha, gamma, levels, seas, dlev, dseas, dalpha, dgamma
// and dinit float, as above
extern "C" int hw_scan_bwd_bf16(const void* y, const void* alpha, const void* gamma,
                                const void* levels, const void* seas,
                                const void* dlev, const void* dseas,
                                void* dy, void* dalpha, void* dgamma, void* dinit, void* ring,
                                const int* plan, int plan_len, int t_len, int n, int m,
                                void* stream) {
    return hw_scan_bwd_entry<__nv_bfloat16>(y, alpha, gamma, levels, seas, dlev, dseas, dy,
                                            dalpha, dgamma, dinit, ring, plan, plan_len, t_len,
                                            n, m, stream);
}
