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

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "hw_scan.cuh"

namespace {

using repro::SCAN_PIPE;

constexpr int STREAMS = 5;   // y, levels (one row back), seas, dlev, dseas

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

template <bool GLOBAL_RING, int COPY>
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
                                   int t_len, int n, int m, int tile) {
    // [stages][STREAMS][tile][bs], then the ring
    extern __shared__ __align__(16) float smem[];
    const int bs = blockDim.x;
    const long ln = n;
    const long col0 = static_cast<long>(blockIdx.x) * bs;
    const long col = col0 + threadIdx.x;
    const bool live = col < n;
    const int tiles = (t_len + tile - 1) / tile;
    const int tile_floats = tile * bs;
    const repro::Stager copier = repro::Stager::make<COPY>();
    const int stage_floats = STREAMS * tile_floats;
    // the j-th tile walked is time tile tiles - 1 - j: rows [t0, t0 + rows)
    const auto stage = [&](int j) {
        const int t0 = (tiles - 1 - j) * tile;
        const int rows = min(tile, t_len - t0);
        float* buf = smem + (j % SCAN_PIPE) * stage_floats;
        const auto copy = [&](int k, const float* src, long row0, int n_rows, int skip) {
            repro::stage_rows<COPY>(copier, buf + k * tile_floats + skip, src, row0, n_rows, n,
                                    col0);
        };
        copy(0, y, t0, rows, 0);
        if (t0 > 0) copy(1, levels, t0 - 1, rows, 0);
        else copy(1, levels, 0, rows - 1, bs);      // row -1 is the primer, never read
        copy(2, seas, t0, rows, 0);
        copy(3, dlev, t0, rows, 0);
        copy(4, dseas, t0, rows, 0);
    };
    for (int j = 0; j < SCAN_PIPE - 1; ++j) {
        if (j < tiles) stage(j);
        __pipeline_commit();
    }

    // slot k of this series' ring is ring[k * bd] (as in K1)
    const int stages = min(SCAN_PIPE, tiles);
    float* ring = GLOBAL_RING ? ring_buf + col : smem + stages * stage_floats + threadIdx.x;
    const long bd = GLOBAL_RING ? ln : static_cast<long>(bs);
    Params p{};
    State st{0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
        p.a = alpha[col];
        p.g = gamma[col];
        p.one_minus_a = __fadd_rn(1.0f, -p.a);
        p.one_minus_g = __fadd_rn(1.0f, -p.g);
        p.s00 = seas[col];
        p.y0 = y[col];
        st.l_t = levels[(t_len - 1) * ln + col];
        for (int k = 0; k < m; ++k) ring[((t_len + k) % m) * bd] = dseas[(t_len + k) * ln + col];
    }

    int slot = (t_len - 1) % m;
    // a group of reverse steps from tile row r (time t) down: read their
    // tile rows and sigma slots (repro::Group; slots written at t + m or
    // seeded), run them with FastDiv, redo them with IEEE division if an
    // operand was out of its range (hw_scan.cuh), then write the ring (in
    // step order, so a slot keeps its latest value) and dy
    const auto walk = [&](auto group, auto at_zero, const float* buf, int r, long t) {
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
            in[k] = In{buf[e], buf[tile_floats + e], buf[2 * tile_floats + e],
                       buf[3 * tile_floats + e], buf[4 * tile_floats + e],
                       F == 0 || k < F ? ring[slot * bd] : 0.0f};
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
            dy[(t - k) * ln + col] = dy_v[k];
        }
    };
    using One = repro::Group<1, 0>;
    for (int j = 0; j < tiles; ++j) {
        __pipeline_wait_prior(SCAN_PIPE - 2);   // tile j has landed (this thread's copies)
        __syncthreads();                        // ... everyone's; tile j - 1 is walked
        if (j + SCAN_PIPE - 1 < tiles) stage(j + SCAN_PIPE - 1);
        __pipeline_commit();
        if (!live) continue;
        const float* buf = smem + (j % SCAN_PIPE) * stage_floats + threadIdx.x;
        const int t0 = (tiles - 1 - j) * tile;
        int r = min(tile, t_len - t0) - 1;
        const int last = t0 == 0 ? 1 : 0;       // t = 0 takes the primer's terms, alone
        repro::by_group(m, [&](auto group) {
            constexpr int U = decltype(group)::U;
            for (; r - U + 1 >= last; r -= U) walk(group, std::false_type{}, buf, r, t0 + r);
        });
        for (; r >= last; --r) walk(One{}, std::false_type{}, buf, r, t0 + r);
        if (r == 0) walk(One{}, std::true_type{}, buf, 0, 0);
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
template <bool GLOBAL_RING, int COPY>
int launch(const repro::ScanPlan& p, cudaStream_t st, const float* y, const float* alpha,
           const float* gamma, const float* levels, const float* seas, const float* dlev,
           const float* dseas, float* dy, float* dalpha, float* dgamma, float* dinit,
           float* ring, int t_len, int n, int m) {
    static repro::SmemOptIn opt_in;
    const auto kernel = hw_scan_bwd_kernel<GLOBAL_RING, COPY>;
    cudaError_t err = opt_in.ensure(reinterpret_cast<const void*>(kernel), p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<p.blocks, p.block, p.smem, st>>>(y, alpha, gamma, levels, seas, dlev, dseas, dy,
                                              dalpha, dgamma, dinit, ring, t_len, n, m, p.tile);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plan and ring: as in hw_scan_f32 (hw_scan.cuh:ScanPlan, five streams)
extern "C" int hw_scan_bwd_f32(const void* y, const void* alpha, const void* gamma,
                               const void* levels, const void* seas,
                               const void* dlev, const void* dseas,
                               void* dy, void* dalpha, void* dgamma, void* dinit, void* ring,
                               const int* plan, int plan_len, int t_len, int n, int m,
                               void* stream) {
    repro::ScanPlan p;
    const void* staged[] = {y, levels, seas, dlev, dseas};
    cudaError_t err = repro::read_scan_plan(plan, plan_len, n, t_len, m, STREAMS, ring, staged,
                                            STREAMS, &p);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto f = [](const void* q) { return static_cast<const float*>(q); };
    const auto w = [](void* q) { return static_cast<float*>(q); };
    const auto go = [&](auto run) {
        return run(p, static_cast<cudaStream_t>(stream), f(y), f(alpha), f(gamma), f(levels),
                   f(seas), f(dlev), f(dseas), w(dy), w(dalpha), w(dgamma), w(dinit), w(ring),
                   t_len, n, m);
    };
    const bool global_ring = p.ring == repro::RING_GLOBAL;
    if (p.copy == 16) return global_ring ? go(launch<true, 16>) : go(launch<false, 16>);
    return global_ring ? go(launch<true, 4>) : go(launch<false, 4>);
}
