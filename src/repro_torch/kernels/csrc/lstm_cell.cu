// K3: fused LSTM cell (inference forward), K4: the same forward that also
// writes the gate activations, and K5: its backward; sm_90a. All three in
// fp32 and bf16; K3 and K4 in bf16 at the presets' widths live in
// lstm_cell_tc.cu, K5 in bf16 there in lstm_cell_bwd_tc.cu.
//
// Replace the Pallas TPU kernels src/repro/kernels/lstm_cell.py:_lstm_kernel
// (K3), _lstm_fwd_kernel (K4) and _lstm_bwd_kernel (K5).
//
//   gates = x . Wx + h . Wh + b          (B, 4H), gate order i, f, g, o
//   c'    = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h'    = sigmoid(o) * tanh(c')
//   act   = [sigmoid(i) | sigmoid(f) | tanh(g) | sigmoid(o)]     (K4 only)
//
// Shapes: wx (I, 4H), wh (H, 4H), b (4H,), x (B, I), h and c (B, H) in,
// h' and c' (B, H) out; all contiguous fp32, in the JAX orientation.
//
// K3/K4 bound on the card: at the ES-RNN widths (I + H <= 100, H <= 50) the
// gate product does 2 * (I + H) * 4H flops per row against 4 * (I + 4H)
// bytes of row traffic (K4: 4H more floats per row), so the kernel is bound
// by the fp32 CUDA-core rate at large B; the (B, 4H) gates are never
// written to device memory (K4 writes their activations, which K5 needs).
//
// Design of K3 (lstm_cell_smem<false, ...>) and K4 (<true, ...>): the
// kernel must be bound by FMAs, not by the loads that feed them.
// * The weights [Wx; Wh], (I + H) x 4H floats (51,200 B at quarterly width,
//   80,000 B at monthly), go into dynamic shared memory once per block,
//   regrouped as one float4 (i, f, g, o) per (k, unit j): one 16-byte read
//   gives a thread the four gate weights of its unit.
// * A tile of TILE rows of [x | h] is staged in shared memory transposed,
//   [k][row], so one float4 read gives a thread 4 rows of one input.
// * Each thread owns unit j of CELL_R rows, 4 CELL_R accumulators. Per k
//   it reads 1 float4 of weights and CELL_R / 4 float4 of inputs for
//   4 CELL_R FMAs (the one-thread-per-(row, unit) kernel it replaces paired
//   every FMA with a load). CELL_R is 8 from three 64-row tiles per SM
//   (25,344 rows on 132 SMs) and 4 below, where more, shorter tiles win.
//   Neighbouring threads take neighbouring j, so the weight reads are
//   conflict-free; the threads of a row group read one input address.
// * A persistent grid (as many blocks as fit on the card, never more than
//   there are tiles) loops over the row tiles, so each block loads the
//   weights once. Below a full tile per SM the tile shrinks (to CELL_R
//   rows at the least), so a small batch spreads over more SMs; every block
//   stages the weights and the input tile with all its threads, several
//   loads in flight each.
// Each gate keeps the sum order of the plain version's x . Wx + h . Wh + b:
// one fmaf chain over the x part, then the h part, then the bias.
// The sigmoid and tanh are the IEEE-accurate expf/tanhf (no fast math).
//
// K4 also writes the four activations of each (row, unit).
//
// Any I and H (the launch plan, kernels/lstm_cell.py:cell_plan, by the
// shape and the device's SM count and opt-in shared memory). Where H > 512
// (a block of all H units would pass 512 threads; 1,024 threads of 86
// registers, lstm_cell_smem's at CELL_R = 8, would not launch), I + H > 128,
// or the weights pass the opt-in limit (from H ~ 78 at I = H), the plan
// takes a second kernel, lstm_cell_wide:
// * unit slices: each block takes 32 units (256 threads: 8 groups of 4
//   rows, the only row count it is built for; 96 registers a thread), and
//   a second grid dimension runs over the slices, so the weights of a wide
//   cell spread over many blocks;
// * k-chunks: a k row of a slice's weights is 512 bytes, so [Wx; Wh] is
//   staged whole up to I + H = 354; above that it is staged in chunks of k
//   rows with the input tile, restaged for every row tile. The accumulators
//   stay in registers from chunk to chunk, so each gate's fmaf chain runs
//   over k in the same order as with one chunk;
// * sums in blocks of 128 k: each gate sums 128 products in one chain,
//   then adds that block's sum to its total. A 2,060-long chain
//   (I = H = 1,030) drifts 2.5e-5 from the exact dot, which is outside the
//   1e-5 the plain version is held to; blocks of 128 cut that about four
//   times. At I + H <= 128 there is one block, and the outputs are those
//   of the single chain.
// Every preset's width (I + H <= 112, H <= 50) runs lstm_cell_smem, at
// 84-86 registers a thread at 8 rows (two blocks per SM). The chunk loop
// and slice offsets of lstm_cell_wide, put into it, cost 104 registers and
// one block per SM, 25-30 % of its time at the forecast's largest shapes,
// so the presets do not take them.
//
// K3 and K4 in bf16 (the bf16 policy; the reference kernel's contract,
// src/repro/kernels/lstm_cell.py:48-87) run on the tensor cores in their own
// kernel, lstm_cell_tc.cu, at every width that lstm_cell_smem takes; its
// note gives their bound and design. Past those widths the bf16 stream runs
// lstm_cell_wide<.., __nv_bfloat16> (entry points lstm_cell_wide_bf16 and
// lstm_cell_fwd_wide_bf16 below): the weights widened to float as they are
// staged, the same layout and sum order as in fp32, h' and c' (and K4's act)
// rounded to bf16 once as they are stored; h' from the float c'.
//
// K5 is described above its kernel, further down.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

constexpr int CELL_PAD = 4;        // floats of padding per staged input row
constexpr int CELL_LOADS = 8;      // global loads a thread keeps in flight while staging
constexpr int CELL_SUM_BLOCK = 128;  // k per block of the blocked gate sums
constexpr int CELL_WIDE_R = 4;     // rows per thread of lstm_cell_wide

// the launch plan of K3/K4, made by kernels/lstm_cell.py:cell_plan and
// passed as ints in this order (the plan's length and the constants that
// both sides use are held equal at load, lstm_cell.py:_kernel_library)
struct CellPlan {
    int cell_r;     // rows per thread (4 or 8; CELL_WIDE_R in lstm_cell_wide)
    int groups;     // row groups that compute; a tile is groups * cell_r rows
    int units;      // hidden units per block (all H, or a slice)
    int slices;     // unit slices (the grid's y)
    int threads;    // threads per block, a multiple of units
    int k_chunk;    // rows of [Wx; Wh] staged at once (I + H: all, once per block)
    int wide;       // lstm_cell_wide: slices, k-chunks or I + H > 128
    int smem;       // dynamic shared memory, bytes
};

// an element of a K3 input read through the read-only cache, as float
template <class T>
__device__ __forceinline__ float ldf(const T* p) { return repro::widen(__ldg(p)); }

template <bool WITH_ACT, int CELL_R, class T>
__global__ void lstm_cell_smem(const T* __restrict__ wx,
                               const T* __restrict__ wh,
                               const T* __restrict__ b,
                               const T* __restrict__ x,
                               const T* __restrict__ h,
                               const T* __restrict__ c,
                               T* __restrict__ h_out,
                               T* __restrict__ c_out,
                               T* __restrict__ act,
                               int rows, int in_size, int hidden, int tile_groups) {
    extern __shared__ float4 smem4[];
    const int g4 = 4 * hidden;
    const int kw = in_size + hidden;
    const int tile = tile_groups * CELL_R;     // rows per tile; all threads stage
    const int ld = tile + CELL_PAD;            // staged row stride, floats
    float4* ws = smem4;                        // [kw][hidden]: (i, f, g, o) of unit j
    float* xs = reinterpret_cast<float*>(smem4 + static_cast<long>(kw) * hidden);  // [kw][ld]

    // the weights, once per block: thread e gathers the four gates of
    // (k, j) = (e / H, e % H), W[k][gate * H + j] (coalesced across j), and
    // stores them as one float4 at ws[e] (conflict-free); each thread has
    // CELL_LOADS such gathers in flight before it stores them
    const int n_w = kw * hidden;
    for (int e0 = threadIdx.x; e0 < n_w; e0 += CELL_LOADS * blockDim.x) {
        float4 w[CELL_LOADS];
#pragma unroll
        for (int u = 0; u < CELL_LOADS; ++u) {
            const int e = e0 + u * blockDim.x;
            if (e < n_w) {
                const int k = e / hidden, j = e - k * hidden;
                const T* src = k < in_size ? wx + static_cast<long>(k) * g4 + j
                                           : wh + static_cast<long>(k - in_size) * g4 + j;
                w[u] = make_float4(ldf(src), ldf(src + hidden), ldf(src + 2 * hidden),
                                   ldf(src + 3 * hidden));
            }
        }
#pragma unroll
        for (int u = 0; u < CELL_LOADS; ++u) {
            const int e = e0 + u * blockDim.x;
            if (e < n_w) ws[e] = w[u];
        }
    }

    const int grp = threadIdx.x / hidden;      // blockDim.x is a multiple of hidden
    const int j = threadIdx.x - grp * hidden;
    const bool computes = grp < tile_groups;
    const float bi = ldf(b + j), bf = ldf(b + hidden + j);
    const float bg = ldf(b + 2 * hidden + j), bo = ldf(b + 3 * hidden + j);
    const long n_tiles = (static_cast<long>(rows) + tile - 1) / tile;

    for (long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const long row0 = t * tile;
        const int nr = static_cast<int>(min(static_cast<long>(tile), rows - row0));
        // this thread's c, loaded now and used after the gate products
        const bool active = computes && grp * CELL_R < nr;
        float c_in[CELL_R];
#pragma unroll
        for (int r = 0; r < CELL_R; ++r) {
            const int lr = grp * CELL_R + r;
            c_in[r] = active && lr < nr ? ldf(c + (row0 + lr) * hidden + j) : 0.0f;
        }
        __syncthreads();                       // weights stored / last tile consumed
        const int n_in = tile * kw;
        for (int e0 = threadIdx.x; e0 < n_in; e0 += CELL_LOADS * blockDim.x) {
            float v[CELL_LOADS];
#pragma unroll
            for (int u = 0; u < CELL_LOADS; ++u) {
                const int e = e0 + u * blockDim.x;
                const int r = e / kw, k = e - r * kw;
                v[u] = 0.0f;
                if (e < n_in && r < nr) {
                    v[u] = k < in_size ? ldf(x + (row0 + r) * in_size + k)
                                       : ldf(h + (row0 + r) * hidden + (k - in_size));
                }
            }
#pragma unroll
            for (int u = 0; u < CELL_LOADS; ++u) {
                const int e = e0 + u * blockDim.x;
                if (e >= n_in) break;
                const int r = e / kw, k = e - r * kw;
                xs[k * ld + r] = v[u];
            }
        }
        __syncthreads();
        if (!active) continue;                 // no rows of this tile for this group

        float acc[CELL_R][4];
#pragma unroll
        for (int r = 0; r < CELL_R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
        const float* xr = xs + grp * CELL_R;
#pragma unroll 2
        for (int k = 0; k < kw; ++k) {
            const float4 w = ws[k * hidden + j];
            float xv[CELL_R];
#pragma unroll
            for (int q = 0; q < CELL_R / 4; ++q) {
                const float4 x4 = *reinterpret_cast<const float4*>(xr + k * ld + 4 * q);
                xv[4 * q] = x4.x;
                xv[4 * q + 1] = x4.y;
                xv[4 * q + 2] = x4.z;
                xv[4 * q + 3] = x4.w;
            }
#pragma unroll
            for (int r = 0; r < CELL_R; ++r) {
                acc[r][0] = fmaf(xv[r], w.x, acc[r][0]);
                acc[r][1] = fmaf(xv[r], w.y, acc[r][1]);
                acc[r][2] = fmaf(xv[r], w.z, acc[r][2]);
                acc[r][3] = fmaf(xv[r], w.w, acc[r][3]);
            }
        }

#pragma unroll
        for (int r = 0; r < CELL_R; ++r) {
            const int lr = grp * CELL_R + r;
            if (lr >= nr) continue;
            const long idx = (row0 + lr) * hidden + j;
            const float si = sigmoidf(acc[r][0] + bi), sf = sigmoidf(acc[r][1] + bf);
            const float tg = tanhf(acc[r][2] + bg), so = sigmoidf(acc[r][3] + bo);
            const float c_new = sf * c_in[r] + si * tg;
            c_out[idx] = repro::narrow<T>(c_new);
            h_out[idx] = repro::narrow<T>(so * tanhf(c_new));
            if (WITH_ACT) {
                T* ar = act + (row0 + lr) * g4 + j;
                ar[0] = repro::narrow<T>(si);
                ar[hidden] = repro::narrow<T>(sf);
                ar[2 * hidden] = repro::narrow<T>(tg);
                ar[3 * hidden] = repro::narrow<T>(so);
            }
        }
    }
}

// lstm_cell_smem for any width: unit slices (the grid's y), k-chunks of the
// weights, and the gate sums in blocks of CELL_SUM_BLOCK k; CELL_WIDE_R rows
// per thread
template <bool WITH_ACT, class T>
__global__ void lstm_cell_wide(const T* __restrict__ wx,
                               const T* __restrict__ wh,
                               const T* __restrict__ b,
                               const T* __restrict__ x,
                               const T* __restrict__ h,
                               const T* __restrict__ c,
                               T* __restrict__ h_out,
                               T* __restrict__ c_out,
                               T* __restrict__ act,
                               int rows, int in_size, int hidden, int tile_groups,
                               int units, int k_chunk) {
    constexpr int CELL_R = CELL_WIDE_R;
    extern __shared__ float4 smem4[];
    const int g4 = 4 * hidden;
    const int kw = in_size + hidden;
    const int tile = tile_groups * CELL_R;     // rows per tile; all threads stage
    const int ld = tile + CELL_PAD;            // staged row stride, floats
    const int j0 = blockIdx.y * units;         // this block's slice of the units
    const int nu = min(units, hidden - j0);
    const bool resident = k_chunk >= kw;       // all weights staged once per block
    float4* ws = smem4;                        // [k_chunk][units]: (i, f, g, o) of unit j
    float* xs = reinterpret_cast<float*>(smem4 + static_cast<long>(k_chunk) * units);  // [k_chunk][ld]

    // weights k0 .. k0 + kc - 1 of the slice: thread e gathers the four gates
    // of (k, j) = (k0 + e / units, j0 + e % units), W[k][gate * H + j]
    // (coalesced across j), and stores them as one float4 at ws[e]
    // (conflict-free); each thread has CELL_LOADS such gathers in flight
    // before it stores them
    const auto stage_weights = [&](int k0, int kc) {
        const int n_w = kc * units;
        for (int e0 = threadIdx.x; e0 < n_w; e0 += CELL_LOADS * blockDim.x) {
            float4 w[CELL_LOADS];
#pragma unroll
            for (int u = 0; u < CELL_LOADS; ++u) {
                const int e = e0 + u * blockDim.x;
                const int kk = e / units, jl = e - kk * units;
                if (e < n_w && jl < nu) {
                    const int k = k0 + kk, j = j0 + jl;
                    const T* src = k < in_size ? wx + static_cast<long>(k) * g4 + j
                                               : wh + static_cast<long>(k - in_size) * g4 + j;
                    w[u] = make_float4(ldf(src), ldf(src + hidden), ldf(src + 2 * hidden),
                                       ldf(src + 3 * hidden));
                } else {
                    w[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                }
            }
#pragma unroll
            for (int u = 0; u < CELL_LOADS; ++u) {
                const int e = e0 + u * blockDim.x;
                if (e < n_w) ws[e] = w[u];
            }
        }
    };
    if (resident) stage_weights(0, kw);

    const int grp = threadIdx.x / units;       // blockDim.x is a multiple of units
    const int jl = threadIdx.x - grp * units;
    const int j = j0 + jl;
    const bool computes = grp < tile_groups && jl < nu;
    const int jb = jl < nu ? j : j0;           // a valid unit for the bias loads
    const float bi = ldf(b + jb), bf = ldf(b + hidden + jb);
    const float bg = ldf(b + 2 * hidden + jb), bo = ldf(b + 3 * hidden + jb);
    const long n_tiles = (static_cast<long>(rows) + tile - 1) / tile;

    for (long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const long row0 = t * tile;
        const int nr = static_cast<int>(min(static_cast<long>(tile), rows - row0));
        // this thread's c, loaded now and used after the gate products
        const bool active = computes && grp * CELL_R < nr;
        float c_in[CELL_R];
#pragma unroll
        for (int r = 0; r < CELL_R; ++r) {
            const int lr = grp * CELL_R + r;
            c_in[r] = active && lr < nr ? ldf(c + (row0 + lr) * hidden + j) : 0.0f;
        }
        float acc[CELL_R][4], tot[CELL_R][4];
#pragma unroll
        for (int r = 0; r < CELL_R; ++r) {
            acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
            tot[r][0] = tot[r][1] = tot[r][2] = tot[r][3] = 0.0f;
        }
        for (int k0 = 0; k0 < kw; k0 += k_chunk) {
            const int kc = min(k_chunk, kw - k0);
            __syncthreads();                   // weights stored / last chunk consumed
            if (!resident) stage_weights(k0, kc);
            const int n_in = tile * kc;
            for (int e0 = threadIdx.x; e0 < n_in; e0 += CELL_LOADS * blockDim.x) {
                float v[CELL_LOADS];
#pragma unroll
                for (int u = 0; u < CELL_LOADS; ++u) {
                    const int e = e0 + u * blockDim.x;
                    const int r = e / kc, k = k0 + e - r * kc;
                    v[u] = 0.0f;
                    if (e < n_in && r < nr) {
                        v[u] = k < in_size ? ldf(x + (row0 + r) * in_size + k)
                                           : ldf(h + (row0 + r) * hidden + (k - in_size));
                    }
                }
#pragma unroll
                for (int u = 0; u < CELL_LOADS; ++u) {
                    const int e = e0 + u * blockDim.x;
                    if (e >= n_in) break;
                    const int r = e / kc, kk = e - r * kc;
                    xs[kk * ld + r] = v[u];
                }
            }
            __syncthreads();
            if (!active) continue;             // no rows of this tile for this group

            const float* xr = xs + grp * CELL_R;
#pragma unroll 2
            for (int kk = 0; kk < kc; ++kk) {
                const float4 w = ws[kk * units + jl];
                float xv[CELL_R];
#pragma unroll
                for (int q = 0; q < CELL_R / 4; ++q) {
                    const float4 x4 = *reinterpret_cast<const float4*>(xr + kk * ld + 4 * q);
                    xv[4 * q] = x4.x;
                    xv[4 * q + 1] = x4.y;
                    xv[4 * q + 2] = x4.z;
                    xv[4 * q + 3] = x4.w;
                }
#pragma unroll
                for (int r = 0; r < CELL_R; ++r) {
                    acc[r][0] = fmaf(xv[r], w.x, acc[r][0]);
                    acc[r][1] = fmaf(xv[r], w.y, acc[r][1]);
                    acc[r][2] = fmaf(xv[r], w.z, acc[r][2]);
                    acc[r][3] = fmaf(xv[r], w.w, acc[r][3]);
                }
                const int k = k0 + kk + 1;     // products summed so far
                if (k % CELL_SUM_BLOCK == 0 || k == kw) {
#pragma unroll
                    for (int r = 0; r < CELL_R; ++r) {
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            tot[r][q] += acc[r][q];
                            acc[r][q] = 0.0f;
                        }
                    }
                }
            }
        }
        if (!active) continue;

#pragma unroll
        for (int r = 0; r < CELL_R; ++r) {
            const int lr = grp * CELL_R + r;
            if (lr >= nr) continue;
            const float* gs = tot[r];
            const long idx = (row0 + lr) * hidden + j;
            const float si = sigmoidf(gs[0] + bi), sf = sigmoidf(gs[1] + bf);
            const float tg = tanhf(gs[2] + bg), so = sigmoidf(gs[3] + bo);
            const float c_new = sf * c_in[r] + si * tg;
            c_out[idx] = repro::narrow<T>(c_new);
            h_out[idx] = repro::narrow<T>(so * tanhf(c_new));
            if (WITH_ACT) {
                T* ar = act + (row0 + lr) * g4 + j;
                ar[0] = repro::narrow<T>(si);
                ar[hidden] = repro::narrow<T>(sf);
                ar[2 * hidden] = repro::narrow<T>(tg);
                ar[3 * hidden] = repro::narrow<T>(so);
            }
        }
    }
}

template <bool WITH_ACT, int CELL_R, bool WIDE, class T>
int launch_cell_tiles(const void* wx, const void* wh, const void* b, const void* x,
                      const void* h, const void* c, void* h_out, void* c_out, void* act,
                      int rows, int in_size, int hidden, const CellPlan& p, cudaStream_t stream) {
    static repro::SmemOptIn opt_in;            // per device (common.cuh)
    const void* kernel;
    if constexpr (WIDE) kernel = reinterpret_cast<const void*>(lstm_cell_wide<WITH_ACT, T>);
    else kernel = reinterpret_cast<const void*>(lstm_cell_smem<WITH_ACT, CELL_R, T>);
    cudaError_t err = opt_in.ensure(kernel, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = repro::sm_count(&sms);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    // a persistent grid: as many blocks of a slice as fit beside the other
    // slices' blocks, never more than there are tiles
    const long tile = static_cast<long>(p.groups) * CELL_R;
    const long n_tiles = (rows + tile - 1) / tile;
    const long fit = std::max(1L, static_cast<long>(per_sm) * sms / p.slices);
    const dim3 grid(static_cast<unsigned>(std::min(n_tiles, fit)), static_cast<unsigned>(p.slices));
    const auto f = [](const void* v) { return static_cast<const T*>(v); };
    if constexpr (WIDE) {
        lstm_cell_wide<WITH_ACT, T><<<grid, p.threads, p.smem, stream>>>(
            f(wx), f(wh), f(b), f(x), f(h), f(c), static_cast<T*>(h_out),
            static_cast<T*>(c_out), static_cast<T*>(act), rows, in_size, hidden,
            p.groups, p.units, p.k_chunk);
    } else {
        lstm_cell_smem<WITH_ACT, CELL_R, T><<<grid, p.threads, p.smem, stream>>>(
            f(wx), f(wh), f(b), f(x), f(h), f(c), static_cast<T*>(h_out),
            static_cast<T*>(c_out), static_cast<T*>(act), rows, in_size, hidden,
            p.groups);
    }
    return static_cast<int>(cudaGetLastError());
}

// whether a K3/K4 plan covers the shape within its threads and shared
// memory, sized here from this file's own constants
bool cell_plan_fits(const CellPlan& p, int in_size, int hidden) {
    const long kw = in_size + hidden;
    const int r = p.wide ? CELL_WIDE_R : p.cell_r;
    const bool shape = p.wide ? p.k_chunk >= 1 && p.k_chunk <= kw
                              : (r == 4 || r == 8) && p.units == hidden && p.slices == 1 &&
                                    p.k_chunk == kw;
    const long need = 4L * p.k_chunk * (4L * p.units + static_cast<long>(p.groups) * r + CELL_PAD);
    return shape && p.units >= 1 && p.groups >= 1 && p.threads <= 1024 &&
           p.threads % p.units == 0 && p.threads / p.units >= p.groups &&
           static_cast<long>(p.units) * p.slices >= hidden && need <= p.smem;
}

// 4 rows per thread up to three 64-row tiles per SM (more blocks, shorter
// chains), 8 above (fewer shared-memory reads per FMA); the sums, and so
// the results, are the same either way. T: the inputs' and outputs' type.
template <bool WITH_ACT, class T = float>
int launch_cell_smem(const void* wx, const void* wh, const void* b, const void* x,
                     const void* h, const void* c, void* h_out, void* c_out, void* act,
                     const void* plan, int plan_len, int rows, int in_size, int hidden,
                     void* stream) {
    if (plan_len != static_cast<int>(sizeof(CellPlan) / sizeof(int)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int* v = static_cast<const int*>(plan);
    const CellPlan p{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
    if (!cell_plan_fits(p, in_size, hidden)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CELL(R, WIDE) \
    launch_cell_tiles<WITH_ACT, R, WIDE, T>(wx, wh, b, x, h, c, h_out, c_out, act, rows, \
                                            in_size, hidden, p, st)
    if (p.wide) return REPRO_CELL(CELL_WIDE_R, true);
    if (p.cell_r == 4) return REPRO_CELL(4, false);
    if (p.cell_r == 8) return REPRO_CELL(8, false);
#undef REPRO_CELL
    return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 stream at the widths past lstm_cell_smem's: a wide plan only
// (every other bf16 width runs lstm_cell_tc.cu).
template <bool WITH_ACT>
int launch_cell_wide_bf16(const void* wx, const void* wh, const void* b, const void* x,
                          const void* h, const void* c, void* h_out, void* c_out, void* act,
                          const void* plan, int plan_len, int rows, int in_size, int hidden,
                          void* stream) {
    if (plan_len != static_cast<int>(sizeof(CellPlan) / sizeof(int)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int* v = static_cast<const int*>(plan);
    const CellPlan p{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
    if (!p.wide || !cell_plan_fits(p, in_size, hidden))
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_cell_tiles<WITH_ACT, CELL_WIDE_R, true, __nv_bfloat16>(
        wx, wh, b, x, h, c, h_out, c_out, act, rows, in_size, hidden, p,
        static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// K5: the cell's backward, (dh, dc) -> dx, dh_prev, dc_prev, dWx, dWh, db.
//
//   tc = tanh(c');  do = dh tc so (1 - so);  dct = dc + dh so (1 - tc^2)
//   df = dct c sf (1 - sf);  di = dct tg si (1 - si);  dg = dct si (1 - tg^2)
//   dgates = [di | df | dg | do]   (B, 4H)
//   dx = dgates . Wx^T;  dh_prev = dgates . Wh^T;  dc_prev = dct sf
//   dWx = x^T . dgates;  dWh = h^T . dgates;  db = sum_B dgates
//
// Bound on the card. Per row the two products do 2 * 4H * (I + H) flops
// each, the gate algebra about 20 per unit; the traffic is the inputs and
// outputs once, 4 * (2 (I + H) 4H + B (2I + 12H)) bytes or so. At the
// train step's (256, 14, 40) that is 8.8 MFLOP and 0.5 MB: 0.13 us of the
// card's fp32 rate, 0.16 us of its memory rate (the bound, 0.000164 ms).
// Neither limits it at 256 rows: the work is a few thousand FMAs per SM,
// less than the latency of the loads that feed them, so what the kernel
// can do about its time is to have few dependent steps per block (one
// round of loads, short FMA chains, one launch) and enough blocks to use
// the SMs (176 blocks at (256, 14, 40)). Its floor is that chain: a
// launch, the loads of the residuals, a barrier, the products, and for
// the weight gradients a partial, a ticket and the chunks' sum, about
// 6-10 us however small the batch. At the largest train shape
// (16,384, 40, 40) the bound is 0.0128 ms (operations) and the FMAs start
// to count; there the row blocks' inner loop issues 5 shared-memory reads
// per 16 FMAs, so it is bound by shared-memory issue, not by the FMAs.
//
// The TPU kernel sums dWx/dWh/db over the batch into one output block that
// every (sequential) grid step revisits. CUDA blocks run concurrently in no
// order; here one launch of 256-thread blocks holds two kinds of block
// (the plan, kernels/lstm_cell.py:bwd_plan, sizes both from the shape;
// the column blocks come first in the grid, as they take longer):
// * row blocks own tiles of tile_rows rows (4 to 16, fewer rows per tile
//   at small batches so there are more tiles) and k-parts of row_k inputs,
//   looping over them (a persistent grid of at most 128 blocks, each
//   stages the weights once where they fit). Per tile they recompute the tile's gate cotangents into
//   shared memory, [unit][gate][row], write dc_prev, and form dx and dh_prev:
//   a thread owns one k and 4 rows, and per unit one float4 read of the
//   staged weights (i, f, g, o of W[k, :]) feeds 16 FMAs with 4 float4
//   reads of cotangents (the same address across the warp). This is K3's
//   register tiling turned around. The sum runs over the units in order,
//   the gates i, f, g, o within each, in blocks of BWD_UNIT_BLOCK units
//   (128 products), each block's sum added to a total: at I = H = 1,030 a
//   4,120-long chain drifts 1.6e-5 from the plain version, outside its
//   1e-5, blocks of 32 units 2.9e-6. Where the weights pass the shared
//   memory budget they are staged in chunks of row_units units; the block
//   boundaries do not move with the chunks.
// * column blocks own a slice of col_units units (4 gate columns each), a
//   k-part of col_k rows of [x | h | 1] (the last is db's) and a chunk of
//   chunk_rows rows. For sub_rows rows at a time they stage those rows of
//   [x | h] in shared memory by asynchronous copies (cp.async: every load
//   in flight at once) while they recompute the slice's cotangents, four
//   (row, unit)s' loads in flight per thread; a thread owns 4 k and one
//   unit (16 accumulators), and per row one float4 of inputs and one
//   float4 of cotangents feed 16 FMAs. Rows are summed in ascending order.
// * chunks: the rows are cut into chunks of 32 (at most 32 chunks, so up
//   to 512 rows each at 16,384 rows), by the row count alone. With one
//   chunk a column block writes the weight gradients; with more it writes
//   its chunk's partial sums to a scratch buffer, and the last column block
//   of its (k-part, slice) to finish -- it learns that from an integer
//   ticket (atomicAdd after a __threadfence()) -- adds the chunks' partials
//   in chunk order (the loads of four chunks in flight before their adds),
//   writes the gradients and sets the ticket back to 0. The wrapper keeps
//   one set of tickets per device and stream, so two launches that run at
//   the same time must not be on one stream's set: a CUDA graph replayed
//   beside eager launches on its capture stream, or twice at once, would
//   share it (a set per launch would cost a memset, a device call, each).
// Determinism: every sum runs in an order fixed by the shape (units in
// order for dx and dh_prev; rows in order within a chunk, chunks in order,
// for the weight gradients), never by the SM count or by which block ends
// first, and no float is summed atomically: two launches on the same
// inputs give bit-identical results.
//
// K5's dx-only launch (lstm_bwd_dx below; kernels/lstm_cell.py:bwd_dx_plan):
// where no weight gradient is asked for -- the esn head's frozen reservoir,
// whose training step passes its weights with no gradient requirement --
// the launch is row blocks alone: dx, dh_prev and dc_prev per row tile, no
// column blocks, no chunk scratch and no tickets. They are bwd_rows on
// bwd_plan's row tiles; a small batch cuts k into more parts for more
// blocks. A thread sums its k over the units in one order whatever the
// parts, so dx, dh_prev and dc_prev are bit-identical to the full launch's.
// Bound on the card: its bytes are the full launch's less x, h and the
// weight gradients (at (256, 14, 40): 0.46 MB, 0.00014 ms); its floor the
// row blocks' chain (a launch, the residuals' loads, a barrier, the
// products), no ticket wait behind it.
// Taking no ticket, it adds no hazard to a CUDA graph replayed beside eager
// launches: two dx-only launches share nothing but their read-only inputs.
//
// K5 in bf16 past the presets' widths (src/repro/kernels/lstm_cell.py:90-138,
// :210-219; the presets' widths run lstm_cell_bwd_tc.cu on the tensor
// cores): every input bf16, the same kernel templated on that type. The weights, the
// residuals (act, c, c', dh, dc) and the [x | h] rows are widened to float
// as they are staged or loaded, so bwd_plan's float layout, the gate
// algebra and every sum order are the fp32 kernel's. The column blocks
// stage bf16 rows by plain loads (a bf16 row of [x | h] is 2 (I + H) bytes,
// 28 at I = 14, which need not be 16-byte aligned, and cp.async has no
// 2-byte copy). The partials, the tickets, the chunk sum and dWx, dWh, db
// stay float: the weight gradients are the float sums over the whole batch,
// which the wrapper's autograd Function rounds to the weight dtype once
// (as the reference's vjp does, :246-249). dx, dh_prev and dc_prev are
// rounded to bf16 once as they are stored.

constexpr int BWD_THREADS = 256;
constexpr int BWD_UNIT_BLOCK = 32;   // units per block of the dx / dh_prev sums

// the launch plan of K5, made by kernels/lstm_cell.py:bwd_plan and passed
// as ints in this order
struct BwdPlan {
    int tile_rows;    // rows per row tile (a multiple of 4)
    int row_k;        // k (inputs of dx | dh_prev) per row block
    int row_kparts;
    int row_units;    // units whose weights and cotangents are staged at once
    int row_blocks;   // row blocks, the first of the grid
    int col_k;        // k per column block (a multiple of 4; k == I + H is db)
    int col_kparts;
    int col_units;    // units per column block
    int slices;       // unit slices of the column blocks
    int chunks;       // row chunks of the weight-gradient sums
    int chunk_rows;
    int sub_rows;     // rows a column block stages at once
    int smem;         // dynamic shared memory, bytes
};

// whether a K5 plan covers the shape within its threads and shared memory,
// sized here from this file's own constants (the layouts of bwd_rows and
// bwd_cols)
bool bwd_plan_fits(const BwdPlan& p, int rows, int in_size, int hidden) {
    const long kw = in_size + hidden;
    const long row_need = p.row_units * (16L * (p.row_k | 1) + 16L * p.tile_rows);
    const long col_need = p.sub_rows * (4L * p.col_k + 16L * p.col_units);
    return p.tile_rows >= 4 && p.tile_rows % 4 == 0 && p.row_k >= 1 &&
           static_cast<long>(p.row_k) * p.row_kparts >= kw &&
           p.row_k * (p.tile_rows / 4) <= BWD_THREADS && p.row_units >= 1 &&
           p.row_blocks >= 1 && p.col_k >= 4 && p.col_k % 4 == 0 &&
           static_cast<long>(p.col_k) * p.col_kparts >= kw + 1 && p.col_units >= 1 &&
           p.col_units * (p.col_k / 4) <= BWD_THREADS &&
           static_cast<long>(p.col_units) * p.slices >= hidden && p.chunks >= 1 &&
           static_cast<long>(p.chunk_rows) * p.chunks >= rows && p.sub_rows >= 1 &&
           std::max(row_need, col_need) <= p.smem;
}

// whether a dx-only plan (row fields, every column field 0)
// covers the shape within its threads and shared memory
bool bwd_dx_plan_fits(const BwdPlan& p, int rows, int in_size, int hidden) {
    const long kw = in_size + hidden;
    const long row_need = p.row_units * (16L * (p.row_k | 1) + 16L * p.tile_rows);
    return p.tile_rows >= 4 && p.tile_rows % 4 == 0 && p.row_k >= 1 &&
           static_cast<long>(p.row_k) * p.row_kparts >= kw &&
           p.row_k * (p.tile_rows / 4) <= BWD_THREADS && p.row_units >= 1 &&
           p.row_blocks >= 1 && p.col_k == 0 && p.col_kparts == 0 && p.col_units == 0 &&
           p.slices == 0 && p.chunks == 0 && p.chunk_rows == 0 && p.sub_rows == 0 &&
           row_need <= p.smem && rows >= 1 && hidden >= 1;
}

constexpr int BWD_CELLS = 4;       // (row, unit) residuals a thread loads at once
constexpr int BWD_SUM_AHEAD = 4;   // chunks whose partials a thread loads at once

// what the backward reads of one (row, unit): the four activations, c, c',
// and the two cotangents
struct CellResidual {
    float si, sf, tg, so, c, c_new, dh, dc;
};

// (widened to float: a bf16 stream's residuals are read at half width and
// computed on exactly as the float they widen to)
template <class T>
__device__ __forceinline__ CellResidual load_residual(const T* __restrict__ act,
                                                      const T* __restrict__ c,
                                                      const T* __restrict__ c_new,
                                                      const T* __restrict__ dh,
                                                      const T* __restrict__ dc,
                                                      long row, int j, int hidden) {
    const long at = row * hidden + j;
    const T* ar = act + row * 4 * hidden + j;
    return CellResidual{ldf(ar), ldf(ar + hidden), ldf(ar + 2 * hidden),
                        ldf(ar + 3 * hidden), ldf(c + at), ldf(c_new + at),
                        ldf(dh + at), ldf(dc + at)};
}

// the pre-activation gate cotangents (i, f, g, o) of one (row, unit), and
// its dc_prev (rounded once to T) into *dc_prev when that is not null
template <class T>
__device__ __forceinline__ float4 gate_cotangents(const CellResidual& v, T* dc_prev) {
    const float tc = tanhf(v.c_new);
    const float dct = v.dc + v.dh * v.so * (1.0f - tc * tc);
    if (dc_prev != nullptr) *dc_prev = repro::narrow<T>(dct * v.sf);
    return make_float4(dct * v.tg * v.si * (1.0f - v.si), dct * v.c * v.sf * (1.0f - v.sf),
                       dct * v.si * (1.0f - v.tg * v.tg), v.dh * tc * v.so * (1.0f - v.so));
}

template <class T>
__device__ __forceinline__ void bwd_rows(const T* __restrict__ wx,
                                         const T* __restrict__ wh,
                                         const T* __restrict__ c,
                                         const T* __restrict__ c_new,
                                         const T* __restrict__ act,
                                         const T* __restrict__ dh,
                                         const T* __restrict__ dc,
                                         T* __restrict__ dx,
                                         T* __restrict__ dh_prev,
                                         T* __restrict__ dc_prev,
                                         int rows, int in_size, int hidden, const BwdPlan& p,
                                         int rb, float4* smem4) {
    const int g4 = 4 * hidden;
    const int kw = in_size + hidden;
    const int tr = p.tile_rows;
    const int krp = p.row_k | 1;               // odd float4 stride: conflict-free stores
    float4* ws = smem4;                        // [row_units][krp]: W[k, (i, f, g, o) of j]
    float* dgs = reinterpret_cast<float*>(smem4 + static_cast<long>(p.row_units) * krp);
    const bool resident = p.row_units >= hidden && p.row_kparts == 1;
    const int kk = threadIdx.x % p.row_k, rq = threadIdx.x / p.row_k;

    // weights of units u0 .. u0 + nu - 1 and inputs k0 .. k0 + nk - 1,
    // gathered as in K3 (coalesced across j) into ws[jl * krp + kk]
    const auto stage_weights = [&](int u0, int nu, int k0, int nk) {
        for (int e = threadIdx.x; e < nu * nk; e += blockDim.x) {
            const int kl = e / nu, jl = e - kl * nu;
            const int k = k0 + kl, j = u0 + jl;
            const T* src = k < in_size ? wx + static_cast<long>(k) * g4 + j
                                       : wh + static_cast<long>(k - in_size) * g4 + j;
            ws[jl * krp + kl] = make_float4(ldf(src), ldf(src + hidden),
                                            ldf(src + 2 * hidden), ldf(src + 3 * hidden));
        }
    };
    if (resident) stage_weights(0, hidden, 0, kw);

    const long tiles = (static_cast<long>(rows) + tr - 1) / tr;
    const long work = tiles * p.row_kparts;
    for (long w = rb; w < work; w += p.row_blocks) {
        const long t = w / p.row_kparts;
        const int q = static_cast<int>(w - t * p.row_kparts);
        const long row0 = t * tr;
        const int nr = static_cast<int>(min(static_cast<long>(tr), rows - row0));
        const int k0 = q * p.row_k, nk = min(p.row_k, kw - k0);
        const bool active = rq < tr / 4 && 4 * rq < nr && kk < nk;
        float tot[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int u0 = 0; u0 < hidden; u0 += p.row_units) {
            const int nu = min(p.row_units, hidden - u0);
            __syncthreads();                   // the last chunk's reads are done
            // the tile's cotangents, [jl][gate][row] (rows past nr are 0);
            // the first k-part also writes dc_prev
            const int n_d = tr * nu;
            for (int e0 = threadIdx.x; e0 < n_d; e0 += BWD_CELLS * blockDim.x) {
                CellResidual v[BWD_CELLS];
#pragma unroll
                for (int u = 0; u < BWD_CELLS; ++u) {
                    const int e = e0 + u * blockDim.x;
                    const int r = e / nu, jl = e - r * nu;
                    if (e < n_d && r < nr)
                        v[u] = load_residual(act, c, c_new, dh, dc, row0 + r, u0 + jl, hidden);
                }
#pragma unroll
                for (int u = 0; u < BWD_CELLS; ++u) {
                    const int e = e0 + u * blockDim.x;
                    if (e >= n_d) break;
                    const int r = e / nu, jl = e - r * nu;
                    float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                    if (r < nr) {
                        T* dcp = q == 0 ? dc_prev + (row0 + r) * hidden + u0 + jl : nullptr;
                        d = gate_cotangents(v[u], dcp);
                    }
                    float* dr = dgs + jl * 4 * tr + r;
                    dr[0] = d.x;
                    dr[tr] = d.y;
                    dr[2 * tr] = d.z;
                    dr[3 * tr] = d.w;
                }
            }
            if (!resident) stage_weights(u0, nu, k0, nk);
            __syncthreads();
            if (!active) continue;
            for (int jl = 0; jl < nu; ++jl) {
                const float4 w4 = ws[jl * krp + kk];
                const float* dr = dgs + jl * 4 * tr + 4 * rq;
                const float4 di = *reinterpret_cast<const float4*>(dr);
                const float4 df = *reinterpret_cast<const float4*>(dr + tr);
                const float4 dg = *reinterpret_cast<const float4*>(dr + 2 * tr);
                const float4 dO = *reinterpret_cast<const float4*>(dr + 3 * tr);
                acc[0] = fmaf(dO.x, w4.w, fmaf(dg.x, w4.z, fmaf(df.x, w4.y, fmaf(di.x, w4.x, acc[0]))));
                acc[1] = fmaf(dO.y, w4.w, fmaf(dg.y, w4.z, fmaf(df.y, w4.y, fmaf(di.y, w4.x, acc[1]))));
                acc[2] = fmaf(dO.z, w4.w, fmaf(dg.z, w4.z, fmaf(df.z, w4.y, fmaf(di.z, w4.x, acc[2]))));
                acc[3] = fmaf(dO.w, w4.w, fmaf(dg.w, w4.z, fmaf(df.w, w4.y, fmaf(di.w, w4.x, acc[3]))));
                const int j = u0 + jl + 1;     // units summed so far
                if (j % BWD_UNIT_BLOCK == 0 || j == hidden) {
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        tot[r] += acc[r];
                        acc[r] = 0.0f;
                    }
                }
            }
        }
        if (!active) continue;
        const int k = k0 + kk;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const long row = row0 + 4 * rq + r;
            if (4 * rq + r >= nr) break;
            if (k < in_size) dx[row * in_size + k] = repro::narrow<T>(tot[r]);
            else dh_prev[row * hidden + (k - in_size)] = repro::narrow<T>(tot[r]);
        }
    }
}

template <class T>
__device__ __forceinline__ void bwd_cols(const T* __restrict__ x,
                                         const T* __restrict__ h,
                                         const T* __restrict__ c,
                                         const T* __restrict__ c_new,
                                         const T* __restrict__ act,
                                         const T* __restrict__ dh,
                                         const T* __restrict__ dc,
                                         float* __restrict__ dwx,
                                         float* __restrict__ dwh,
                                         float* __restrict__ db,
                                         float* __restrict__ partial,
                                         unsigned int* __restrict__ tickets,
                                         int rows, int in_size, int hidden, const BwdPlan& p,
                                         int cb, float4* smem4, int* last) {
    const int g4 = 4 * hidden;
    const int kw = in_size + hidden;
    const int ck = p.col_k;
    const int chunk = cb % p.chunks;
    const int slice_part = cb / p.chunks;
    const int s = slice_part % p.slices, kp = slice_part / p.slices;
    const int k0 = kp * ck, nks = min(ck, kw + 1 - k0);
    const int j0 = s * p.col_units, nu = min(p.col_units, hidden - j0);
    const long rbeg = static_cast<long>(chunk) * p.chunk_rows;
    const long rend = min(static_cast<long>(rows), rbeg + p.chunk_rows);
    float* xs = reinterpret_cast<float*>(smem4);              // [sub_rows][col_k]
    float4* dgc = smem4 + static_cast<long>(p.sub_rows) * ck / 4;  // [sub_rows][col_units]
    const int jl = threadIdx.x % p.col_units, kg = threadIdx.x / p.col_units;
    const bool active = kg < ck / 4 && jl < nu && 4 * kg < nks;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    for (long r0 = rbeg; r0 < rend; r0 += p.sub_rows) {
        const int nrs = static_cast<int>(min(static_cast<long>(p.sub_rows), rend - r0));
        __syncthreads();                       // the last rows' reads are done
        // the rows of [x | h | 1]: float rows by asynchronous copies (all in
        // flight at once, no registers), waited for after the cotangents
        // below; bf16 rows (2-byte elements, which cp.async does not copy,
        // in rows of 2 (I + H) bytes that need not align) widened to float
        // by plain loads, visible after the barrier below
        const int n_x = nrs * ck;
        for (int e = threadIdx.x; e < n_x; e += blockDim.x) {
            const int r = e / ck, k = k0 + e - r * ck;
            const long row = r0 + r;
            if constexpr (sizeof(T) == 4) {
                if (k < in_size) __pipeline_memcpy_async(xs + e, x + row * in_size + k, 4);
                else if (k < kw) __pipeline_memcpy_async(xs + e, h + row * hidden + (k - in_size), 4);
                else xs[e] = k == kw ? 1.0f : 0.0f;   // db's row: fmaf(1, d, a) == a + d
            } else {
                if (k < in_size) xs[e] = ldf(x + row * in_size + k);
                else if (k < kw) xs[e] = ldf(h + row * hidden + (k - in_size));
                else xs[e] = k == kw ? 1.0f : 0.0f;
            }
        }
        __pipeline_commit();
        const int n_d = nrs * nu;
        for (int e0 = threadIdx.x; e0 < n_d; e0 += BWD_CELLS * blockDim.x) {
            CellResidual v[BWD_CELLS];
#pragma unroll
            for (int u = 0; u < BWD_CELLS; ++u) {
                const int e = e0 + u * blockDim.x;
                const int r = e / nu, jj = e - r * nu;
                if (e < n_d) v[u] = load_residual(act, c, c_new, dh, dc, r0 + r, j0 + jj, hidden);
            }
#pragma unroll
            for (int u = 0; u < BWD_CELLS; ++u) {
                const int e = e0 + u * blockDim.x;
                if (e >= n_d) break;
                const int r = e / nu, jj = e - r * nu;
                dgc[r * p.col_units + jj] = gate_cotangents<T>(v[u], nullptr);
            }
        }
        __pipeline_wait_prior(0);
        __syncthreads();
        if (!active) continue;
        const float* xr = xs + 4 * kg;
        const float4* dr = dgc + jl;
        for (int r = 0; r < nrs; ++r) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + r * ck);
            const float4 d = dr[r * p.col_units];
            const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[i][0] = fmaf(xk[i], d.x, acc[i][0]);
                acc[i][1] = fmaf(xk[i], d.y, acc[i][1]);
                acc[i][2] = fmaf(xk[i], d.z, acc[i][2]);
                acc[i][3] = fmaf(xk[i], d.w, acc[i][3]);
            }
        }
    }

    // the gradient of (k, gate column g): dWx, dWh, or db at k == I + H
    const auto out = [&](int k, int g) -> float* {
        if (k < in_size) return dwx + static_cast<long>(k) * g4 + g;
        if (k < kw) return dwh + static_cast<long>(k - in_size) * g4 + g;
        return db + g;
    };
    const int j = j0 + jl;
    if (p.chunks == 1) {
        if (!active) return;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (4 * kg + i >= nks) break;
#pragma unroll
            for (int q = 0; q < 4; ++q) *out(k0 + 4 * kg + i, q * hidden + j) = acc[i][q];
        }
        return;
    }
    const long per_chunk = static_cast<long>(kw + 1) * g4;
    if (active) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (4 * kg + i >= nks) break;
            float* pr = partial + chunk * per_chunk + static_cast<long>(k0 + 4 * kg + i) * g4 + j;
#pragma unroll
            for (int q = 0; q < 4; ++q) pr[q * hidden] = acc[i][q];
        }
    }
    __threadfence();                           // the partials are visible ...
    __syncthreads();
    if (threadIdx.x == 0) {                    // ... before the ticket is taken
        const unsigned int n = atomicAdd(tickets + slice_part, 1u);
        *last = n == static_cast<unsigned int>(p.chunks - 1);
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
    if (active) {
        // the chunks' partials in chunk order; BWD_SUM_AHEAD chunks' loads
        // (16 each) in flight before their adds
        const int ni = min(4, nks - 4 * kg);
        const float* pr = partial + static_cast<long>(k0 + 4 * kg) * g4 + j;
        float sum[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[i][0] = sum[i][1] = sum[i][2] = sum[i][3] = 0.0f;
        for (int ch0 = 0; ch0 < p.chunks; ch0 += BWD_SUM_AHEAD) {
            float v[BWD_SUM_AHEAD][4][4];
#pragma unroll
            for (int a = 0; a < BWD_SUM_AHEAD; ++a) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        v[a][i][q] = ch0 + a < p.chunks && i < ni
                                         ? __ldcg(pr + (ch0 + a) * per_chunk + i * g4 + q * hidden)
                                         : 0.0f;
                    }
                }
            }
#pragma unroll
            for (int a = 0; a < BWD_SUM_AHEAD; ++a) {
                if (ch0 + a >= p.chunks) break;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) sum[i][q] += v[a][i][q];
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (i >= ni) break;
#pragma unroll
            for (int q = 0; q < 4; ++q) *out(k0 + 4 * kg + i, q * hidden + j) = sum[i][q];
        }
    }
    if (threadIdx.x == 0) tickets[slice_part] = 0;   // ready for the next launch
}

template <class T>
__global__ void __launch_bounds__(BWD_THREADS)
lstm_bwd(const T* __restrict__ wx, const T* __restrict__ wh,
         const T* __restrict__ x, const T* __restrict__ h,
         const T* __restrict__ c, const T* __restrict__ c_new,
         const T* __restrict__ act, const T* __restrict__ dh,
         const T* __restrict__ dc, T* __restrict__ dx,
         T* __restrict__ dh_prev, T* __restrict__ dc_prev,
         float* __restrict__ dwx, float* __restrict__ dwh, float* __restrict__ db,
         float* __restrict__ partial, unsigned int* __restrict__ tickets,
         int rows, int in_size, int hidden, BwdPlan p) {
    extern __shared__ float4 smem4[];
    __shared__ int last;
    // the column blocks first: they take longer, and the card starts blocks
    // in about index order
    const int col_blocks = p.col_kparts * p.slices * p.chunks;
    const int b = static_cast<int>(blockIdx.x);
    if (b < col_blocks) {
        bwd_cols(x, h, c, c_new, act, dh, dc, dwx, dwh, db, partial, tickets, rows, in_size,
                 hidden, p, b, smem4, &last);
    } else {
        bwd_rows(wx, wh, c, c_new, act, dh, dc, dx, dh_prev, dc_prev, rows, in_size, hidden, p,
                 b - col_blocks, smem4);
    }
}

// K5's dx-only launch: the row blocks alone (no weight gradient)
template <class T>
__global__ void __launch_bounds__(BWD_THREADS)
lstm_bwd_dx(const T* __restrict__ wx, const T* __restrict__ wh,
            const T* __restrict__ c, const T* __restrict__ c_new,
            const T* __restrict__ act, const T* __restrict__ dh,
            const T* __restrict__ dc, T* __restrict__ dx,
            T* __restrict__ dh_prev, T* __restrict__ dc_prev,
            int rows, int in_size, int hidden, BwdPlan p) {
    extern __shared__ float4 smem4[];
    bwd_rows(wx, wh, c, c_new, act, dh, dc, dx, dh_prev, dc_prev, rows, in_size, hidden, p,
             static_cast<int>(blockIdx.x), smem4);
}

template <class T>
int launch_bwd_dx(const void* wx, const void* wh, const void* c, const void* c_new,
                  const void* act, const void* dh, const void* dc, void* dx, void* dh_prev,
                  void* dc_prev, const void* plan, int plan_len, int rows, int in_size,
                  int hidden, void* stream) {
    if (plan_len != static_cast<int>(sizeof(BwdPlan) / sizeof(int)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int* v = static_cast<const int*>(plan);
    const BwdPlan p{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11], v[12]};
    if (!bwd_dx_plan_fits(p, rows, in_size, hidden)) return static_cast<int>(cudaErrorInvalidValue);
    static repro::SmemOptIn opt_in;            // per device (common.cuh)
    cudaError_t err = opt_in.ensure(reinterpret_cast<const void*>(lstm_bwd_dx<T>), p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto in = [](const void* q) { return static_cast<const T*>(q); };
    lstm_bwd_dx<T><<<static_cast<unsigned>(p.row_blocks), BWD_THREADS, p.smem,
                     static_cast<cudaStream_t>(stream)>>>(
        in(wx), in(wh), in(c), in(c_new), in(act), in(dh), in(dc), static_cast<T*>(dx),
        static_cast<T*>(dh_prev), static_cast<T*>(dc_prev), rows, in_size, hidden, p);
    return static_cast<int>(cudaGetLastError());
}

// plan: BwdPlan's plan_len ints; scratch: (chunks, I + H + 1, 4H) floats
// when chunks > 1; tickets: col_kparts * slices unsigned ints, all 0, which
// the kernel leaves at 0 -- no other launch may use them while this one runs.
// T: the inputs' and dx's, dh_prev's and dc_prev's type; the weight
// gradients are float either way.
template <class T>
int launch_bwd(const void* wx, const void* wh, const void* x, const void* h, const void* c,
               const void* c_new, const void* act, const void* dh, const void* dc, void* dx,
               void* dh_prev, void* dc_prev, void* dwx, void* dwh, void* db, void* scratch,
               void* tickets, const void* plan, int plan_len, int rows, int in_size,
               int hidden, void* stream) {
    if (plan_len != static_cast<int>(sizeof(BwdPlan) / sizeof(int)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int* v = static_cast<const int*>(plan);
    const BwdPlan p{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11], v[12]};
    if (!bwd_plan_fits(p, rows, in_size, hidden) || (p.chunks > 1 && scratch == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    static repro::SmemOptIn opt_in;            // per device (common.cuh)
    cudaError_t err = opt_in.ensure(reinterpret_cast<const void*>(lstm_bwd<T>), p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned grid = static_cast<unsigned>(p.row_blocks + p.col_kparts * p.slices * p.chunks);
    const auto in = [](const void* q) { return static_cast<const T*>(q); };
    lstm_bwd<T><<<grid, BWD_THREADS, p.smem, static_cast<cudaStream_t>(stream)>>>(
        in(wx), in(wh), in(x), in(h), in(c), in(c_new), in(act), in(dh), in(dc),
        static_cast<T*>(dx), static_cast<T*>(dh_prev), static_cast<T*>(dc_prev),
        static_cast<float*>(dwx), static_cast<float*>(dwh), static_cast<float*>(db),
        static_cast<float*>(scratch), static_cast<unsigned int*>(tickets),
        rows, in_size, hidden, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lstm_cell_f32(const void* wx, const void* wh, const void* b,
                             const void* x, const void* h, const void* c,
                             void* h_out, void* c_out, const void* plan, int plan_len,
                             int rows, int in_size, int hidden, void* stream) {
    return launch_cell_smem<false>(wx, wh, b, x, h, c, h_out, c_out, nullptr, plan, plan_len,
                                   rows, in_size, hidden, stream);
}

// K3 in bf16 at the widths past lstm_cell_smem's (a plan with wide = 1):
// x, h, c, wx, wh, b, h_out and c_out all bf16
extern "C" int lstm_cell_wide_bf16(const void* wx, const void* wh, const void* b,
                                   const void* x, const void* h, const void* c,
                                   void* h_out, void* c_out, const void* plan, int plan_len,
                                   int rows, int in_size, int hidden, void* stream) {
    return launch_cell_wide_bf16<false>(wx, wh, b, x, h, c, h_out, c_out, nullptr, plan,
                                        plan_len, rows, in_size, hidden, stream);
}

extern "C" int lstm_cell_fwd_f32(const void* wx, const void* wh, const void* b,
                                 const void* x, const void* h, const void* c,
                                 void* h_out, void* c_out, void* act, const void* plan,
                                 int plan_len, int rows, int in_size, int hidden,
                                 void* stream) {
    return launch_cell_smem<true>(wx, wh, b, x, h, c, h_out, c_out, act, plan, plan_len,
                                  rows, in_size, hidden, stream);
}

// K4 in bf16 at the widths past lstm_cell_smem's: every input and output,
// act included, bf16
extern "C" int lstm_cell_fwd_wide_bf16(const void* wx, const void* wh, const void* b,
                                       const void* x, const void* h, const void* c,
                                       void* h_out, void* c_out, void* act, const void* plan,
                                       int plan_len, int rows, int in_size, int hidden,
                                       void* stream) {
    return launch_cell_wide_bf16<true>(wx, wh, b, x, h, c, h_out, c_out, act, plan, plan_len,
                                       rows, in_size, hidden, stream);
}

extern "C" int lstm_cell_bwd_f32(const void* wx, const void* wh, const void* x,
                                 const void* h, const void* c, const void* c_new,
                                 const void* act, const void* dh, const void* dc,
                                 void* dx, void* dh_prev, void* dc_prev,
                                 void* dwx, void* dwh, void* db, void* scratch,
                                 void* tickets, const void* plan, int plan_len,
                                 int rows, int in_size, int hidden, void* stream) {
    return launch_bwd<float>(wx, wh, x, h, c, c_new, act, dh, dc, dx, dh_prev, dc_prev, dwx,
                             dwh, db, scratch, tickets, plan, plan_len, rows, in_size, hidden,
                             stream);
}

// K5 in bf16 at the widths past the presets' (kernels/lstm_cell.py:bwd_tc_plan
// is None; every other bf16 width runs lstm_cell_bwd_tc.cu): the inputs and
// dx, dh_prev, dc_prev in bf16; dwx, dwh, db (and the scratch) float, the
// sums over the batch before any rounding
extern "C" int lstm_cell_bwd_wide_bf16(const void* wx, const void* wh, const void* x,
                                  const void* h, const void* c, const void* c_new,
                                  const void* act, const void* dh, const void* dc,
                                  void* dx, void* dh_prev, void* dc_prev,
                                  void* dwx, void* dwh, void* db, void* scratch,
                                  void* tickets, const void* plan, int plan_len,
                                  int rows, int in_size, int hidden, void* stream) {
    return launch_bwd<__nv_bfloat16>(wx, wh, x, h, c, c_new, act, dh, dc, dx, dh_prev, dc_prev,
                                     dwx, dwh, db, scratch, tickets, plan, plan_len, rows,
                                     in_size, hidden, stream);
}

// K5's dx-only launch (kernels/lstm_cell.py:bwd_dx_plan): dx, dh_prev and
// dc_prev only, in fp32 and, past the presets' widths, in bf16
extern "C" int lstm_cell_bwd_dx_f32(const void* wx, const void* wh, const void* c,
                                    const void* c_new, const void* act, const void* dh,
                                    const void* dc, void* dx, void* dh_prev, void* dc_prev,
                                    const void* plan, int plan_len, int rows, int in_size,
                                    int hidden, void* stream) {
    return launch_bwd_dx<float>(wx, wh, c, c_new, act, dh, dc, dx, dh_prev, dc_prev, plan,
                                plan_len, rows, in_size, hidden, stream);
}

extern "C" int lstm_cell_bwd_dx_wide_bf16(const void* wx, const void* wh, const void* c,
                                          const void* c_new, const void* act, const void* dh,
                                          const void* dc, void* dx, void* dh_prev,
                                          void* dc_prev, const void* plan, int plan_len,
                                          int rows, int in_size, int hidden, void* stream) {
    return launch_bwd_dx<__nv_bfloat16>(wx, wh, c, c_new, act, dh, dc, dx, dh_prev, dc_prev,
                                        plan, plan_len, rows, in_size, hidden, stream);
}

// The constants that kernels/lstm_cell.py sizes and chooses launches by, and
// the lengths of the two plans, in the order of lstm_cell.py:_C_CONSTANTS;
// writes up to n of them to out and returns how many there are.
extern "C" int repro_lstm_cell_constants(int* out, int n) {
    const int values[] = {CELL_PAD, CELL_SUM_BLOCK, CELL_WIDE_R, BWD_THREADS,
                          static_cast<int>(sizeof(CellPlan) / sizeof(int)),
                          static_cast<int>(sizeof(BwdPlan) / sizeof(int))};
    const int count = static_cast<int>(sizeof(values) / sizeof(int));
    for (int i = 0; i < count && i < n; ++i) out[i] = values[i];
    return count;
}
