// K3 and K4 in bf16 on the tensor cores: the fused LSTM cell (K3) and the
// same forward that also writes the gate activations (K4), for the bf16
// policy's stream; sm_90a.
//
// Replace the Pallas TPU kernels src/repro/kernels/lstm_cell.py:56
// _lstm_kernel (K3) and :72 _lstm_fwd_kernel (K4), pallas_call at :173, in
// their bf16 contract (:48-87): x, h, c, Wx, Wh and b all bf16;
//
//   gates = x . Wx + h . Wh + b   (B, 4H), gate order i, f, g, o: products of
//                                 bf16 values, float32 sums
//   c'    = sigmoid(f) * c + sigmoid(i) * tanh(g)                  (float32)
//   h'    = sigmoid(o) * tanh(c')                 (float32, from the float c')
//   act   = [sigmoid(i) | sigmoid(f) | tanh(g) | sigmoid(o)]   (K4 only)
//
// h', c' (and act) are rounded to bf16 once, as they are stored. K5
// (lstm_cell.cu) reads act as K4 writes it. Widths past the presets' (where
// kernels/lstm_cell.py:cell_plan takes lstm_cell_wide) run lstm_cell_wide in
// lstm_cell.cu; the fp32 stream runs lstm_cell_smem there.
//
// Bound on the card: the bytes. A row reads x, h and c and writes h' and c',
// 2 (I + 4H) bytes at 2 bytes an element, and K4 adds act's 8H: 400 bytes at
// I = H = 40, 76.8 MB at 192,000 rows, 0.0229 ms at 3.35 TB/s (K4: 0.0413).
// The gate products, 2 (I + H) 4H flops a row (4.9 GFLOP there), take
// 0.005 ms at the tensor cores' 989 TFLOP/s; on the CUDA cores' 67 TFLOP/s,
// where lstm_cell_smem runs them, 0.073 ms. What is left on the CUDA cores
// is the cell update: three sigmoids and two tanh a (row, unit), ten
// ex2/rcp on the MUFU (16 lanes a cycle an SM: ~0.02 ms at 192,000 rows)
// and some 40 other instructions, about as long as the bytes. So the
// design keeps the bytes moving while the update runs:
//
// * The products run on mma.sync m16n8k16 (bf16 in, float32 accumulators),
//   their fragments loaded by ldmatrix. K is laid out as x at k in [0, I),
//   zeros to k_x (I rounded up to 8), h from k_x, zeros to k_pad (a
//   multiple of 16); the zero products add exact zeros.
// * The gate columns are permuted as the weights are staged: 16 columns per
//   quad of 4 units, (i, f) of the four units in the first n-tile and (g, o)
//   in the second, unit u at columns 2u and 2u + 1 of each
//   (kernels/lstm_cell.py:tc_column). An m16n8 accumulator fragment gives
//   lane l rows l/4 and l/4 + 8 and columns 2 (l % 4) and 2 (l % 4) + 1, so
//   a lane holds i, f, g and o of unit 4 q + l % 4 for both its rows: the
//   cell update runs in registers and the (B, 4H) gates never leave them.
//   Units are padded to a multiple of 4 with zero columns.
// * The weights are staged once per block as bf16, [k][permuted column],
//   each row padded by 16 bytes so that ldmatrix.trans reads them without
//   bank conflicts (and the [x | h] rows likewise for ldmatrix): a task
//   loads 4 (or 2, 1) units of each gate and stores paired (i, f), (g, o)
//   words, so a block issues its loads in one round, while the first
//   tile's copies are already in flight. A persistent grid loops over the
//   row tiles, so a block stages the weights once a launch.
// * Row tiles of [x | h] and c are staged by cp.async, double-buffered: the
//   next tile's copies are in flight while this tile's products and update
//   run. Each stream's copies are as wide as its rows and its base allow (a
//   16-, 8- or 4-byte cp.async, or a 2-byte load): an x row is 28 bytes at
//   I = 14, h rows 60 and 100 at H = 30 and 50. c's tile is one contiguous
//   run of the stream, staged whole in 16-byte copies.
// * h', c' and act are staged in shared memory as the outputs' own rows and
//   leave as one contiguous run per tile, in 16-byte stores.
// * A warp takes one m-tile of 16 rows and a slice of at most TC_QMAX quads
//   (64 accumulators); a block takes m_tiles x slices warps. The kernel is
//   instantiated for each count of quads a warp (1 to TC_QMAX), so the
//   update runs straight through every (quad, row) of a lane, interleaved,
//   with only its stores guarded. Small batches take slices of 2 quads and
//   16-row tiles, so they spread over more SMs; large ones 32-row blocks
//   of 4 warps, several an SM (kernels/lstm_cell.py:cell_tc_plan).
//
// Sum order: each gate sums its products k-step by k-step (16 products a
// step) in the tensor cores' order, in float32, then adds the bias. The
// plain version (kernels/ref.py:lstm_cell_ref) sums x . Wx and h . Wh by two
// float32 matmuls, adds them, then adds the bias. Products of bf16 values
// are exact in float32, so only the order of the float32 additions differs,
// and the outputs, rounded to bf16 once, stay within 1 bf16 ulp of the plain
// version (or within atol 1e-5, where an output is so near zero that the
// order's float32 error spans more ulps). There are no atomics, and a gate's
// sum does not depend on the plan: the same bits on every launch, and for a
// row whatever batch it is in. The sigmoid and tanh take ex2.approx and
// rcp.approx (tanh near 0 its odd series): a few float32 ulps, where the
// plain version's torch.sigmoid and torch.tanh are within 2; the outputs
// round that float to bf16, whose ulp is 2^16 float32 ulps.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int TC_QMAX = 8;       // quads of 4 units (16 gate columns) a warp holds, at most
constexpr int TC_MAX_WARPS = 8;  // warps per block, at most
constexpr int TC_LOADS = 4;      // weight tasks (4 loads each) a thread keeps in flight

// the launch plan of the kernel, made by kernels/lstm_cell.py:cell_tc_plan
// and passed as ints in this order
struct TcPlan {
    int m_tiles;   // 16-row m-tiles per row tile: a tile is 16 m_tiles rows
    int slices;    // unit slices per m-tile: a block is m_tiles x slices warps
    int quads;     // quads per slice, at most TC_QMAX (the last slice may hold fewer)
    int k_x;       // k of the first h column: I rounded up to 8
    int k_pad;     // k_x + H rounded up to 16
    int n_pad;     // permuted gate columns: 16 per quad, slices x quads quads
    int copy_w;    // bytes per load of one gate's units in a weight row (2, 4 or 8)
    int copy_x;    // bytes per copy of an x row
    int copy_h;    // bytes per copy of an h row
    int copy_c;    // bytes per copy of c's tile
    int copy_out;  // bytes per store of h', c' and act
    int act;       // 1: K4, which writes act
    int smem;      // dynamic shared memory, bytes
};
constexpr int TC_PLAN_LEN = sizeof(TcPlan) / sizeof(int);

// the shared-memory layout: byte offsets and sizes, from the plan and H
struct TcLayout {
    int tile;       // rows per tile
    int a_stride;   // bytes per staged [x | h] row
    int b_stride;   // bytes per staged k row of the weights
    int bias;       // float biases, (i, f, g, o) of each padded unit
    int a;          // the two [x | h] tiles
    int a_bytes;
    int c;          // the two c tiles
    int c_bytes;
    int out;        // h', then c', then act
    int hc_bytes;   // bytes of h' (and of c') staged
    int total;
};

__host__ __device__ inline TcLayout tc_layout(const TcPlan& p, int hidden) {
    TcLayout l;
    l.tile = 16 * p.m_tiles;
    l.a_stride = 2 * (p.k_pad + TC_PAD);
    l.b_stride = 2 * (p.n_pad + TC_PAD);
    l.bias = p.k_pad * l.b_stride;
    l.a = l.bias + 4 * p.n_pad;
    l.a_bytes = l.tile * l.a_stride;
    l.c = l.a + 2 * l.a_bytes;
    l.c_bytes = (2 * l.tile * hidden + 15) / 16 * 16;
    l.out = l.c + 2 * l.c_bytes;
    l.hc_bytes = l.c_bytes;
    l.total = l.out + 2 * l.hc_bytes + (p.act ? (8 * l.tile * hidden + 15) / 16 * 16 : 0);
    return l;
}

// sigmoid and tanh in float32 from ex2.approx and rcp.approx: within a few
// float32 ulps (__expf's error grows to ~1.2 |v| ulps), and tanh near 0 by
// its odd series, where 1 - 2 / (1 + e^2v) would lose its relative
// precision; errors some 2^15 times finer than the bf16 rounding they feed
__device__ __forceinline__ float rcp_approx(float d) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
    return r;
}

__device__ __forceinline__ float sigmoidf(float v) { return rcp_approx(1.0f + __expf(-v)); }

__device__ __forceinline__ float tanh_f(float v) {
    const float v2 = v * v;
    const float series =
        v * fmaf(v2, fmaf(v2, fmaf(v2, -17.0f / 315.0f, 2.0f / 15.0f), -1.0f / 3.0f), 1.0f);
    const float far = 1.0f - 2.0f * rcp_approx(1.0f + __expf(2.0f * v));
    return fabsf(v) < 0.0625f ? series : far;
}

// the low (high) bf16 halves of a and b as one word, a's in the low half
__device__ __forceinline__ unsigned pair_lo(unsigned a, unsigned b) {
    return __byte_perm(a, b, 0x5410);
}
__device__ __forceinline__ unsigned pair_hi(unsigned a, unsigned b) {
    return __byte_perm(a, b, 0x7632);
}

// [Wx; Wh] (I + H rows of 4H) into the permuted [k][column] layout, the
// whole k_pad x n_pad region: element (k, q H + j) of gate q, unit j goes to
// row k (of Wx) or k_x + k (of Wh), column 16 (j / 4) + 8 (q / 2) +
// 2 (j % 4) + q % 2, and every other row and column of the region is zero.
// A task is one staged row and P units (P = W / 2): it loads the P units of
// each gate (W bytes a load), pairs (i, f) and (g, o) of each unit into
// words with byte permutes, and stores them as two runs of 2P words (i f i f
// .. | g o g o ..). Each thread keeps TC_LOADS tasks' loads in flight.
template <int W>
__device__ __forceinline__ void stage_weights(unsigned char* bs, int b_stride,
                                              const __nv_bfloat16* wx, const __nv_bfloat16* wh,
                                              int in_size, int hidden, int k_x, int k_pad,
                                              int n_pad) {
    using V = typename Word<W>::type;          // P units of one gate
    constexpr int P = W / 2;                   // units a task
    const int g4 = 4 * hidden;
    const unsigned groups = n_pad / 4 / P;     // tasks a staged row
    const DivBy by(groups);
    const unsigned n = k_pad * groups;
    for (unsigned e0 = threadIdx.x; e0 < n; e0 += TC_LOADS * blockDim.x) {
        V v[TC_LOADS][4];
#pragma unroll
        for (int u = 0; u < TC_LOADS; ++u) {
            const unsigned e = e0 + u * blockDim.x;
            const int ks = static_cast<int>(by.of(e));
            const int j0 = static_cast<int>(e - ks * groups) * P;
            // the row of [Wx; Wh] that staged row ks holds, or -1 for padding
            const int k = ks < in_size ? ks
                                       : (ks >= k_x && ks < k_x + hidden ? ks - k_x + in_size : -1);
            const bool real = e < n && k >= 0 && j0 < hidden;
            const int kr = real ? k : 0;
            const __nv_bfloat16* src = (kr < in_size ? wx + static_cast<size_t>(kr) * g4
                                                     : wh + static_cast<size_t>(kr - in_size) * g4)
                                       + (real ? j0 : 0);
#pragma unroll
            for (int q = 0; q < 4; ++q)
                v[u][q] = real ? __ldg(reinterpret_cast<const V*>(src + q * hidden)) : V{};
        }
#pragma unroll
        for (int u = 0; u < TC_LOADS; ++u) {
            const unsigned e = e0 + u * blockDim.x;
            if (e >= n) break;
            const int ks = static_cast<int>(by.of(e));
            const int j0 = static_cast<int>(e - ks * groups) * P;
            // columns of units j0 .. j0 + P - 1: quad j0 / 4, unit j0 % 4 within it
            unsigned char* row = bs + ks * b_stride + 2 * (16 * (j0 >> 2) + 2 * (j0 & 3));
            if constexpr (P == 1) {
                *reinterpret_cast<unsigned*>(row) =
                    v[u][0] | (static_cast<unsigned>(v[u][1]) << 16);
                *reinterpret_cast<unsigned*>(row + 16) =
                    v[u][2] | (static_cast<unsigned>(v[u][3]) << 16);
            } else if constexpr (P == 2) {
                *reinterpret_cast<uint2*>(row) = make_uint2(pair_lo(v[u][0], v[u][1]),
                                                            pair_hi(v[u][0], v[u][1]));
                *reinterpret_cast<uint2*>(row + 16) = make_uint2(pair_lo(v[u][2], v[u][3]),
                                                                 pair_hi(v[u][2], v[u][3]));
            } else {
                *reinterpret_cast<uint4*>(row) = make_uint4(
                    pair_lo(v[u][0].x, v[u][1].x), pair_hi(v[u][0].x, v[u][1].x),
                    pair_lo(v[u][0].y, v[u][1].y), pair_hi(v[u][0].y, v[u][1].y));
                *reinterpret_cast<uint4*>(row + 16) = make_uint4(
                    pair_lo(v[u][2].x, v[u][3].x), pair_hi(v[u][2].x, v[u][3].x),
                    pair_lo(v[u][2].y, v[u][3].y), pair_hi(v[u][2].y, v[u][3].y));
            }
        }
    }
}

// One launch: QPW is the plan's quads per warp (p.quads).
template <bool WITH_ACT, int QPW>
__global__ void __launch_bounds__(TC_MAX_WARPS * 32, 2)
lstm_cell_tc(const __nv_bfloat16* __restrict__ wx, const __nv_bfloat16* __restrict__ wh,
             const __nv_bfloat16* __restrict__ b, const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ c,
             __nv_bfloat16* __restrict__ h_out, __nv_bfloat16* __restrict__ c_out,
             __nv_bfloat16* __restrict__ act, int rows, int in_size, int hidden, TcPlan p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const TcLayout L = tc_layout(p, hidden);
    const int g4 = 4 * hidden;
    const long n_tiles = (static_cast<long>(rows) + L.tile - 1) / L.tile;

    // zeros in both [x | h] tiles' padding columns, [I, k_x) and
    // [k_x + H, k_pad), which no copy writes (so no barrier before them)
    const int pad_x = p.k_x - in_size, pads = pad_x + p.k_pad - p.k_x - hidden;
    for (int e = threadIdx.x; e < 2 * L.tile * pads; e += blockDim.x) {
        const int r = e / pads, i = e - r * pads;
        const int k = i < pad_x ? in_size + i : p.k_x + hidden + (i - pad_x);
        *reinterpret_cast<unsigned short*>(smem + L.a + r * L.a_stride + 2 * k) = 0;
    }
    const DivBy by_x(2 * in_size / p.copy_x), by_h(2 * hidden / p.copy_h);
    // tile t's [x | h] rows and c into stage s, by cp.async
    const auto stage = [&](long t, int s) {
        const long row0 = t * L.tile;
        const int nr = static_cast<int>(min(static_cast<long>(L.tile), rows - row0));
        unsigned char* a = smem + L.a + s * L.a_bytes;
        stage_rows_by(p.copy_x, a, L.a_stride,
                      reinterpret_cast<const unsigned char*>(x + row0 * in_size), 2 * in_size, nr,
                      by_x);
        stage_rows_by(p.copy_h, a + 2 * p.k_x, L.a_stride,
                      reinterpret_cast<const unsigned char*>(h + row0 * hidden), 2 * hidden, nr,
                      by_h);
        stage_run_by(p.copy_c, smem + L.c + s * L.c_bytes,
                     reinterpret_cast<const unsigned char*>(c + row0 * hidden), 2 * nr * hidden);
    };
    // the first tile's copies fly while the weights are staged
    if (blockIdx.x < n_tiles) stage(blockIdx.x, 0);
    __pipeline_commit();

    // the weights and biases, once per block (zeros past H)
    if (p.copy_w == 8)
        stage_weights<8>(smem, L.b_stride, wx, wh, in_size, hidden, p.k_x, p.k_pad, p.n_pad);
    else if (p.copy_w == 4)
        stage_weights<4>(smem, L.b_stride, wx, wh, in_size, hidden, p.k_x, p.k_pad, p.n_pad);
    else
        stage_weights<2>(smem, L.b_stride, wx, wh, in_size, hidden, p.k_x, p.k_pad, p.n_pad);
    float* bias = reinterpret_cast<float*>(smem + L.bias);
    for (int e = threadIdx.x; e < p.n_pad; e += blockDim.x) {
        const int j = e >> 2, q = e & 3;
        bias[e] = j < hidden ? repro::widen(b[q * hidden + j]) : 0.0f;
    }

    // this warp: m-tile mi of the tile, quads quad0 .. quad0 + QPW - 1 (those
    // past H have zero weights)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int mi = warp / p.slices;
    const int quad0 = (warp - mi * p.slices) * QPW;
    const int k_steps = p.k_pad / 16;
    const int g = lane >> 2, tq = lane & 3;    // the accumulator fragment's row and column pair
    // ldmatrix.trans row addresses: matrix lane / 8 is (k 0-7 | 8-15) x
    // (n-tile (i, f) | (g, o)) of a quad
    const unsigned b_addr = smem_addr(smem) + ((lane & 7) + ((lane >> 3) & 1) * 8) * L.b_stride +
                            (quad0 * 16 + (lane >> 4) * 8) * 2;
    const float4* bias4 = reinterpret_cast<const float4*>(bias);
    __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + L.out);
    __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem + L.out + L.hc_bytes);
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem + L.out + 2 * L.hc_bytes);

    int s = 0;
    for (long t = blockIdx.x; t < n_tiles; t += gridDim.x, s ^= 1) {
        if (t + gridDim.x < n_tiles) stage(t + gridDim.x, s ^ 1);
        __pipeline_commit();
        __pipeline_wait_prior(1);              // this tile's copies (this thread's) have landed
        __syncthreads();                       // ... every thread's, and the weights

        const long row0 = t * L.tile;
        const int nr = static_cast<int>(min(static_cast<long>(L.tile), rows - row0));
        if (mi * 16 < nr) {
            float acc[QPW][2][4];
#pragma unroll
            for (int q = 0; q < QPW; ++q)
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[q][n][i] = 0.0f;
            // ldmatrix row addresses: lanes 0-15 rows 0-15 at k 0, lanes 16-31 at k 8
            const unsigned a_addr = smem_addr(smem + L.a + s * L.a_bytes) +
                                    (mi * 16 + (lane & 15)) * L.a_stride + (lane >> 4) * 16;
            for (int ks = 0; ks < k_steps; ++ks) {
                unsigned af[4];
                ldmatrix_x4(af, a_addr + ks * 32);
#pragma unroll
                for (int q = 0; q < QPW; ++q) {
                    unsigned bf[4];
                    ldmatrix_x4_trans(bf, b_addr + ks * 16 * L.b_stride + q * 32);
                    mma_bf16(acc[q][0], af, bf[0], bf[1]);
                    mma_bf16(acc[q][1], af, bf[2], bf[3]);
                }
            }

            // the cell update of unit j for rows g and g + 8 of the m-tile,
            // every (quad, row) straight through; only the stores are guarded
            const __nv_bfloat16* c_in =
                reinterpret_cast<const __nv_bfloat16*>(smem + L.c + s * L.c_bytes);
#pragma unroll
            for (int q = 0; q < QPW; ++q) {
                const int j = 4 * (quad0 + q) + tq;
                const float4 bq = bias4[j];
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int r = mi * 16 + g + 8 * half;
                    const bool keep = r < nr && j < hidden;
                    const int idx = keep ? r * hidden + j : 0;
                    const float si = sigmoidf(acc[q][0][2 * half] + bq.x);
                    const float sf = sigmoidf(acc[q][0][2 * half + 1] + bq.y);
                    const float tg = tanh_f(acc[q][1][2 * half] + bq.z);
                    const float so = sigmoidf(acc[q][1][2 * half + 1] + bq.w);
                    const float c_new = sf * repro::widen(c_in[idx]) + si * tg;
                    const float h_new = so * tanh_f(c_new);
                    if (keep) {
                        cs[idx] = repro::narrow<__nv_bfloat16>(c_new);
                        hs[idx] = repro::narrow<__nv_bfloat16>(h_new);
                        if (WITH_ACT) {
                            __nv_bfloat16* ar = as + r * g4 + j;
                            ar[0] = repro::narrow<__nv_bfloat16>(si);
                            ar[hidden] = repro::narrow<__nv_bfloat16>(sf);
                            ar[2 * hidden] = repro::narrow<__nv_bfloat16>(tg);
                            ar[3 * hidden] = repro::narrow<__nv_bfloat16>(so);
                        }
                    }
                }
            }
        }
        __syncthreads();                       // the tile's outputs are staged, its inputs read

        // the tile's rows of h', c' (and act) are contiguous runs of the outputs
        const int hc = 2 * nr * hidden;
        store_run_by(p.copy_out, h_out + row0 * hidden, reinterpret_cast<unsigned char*>(hs), hc);
        store_run_by(p.copy_out, c_out + row0 * hidden, reinterpret_cast<unsigned char*>(cs), hc);
        if (WITH_ACT)
            store_run_by(p.copy_out, act + row0 * g4, reinterpret_cast<unsigned char*>(as), 4 * hc);
    }
}

// whether the kernel takes a plan for this shape and these tensors: its
// geometry, a copy width per stream that the stream's rows (or runs) and
// base allow, and the shared memory of the layout the source computes
bool tc_plan_fits(const TcPlan& p, int in_size, int hidden, bool with_act, const void* wx,
                  const void* wh, const void* x, const void* h, const void* c, const void* h_out,
                  const void* c_out, const void* act) {
    const int hq = (hidden + 3) / 4;
    const auto width = [](int w) { return w == 2 || w == 4 || w == 8 || w == 16; };
    const auto on = [](const void* q, int w) { return reinterpret_cast<uintptr_t>(q) % w == 0; };
    const bool geometry =
        p.m_tiles >= 1 && p.slices >= 1 && p.quads >= 1 && p.quads <= TC_QMAX &&
        p.slices * p.quads >= hq && (p.slices - 1) * p.quads < hq &&
        p.m_tiles * p.slices <= TC_MAX_WARPS && p.k_x == (in_size + 7) / 8 * 8 &&
        p.k_pad == (p.k_x + hidden + 15) / 16 * 16 && p.n_pad == 16 * p.slices * p.quads &&
        p.act == (with_act ? 1 : 0);
    const bool copies =
        (p.copy_w == 2 || p.copy_w == 4 || p.copy_w == 8) && hidden % (p.copy_w / 2) == 0 &&
        on(wx, p.copy_w) && on(wh, p.copy_w) &&
        width(p.copy_x) && (2 * in_size) % p.copy_x == 0 && on(x, p.copy_x) &&
        width(p.copy_h) && (2 * hidden) % p.copy_h == 0 && on(h, p.copy_h) &&
        width(p.copy_c) && on(c, p.copy_c) && width(p.copy_out) && on(h_out, p.copy_out) &&
        on(c_out, p.copy_out) && (!with_act || on(act, p.copy_out));
    return geometry && copies && p.smem == tc_layout(p, hidden).total;
}

// the instantiation for p.quads (1 .. TC_QMAX), then the launch
template <bool WITH_ACT, int QPW>
int launch_quads(const void* wx, const void* wh, const void* b, const void* x, const void* h,
                 const void* c, void* h_out, void* c_out, void* act, const TcPlan& p, int rows,
                 int in_size, int hidden, void* stream) {
    if constexpr (QPW > 1) {
        if (p.quads < QPW)
            return launch_quads<WITH_ACT, QPW - 1>(wx, wh, b, x, h, c, h_out, c_out, act, p, rows,
                                                   in_size, hidden, stream);
    }
    static repro::SmemOptIn opt_in;            // per device and instantiation (common.cuh)
    const void* kernel = reinterpret_cast<const void*>(lstm_cell_tc<WITH_ACT, QPW>);
    cudaError_t err = opt_in.ensure(kernel, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = 32 * p.m_tiles * p.slices;
    int sms = 0, per_sm = 0;
    err = repro::sm_count(&sms);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    // a persistent grid: as many blocks as fit, never more than there are tiles
    const long tile = 16L * p.m_tiles;
    const long n_tiles = (rows + tile - 1) / tile;
    const unsigned grid = static_cast<unsigned>(std::min(n_tiles, static_cast<long>(per_sm) * sms));
    const auto in = [](const void* q) { return static_cast<const __nv_bfloat16*>(q); };
    const auto out = [](void* q) { return static_cast<__nv_bfloat16*>(q); };
    lstm_cell_tc<WITH_ACT, QPW><<<grid, threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
        in(wx), in(wh), in(b), in(x), in(h), in(c), out(h_out), out(c_out), out(act), rows,
        in_size, hidden, p);
    return static_cast<int>(cudaGetLastError());
}

// plan: TcPlan's TC_PLAN_LEN ints; act: null for K3
template <bool WITH_ACT>
int launch_tc(const void* wx, const void* wh, const void* b, const void* x, const void* h,
              const void* c, void* h_out, void* c_out, void* act, const void* plan, int plan_len,
              int rows, int in_size, int hidden, void* stream) {
    if (plan == nullptr || plan_len != TC_PLAN_LEN || rows < 1 || in_size < 1 || hidden < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int* v = static_cast<const int*>(plan);
    const TcPlan p{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11], v[12]};
    if (!tc_plan_fits(p, in_size, hidden, WITH_ACT, wx, wh, x, h, c, h_out, c_out, act))
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_quads<WITH_ACT, TC_QMAX>(wx, wh, b, x, h, c, h_out, c_out, act, p, rows,
                                           in_size, hidden, stream);
}

}  // namespace

// K3 in bf16: x, h, c, wx, wh, b, h_out and c_out all bf16
extern "C" int lstm_cell_bf16(const void* wx, const void* wh, const void* b, const void* x,
                              const void* h, const void* c, void* h_out, void* c_out,
                              const void* plan, int plan_len, int rows, int in_size, int hidden,
                              void* stream) {
    return launch_tc<false>(wx, wh, b, x, h, c, h_out, c_out, nullptr, plan, plan_len, rows,
                            in_size, hidden, stream);
}

// K4 in bf16: every input and output, act included, bf16
extern "C" int lstm_cell_fwd_bf16(const void* wx, const void* wh, const void* b, const void* x,
                                  const void* h, const void* c, void* h_out, void* c_out,
                                  void* act, const void* plan, int plan_len, int rows,
                                  int in_size, int hidden, void* stream) {
    return launch_tc<true>(wx, wh, b, x, h, c, h_out, c_out, act, plan, plan_len, rows, in_size,
                           hidden, stream);
}

// The constants that kernels/lstm_cell.py sizes this kernel's launches by,
// and the plan's length, in the order of lstm_cell.py:_TC_CONSTANTS; writes
// up to n of them to out and returns how many there are.
extern "C" int repro_lstm_cell_tc_constants(int* out, int n) {
    const int values[] = {TC_QMAX, TC_PAD, TC_MAX_WARPS, TC_PLAN_LEN};
    const int count = static_cast<int>(sizeof(values) / sizeof(int));
    for (int i = 0; i < count && i < n; ++i) out[i] = values[i];
    return count;
}
