// K5 in bf16 on the tensor cores: the LSTM cell's backward for the bf16
// policy's stream; sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lstm_cell.py:90
// _lstm_bwd_kernel (pallas_call at :187) in its bf16 contract: every input
// bf16 (Wx, Wh, x, h, c, c', act, dh, dc);
//
//   tc = tanh(c');  do = dh tc so (1 - so);  dct = dc + dh so (1 - tc^2)
//   df = dct c sf (1 - sf);  di = dct tg si (1 - si);  dg = dct si (1 - tg^2)
//   dgates = [di | df | dg | do]   (B, 4H), float32
//   dx = dgates . Wx^T;  dh_prev = dgates . Wh^T;  dc_prev = dct sf
//   dWx = x^T . dgates;  dWh = h^T . dgates;  db = sum_B dgates
//
// the cotangents and every product in float32; dx, dh_prev and dc_prev
// rounded to bf16 once as they are stored; dWx, dWh and db the float32 sums
// over the whole batch (the reference's float32 outputs, :210-219), which
// the wrapper's autograd Function rounds to the weight dtype once
// (:246-249). The plain version is kernels/ref.py:lstm_cell_bwd_ref. Widths
// past the presets' (where kernels/lstm_cell.py:bwd_tc_plan is None) run
// lstm_bwd<__nv_bfloat16> in lstm_cell.cu; the fp32 stream runs lstm_bwd<float>.
//
// Bound on the card: the bytes. A row reads x, h, c, c', dh, dc and act and
// writes dx, dh_prev and dc_prev, 2 (2I + 9H) bytes at 2 bytes an element:
// 1,040 at I = H = 40, 17 MB at 16,384 rows, 0.0051 ms at 3.35 TB/s. The two
// products do 4 (I + H) 4H flops a row, 1 GFLOP there, three times that with
// the split below: 0.003 ms at the tensor cores' 989 TFLOP/s (wgmma). This
// kernel issues mma.sync with ldmatrix fragments: a 64-row tile at I = H = 40
// takes 2,640 mma.m16n8k16 and 1,760 ldmatrix.x4, and an SM issues about one
// ldmatrix.x4 every 4 cycles and one mma every 6 a sub-partition
// (scripts/mma_sync_rate.py), so at 16,384 rows the fragments' shared-memory
// traffic and the mma issue, not the bytes, set its time.
//
// The split that keeps the contract on the tensor cores. The cotangents are
// float32 values computed here, so rounding them to bf16 for mma.sync would
// change the result. Each is split into three bf16 terms, d0 = bf16(d),
// d1 = bf16(d - d0), d2 = bf16(d - d0 - d1): each difference is exact in
// float32, and after two roundings to 8 significant bits what is left has
// at most 8, so d0 + d1 + d2 == d for every finite d with |d| >= 2^-100
// (kernels/lstm_cell.py:split_bf16, held there on the CPU). x, h, the
// weights and db's column of ones are bf16 already, so each product of a
// term is exact in float32 and the kernel differs from the plain version
// only in the order of the float32 additions, as the fp32 kernel does.
//
// Design. 16 warps a block. Every product is mma.sync m16n8k16 (bf16 in,
// float32 sums) with ldmatrix fragments, and every warp task is one m-tile
// by one pair of n-tiles, so no mma issues under a false predicate (it would
// still take its slot); a task keeps a sum per term, added in term order at
// its end, and loads each k-step's fragments while the last k-step's run.
// * Staging: a tile's x and h rows go into [x | h | 1] (x at columns
//   [0, I), zeros to k_x, h from k_x, db's ones at k_x + H, zeros to k_pad)
//   and its runs of act, c, c', dh and dc (each a contiguous run of its
//   stream) into shared memory by cp.async, as wide as each stream's rows
//   and base allow (an x row is 28 bytes at I = 14, h rows 60 and 100 at
//   H = 30 and 50); the weights once per block as bf16, [k][gate column],
//   while the first tile's copies are in flight.
// * Cotangents: each (row, unit)'s, from shared memory, into three bf16
//   planes [term][row][gate column] (two units a thread where H is even),
//   dc_prev in the same pass.
// * [dx | dh_prev] = dgates . [Wx | Wh]^T: M = the tile's rows, N = k_w
//   staged inputs, K = 4H padded to 16; ldmatrix reads both as they lie.
//   They are staged as the outputs' own rows and leave as one contiguous run
//   each.
// * [dWx; dWh; db] = [x | h | 1]^T . dgates: M = k_pad staged inputs,
//   N = 4H padded, K = rows; ldmatrix.trans reads both.
// Two plans share the code (kernels/lstm_cell.py:bwd_tc_plan):
// * the split plan, up to 512 rows (the train step's first two layers at
//   batch 256, the fine-tune): row blocks of 16 or 32 rows form
//   [dx | dh_prev] and dc_prev; column blocks of 4 units (16 gate columns)
//   each stage [x | h | 1] and their units' residuals for every row (the
//   whole batch at once where it fits) and sum their columns of the weight
//   gradients over the batch, a warp an m-tile and every ksplit-th k-step,
//   the k-parts added in order. No block's sum meets another's: no cluster,
//   scratch or ticket, and the cotangents of a unit are formed twice (once
//   in a row block, once in a column block);
// * the cluster plan, above: a block walks `tiles` row tiles, forms both
//   products and adds each tile's weight-gradient sums into its float32
//   partial in shared memory (the first tile stores, later ones add, each
//   element by one lane). The blocks form thread-block clusters of
//   `cluster`; after a cluster barrier block rank r sums region r of the
//   gradients over the cluster's partials through distributed shared memory,
//   ranks in order. With one cluster that is the result; with more, each
//   block writes its region's cluster sum to a scratch buffer and takes that
//   region's integer ticket (atomicAdd after a __threadfence()); the last
//   cluster to finish a region adds the clusters' sums in cluster order,
//   writes the gradients and sets the ticket back to 0. The wrapper keeps
//   one set of tickets per device and stream
//   (kernels/lstm_cell.py:_ticket_counters): two launches that run at the
//   same time must not share one stream's set. At most 120 blocks, so that
//   the clusters of 8 are resident at once on an H100.
//
// The dx-only launch (lstm_cell_bwd_tc<true>; kernels/lstm_cell.py:
// bwd_dx_tc_plan), where no weight gradient is asked for (the esn head's
// frozen reservoir): row blocks alone at every batch size, each walking
// `tiles` row tiles with the split plan's row-block code and layout (no
// partial, no [x | h | 1], x and h never read), cluster size 1, no column
// block, scratch or ticket. Its tiles: the fewest m-tiles that give every SM
// at most one tile, else 64-row tiles walked `tiles` to a block. dx, dh_prev
// and dc_prev are the full launch's bits at any plan (each row's sums run
// k-step by k-step, term by term, whatever the tile). Taking no ticket, it
// adds no hazard to a CUDA graph replayed beside eager launches.
//
// Determinism: dx and dh_prev sum each row's products k-step by k-step, term
// by term, whatever the plan; the weight gradients sum in an order fixed by
// the plan (k-steps and k-parts within a column block; tiles within a block,
// ranks within a cluster, clusters in order), which is a function of the
// shape (never of the SM count or of which block ends first), and no float
// is summed atomically: two launches on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int BWD_TC_WARPS = 16;    // warps per block
constexpr int BWD_TC_THREADS = 32 * BWD_TC_WARPS;
constexpr int BWD_TC_MTILES = 4;    // 16-row m-tiles a row tile holds, at most
constexpr int BWD_TC_CLUSTER = 8;   // blocks per cluster, at most
constexpr int BWD_TC_TERMS = 3;     // bf16 terms of each float32 cotangent
constexpr int SUM_AHEAD = 8;        // clusters' sums a thread loads at once
constexpr int BWD_TC_COL_UNITS = 4;  // units of a column block of the split plan (one n-pair)

// the launch plan of the kernel, made by kernels/lstm_cell.py:bwd_tc_plan
// and passed as ints in this order
struct BwdTcPlan {
    int m_tiles;   // 16-row m-tiles per row tile: a tile is 16 m_tiles rows
    int tiles;     // row tiles a block walks, in order
    int blocks;    // blocks of the grid, a multiple of cluster
    int cluster;   // blocks per thread-block cluster
    int row_blocks;  // split plan: the blocks of [dx | dh_prev], then the column blocks of
                     // BWD_TC_COL_UNITS units; 0: the cluster plan
    int col_rows;    // split plan: rows a column block stages at once
    int k_x;       // staged column (and weight row) of the first h input: I rounded up to 8
    int k_w;       // staged weight rows: k_x + H rounded up to 16
    int k_pad;     // staged columns of [x | h | 1]: k_x + H + 1 rounded up to 16
    int n_pad;     // gate columns: 4H rounded up to 16
    int copy_w;    // bytes per copy of a weight row
    int copy_x;    // bytes per copy of an x row
    int copy_h;    // bytes per copy of an h row
    int copy_r;    // bytes per copy of the runs of act, c, c', dh and dc
    int copy_out;  // bytes per store of the runs of dx, dh_prev and dc_prev
    int smem;      // dynamic shared memory, bytes
};
constexpr int BWD_TC_PLAN_LEN = sizeof(BwdTcPlan) / sizeof(int);

// the shared-memory layout: byte offsets and sizes, from the plan and the
// widths (kernels/lstm_cell.py:bwd_tc_smem computes its total)
struct BwdTcLayout {
    int tile;       // rows per tile
    int w_stride;   // bytes per staged weight row, and per row of a cotangent term
    int x_stride;   // bytes per staged [x | h | 1] row
    int p_stride;   // floats per row of the partial weight gradients
    int p;          // the partial: I + H + 1 rows (dWx, dWh, db) of p_stride floats
    int x;          // [x | h | 1]
    int r;          // the runs of act, then c, c', dh, dc
    int r_act;      // bytes of act's run
    int r_run;      // bytes of a (tile, H) run
    int g;          // the three cotangent terms
    int g_bytes;    // bytes per term
    int o;          // dx, then dh_prev, then dc_prev
    int o_dx;       // bytes of dx's run
    int total;
};

__host__ __device__ inline int run_bytes(int elems) { return (2 * elems + 15) / 16 * 16; }

__host__ __device__ inline BwdTcLayout bwd_tc_layout(const BwdTcPlan& p, int in_size,
                                                     int hidden) {
    BwdTcLayout l;
    l.tile = 16 * p.m_tiles;
    l.w_stride = 2 * (p.n_pad + TC_PAD);
    l.x_stride = 2 * (p.k_pad + TC_PAD);
    l.p_stride = p.n_pad + TC_PAD;
    // (the split plan's row blocks keep no partial and stage no [x | h | 1])
    const bool split = p.row_blocks > 0;
    l.p = p.k_w * l.w_stride;
    l.x = l.p + (split ? 0 : 4 * (in_size + hidden + 1) * l.p_stride);
    l.r = l.x + (split ? 0 : l.tile * l.x_stride);
    l.r_act = run_bytes(4 * l.tile * hidden);
    l.r_run = run_bytes(l.tile * hidden);
    l.g = l.r + l.r_act + 4 * l.r_run;
    l.g_bytes = l.tile * l.w_stride;
    l.o = l.g + BWD_TC_TERMS * l.g_bytes;
    l.o_dx = run_bytes(l.tile * in_size);
    l.total = l.o + l.o_dx + 2 * l.r_run;
    return l;
}

// the column blocks' layout (split plan): a chunk of col_rows rows of
// [x | h | 1], of the slice's residuals ([row][act i, f, g, o, c, c', dh,
// dc][unit]) and of the three terms of its cotangents ([row][gate, unit]),
// and each task's float32 partial for the k-part sums
struct BwdTcColLayout {
    int rows;       // rows a chunk
    int x_stride;   // bytes per staged [x | h | 1] row
    int res;        // the residuals
    int g;          // the terms
    int g_stride;   // bytes per row of a term: the slice's gate columns and padding
    int g_bytes;    // bytes per term
    int ksplit;     // k-parts of each m-tile's sum (the warps an m-tile takes)
    int part;       // the partials, 16 x 16 floats per (m-tile, k-part)
    int total;
};

__host__ __device__ inline BwdTcColLayout bwd_tc_col_layout(const BwdTcPlan& p) {
    BwdTcColLayout l;
    const int m_tiles = p.k_pad / 16;
    l.rows = p.col_rows;
    l.x_stride = 2 * (p.k_pad + TC_PAD);
    l.res = l.rows * l.x_stride;
    l.g = l.res + run_bytes(8 * BWD_TC_COL_UNITS * l.rows);
    l.g_stride = 2 * (4 * BWD_TC_COL_UNITS + TC_PAD);
    l.g_bytes = l.rows * l.g_stride;
    l.ksplit = BWD_TC_WARPS / m_tiles > 1 ? BWD_TC_WARPS / m_tiles : 1;
    l.part = l.g + BWD_TC_TERMS * l.g_bytes;
    l.total = l.part + m_tiles * l.ksplit * 16 * 16 * 4;
    return l;
}

// a float32 cotangent as three bf16 terms that sum to it exactly (for
// |d| >= 2^-100; kernels/lstm_cell.py:split_bf16)
__device__ __forceinline__ void split_bf16(float d, __nv_bfloat16 (&t)[BWD_TC_TERMS]) {
    t[0] = __float2bfloat16_rn(d);
    const float r1 = d - __bfloat162float(t[0]);
    t[1] = __float2bfloat16_rn(r1);
    t[2] = __float2bfloat16_rn(r1 - __bfloat162float(t[1]));
}

// DivBy(d) with 32-bit arithmetic only (its constructor divides in 64 bits, a
// subroutine of some hundred dependent instructions): ceil(2^32 / d) is
// floor((2^32 - 1) / d) + 1 for d >= 1
__device__ __forceinline__ DivBy div_by(unsigned d) {
    DivBy q(1u);
    q.m = static_cast<unsigned long long>(0xFFFFFFFFu / d) + 1ull;
    return q;
}

// the address of a shared variable in block `rank` of the cluster, and a
// 16-byte load from such an address
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
    unsigned a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
    return a;
}
__device__ __forceinline__ float4 ld_cluster(unsigned addr) {
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(addr));
    return v;
}

// the cluster's barrier: arrive with release semantics (this block's
// shared-memory writes become visible to the cluster's blocks) and wait with
// acquire; and the same barrier with no ordering of memory, where it only
// keeps every block's shared memory alive until the cluster's reads are done
__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
                 "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the pre-activation gate cotangents (i, f, g, o) of one (row, unit) from
// its activations, c, c', dh and dc, and its dc_prev (all float32)
__device__ __forceinline__ void gate_cotangents(float si, float sf, float tg, float so, float c,
                                                float c_new, float dh, float dc, float (&d)[4],
                                                float& dc_prev) {
    const float tc = tanhf(c_new);
    const float dct = dc + dh * so * (1.0f - tc * tc);
    dc_prev = dct * sf;
    d[0] = dct * tg * si * (1.0f - si);
    d[1] = dct * c * sf * (1.0f - sf);
    d[2] = dct * si * (1.0f - tg * tg);
    d[3] = dh * tc * so * (1.0f - so);
}

// A column block of the split plan: units j0 .. j0 + BWD_TC_COL_UNITS - 1 (their
// 16 gate columns, i, f, g, o of each in turn) over every row of the
// batch, chunk by chunk: their cotangents (again: the row blocks form them
// for [dx | dh_prev]) and [dWx; dWh; db] of those columns as one sum over the
// batch, written whole, so no block's sum meets another's. A warp takes an
// m-tile of the staged inputs and every ksplit-th k-step; the k-parts are
// added in order at the end.
__device__ __forceinline__ void bwd_cols(const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ h,
                                         const __nv_bfloat16* __restrict__ c,
                                         const __nv_bfloat16* __restrict__ c_new,
                                         const __nv_bfloat16* __restrict__ act,
                                         const __nv_bfloat16* __restrict__ dh,
                                         const __nv_bfloat16* __restrict__ dc,
                                         float* __restrict__ dwx, float* __restrict__ dwh,
                                         float* __restrict__ db, int rows, int in_size,
                                         int hidden, const BwdTcPlan& p, unsigned char* smem) {
    const BwdTcColLayout L = bwd_tc_col_layout(p);
    constexpr int U = BWD_TC_COL_UNITS;
    const int g4 = 4 * hidden, kw = in_size + hidden;
    const int j0 = (static_cast<int>(blockIdx.x) - p.row_blocks) * U, nu = min(U, hidden - j0);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    unsigned char* const xs = smem;
    __nv_bfloat16* const res = reinterpret_cast<__nv_bfloat16*>(smem + L.res);
    unsigned char* const gs = smem + L.g;
    float* const part = reinterpret_cast<float*>(smem + L.part);
    const int m_tiles = p.k_pad / 16;
    const int mt = warp % m_tiles, kc = warp / m_tiles;
    const bool busy = kc < L.ksplit;
    const auto bytes = [](const __nv_bfloat16* q) {
        return reinterpret_cast<const unsigned char*>(q);
    };
    // [x | h | 1]'s padding columns and db's ones, once, a thread a row
    for (int r = tid; r < L.rows; r += blockDim.x) {
        unsigned short* row = reinterpret_cast<unsigned short*>(xs + r * L.x_stride);
        for (int col = in_size; col < p.k_x; ++col) row[col] = 0;
        row[p.k_x + hidden] = 0x3F80;          // bf16 1.0
        for (int col = p.k_x + hidden + 1; col < p.k_pad; ++col) row[col] = 0;
    }
    const DivBy by_x = div_by(2 * in_size / p.copy_x), by_h = div_by(2 * hidden / p.copy_h);
    const __nv_bfloat16* const runs[4] = {c, c_new, dh, dc};
    // the residuals: a stream's nu units of a row in copies of cw bytes (all
    // four in one where H is a multiple of 4, two where H is even, each
    // alone else), as their rows and bases allow
    const int cw = hidden % 4 == 0 && nu == U && p.copy_r >= 8 ? 8
                   : (hidden % 2 == 0 && p.copy_r >= 4 ? 4 : 2);
    const int per = 2 * nu / cw;               // copies a stream's slice of a row
    const DivBy by_res = div_by(8 * per);
    const unsigned a_addr = smem_addr(xs) + ((lane & 7) + ((lane >> 4) & 1) * 8) * L.x_stride +
                            (mt * 16 + ((lane >> 3) & 1) * 8) * 2;
    const unsigned b_addr = smem_addr(gs) + ((lane & 7) + ((lane >> 3) & 1) * 8) * L.g_stride +
                            (lane >> 4) * 16;
    float acc[BWD_TC_TERMS][2][4] = {};
    for (int r0 = 0; r0 < rows; r0 += L.rows) {
        const int nr = min(L.rows, rows - r0);
        __syncthreads();                       // the last chunk's reads are done
        stage_rows_by(p.copy_x, xs, L.x_stride, bytes(x + static_cast<long>(r0) * in_size),
                      2 * in_size, nr, by_x);
        stage_rows_by(p.copy_h, xs + 2 * p.k_x, L.x_stride,
                      bytes(h + static_cast<long>(r0) * hidden), 2 * hidden, nr, by_h);
        for (int e = tid; e < (L.rows - nr) * kw; e += blockDim.x) {
            const int r = nr + e / kw, k = e % kw;
            const int col = k < in_size ? k : p.k_x + k - in_size;
            *reinterpret_cast<unsigned short*>(xs + r * L.x_stride + 2 * col) = 0;
        }
        // residual (row r, stream q, unit u) at res[(r * 8 + q) * U + u]:
        // streams 0-3 act's gates, 4-7 c, c', dh, dc
        for (int e = tid; e < nr * 8 * per; e += blockDim.x) {
            const int r = static_cast<int>(by_res.of(e)), rest = e - r * 8 * per;
            const int q = rest / per, u = (rest - q * per) * (cw / 2);
            const long row = r0 + r;
            const __nv_bfloat16* src = q < 4 ? act + row * g4 + q * hidden + j0 + u
                                             : runs[q - 4] + row * hidden + j0 + u;
            __nv_bfloat16* dst = res + (r * 8 + q) * U + u;
            if (cw == 8) __pipeline_memcpy_async(dst, src, 8);
            else if (cw == 4) __pipeline_memcpy_async(dst, src, 4);
            else *dst = src[0];
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        // the slice's cotangents, three bf16 terms at [row][gate * U + unit]
        for (int e = tid; e < L.rows * U; e += blockDim.x) {
            const int r = e / U, u = e - r * U;
            float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (r < nr && u < nu) {
                const __nv_bfloat16* v = res + r * 8 * U + u;
                float dcp;
                gate_cotangents(repro::widen(v[0]), repro::widen(v[U]), repro::widen(v[2 * U]),
                                repro::widen(v[3 * U]), repro::widen(v[4 * U]),
                                repro::widen(v[5 * U]), repro::widen(v[6 * U]),
                                repro::widen(v[7 * U]), d, dcp);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                __nv_bfloat16 terms[BWD_TC_TERMS];
                split_bf16(d[q], terms);
#pragma unroll
                for (int k = 0; k < BWD_TC_TERMS; ++k)
                    *reinterpret_cast<__nv_bfloat16*>(gs + k * L.g_bytes + r * L.g_stride +
                                                      2 * (q * U + u)) = terms[k];
            }
        }
        __syncthreads();
        // this warp's k-steps of the chunk: rows 16 ks .. + 15
        if (busy) {
            for (int ks = kc; ks * 16 < nr; ks += L.ksplit) {
                unsigned a[4], b[BWD_TC_TERMS][4];
                ldmatrix_x4_trans(a, a_addr + ks * 16 * L.x_stride);
#pragma unroll
                for (int k = 0; k < BWD_TC_TERMS; ++k)
                    ldmatrix_x4_trans(b[k], b_addr + k * L.g_bytes + ks * 16 * L.g_stride);
#pragma unroll
                for (int k = 0; k < BWD_TC_TERMS; ++k) {
                    mma_bf16(acc[k][0], a, b[k][0], b[k][1]);
                    mma_bf16(acc[k][1], a, b[k][2], b[k][3]);
                }
            }
        }
    }
    // the k-parts of each m-tile added in order, then written: staged input s
    // is row s of dWx (s < I), I + s - k_x of dWh, or db at s = k_x + H; local
    // column gate * U + unit is gate column gate * H + j0 + unit
    if (busy) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = g + 8 * (i >> 1), col = n * 8 + 2 * tq + (i & 1);
                part[((mt * L.ksplit + kc) * 16 + r) * 16 + col] =
                    acc[0][n][i] + acc[1][n][i] + acc[2][n][i];
            }
        }
    }
    __syncthreads();
    for (int e = tid; e < m_tiles * 256; e += blockDim.x) {
        const int m = e >> 8, rc = e & 255;
        const int s = m * 16 + (rc >> 4), col = rc & 15, q = col / U, u = col - q * U;
        const int kr = s < in_size ? s
                       : (s >= p.k_x && s <= p.k_x + hidden ? s - p.k_x + in_size : -1);
        if (kr < 0 || u >= nu) continue;
        const float* pp = part + m * L.ksplit * 256 + rc;
        float v = pp[0];
        for (int k = 1; k < L.ksplit; ++k) v += pp[k * 256];
        const int gc = q * hidden + j0 + u;
        if (kr < in_size) dwx[kr * g4 + gc] = v;
        else if (kr < kw) dwh[(kr - in_size) * g4 + gc] = v;
        else db[gc] = v;
    }
}

template <bool DX_ONLY>
__global__ void __launch_bounds__(BWD_TC_THREADS, 1)
lstm_cell_bwd_tc(const __nv_bfloat16* __restrict__ wx, const __nv_bfloat16* __restrict__ wh,
                 const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ h,
                 const __nv_bfloat16* __restrict__ c, const __nv_bfloat16* __restrict__ c_new,
                 const __nv_bfloat16* __restrict__ act, const __nv_bfloat16* __restrict__ dh,
                 const __nv_bfloat16* __restrict__ dc, __nv_bfloat16* __restrict__ dx,
                 __nv_bfloat16* __restrict__ dh_prev, __nv_bfloat16* __restrict__ dc_prev,
                 float* __restrict__ dwx, float* __restrict__ dwh, float* __restrict__ db,
                 float* __restrict__ scratch, unsigned int* __restrict__ tickets, int rows,
                 int in_size, int hidden, BwdTcPlan p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int last;
    if (!DX_ONLY && p.row_blocks > 0 && static_cast<int>(blockIdx.x) >= p.row_blocks) {
        bwd_cols(x, h, c, c_new, act, dh, dc, dwx, dwh, db, rows, in_size, hidden, p, smem);
        return;
    }
    // a row block of the split plan or of the dx-only launch: no weight gradients
    const bool split = DX_ONLY || p.row_blocks > 0;
    const BwdTcLayout L = bwd_tc_layout(p, in_size, hidden);
    const int g4 = 4 * hidden, kw = in_size + hidden;
    const int tid = threadIdx.x;
    unsigned char* const ws = smem;
    float* const ps = reinterpret_cast<float*>(smem + L.p);
    unsigned char* const xs = smem + L.x;
    unsigned char* const rs = smem + L.r;
    unsigned char* const gs = smem + L.g;
    unsigned char* const os = smem + L.o;
    const int n_tiles = (rows + L.tile - 1) / L.tile;
    const int t_beg = static_cast<int>(blockIdx.x) * p.tiles;
    const int t_end = min(n_tiles, t_beg + p.tiles);
    const auto bytes = [](const __nv_bfloat16* q) {
        return reinterpret_cast<const unsigned char*>(q);
    };

    // tile t's [x | h] rows and runs into shared memory, by cp.async; the
    // data columns of rows past the batch are zeroed (their cotangents are
    // zeros, and a stale or unset value could be a NaN)
    const DivBy by_x = div_by(2 * in_size / p.copy_x), by_h = div_by(2 * hidden / p.copy_h);
    const auto stage = [&](int t) {
        const long row0 = static_cast<long>(t) * L.tile;
        const int nr = min(L.tile, rows - static_cast<int>(row0));
        if (!split) {
            stage_rows_by(p.copy_x, xs, L.x_stride, bytes(x + row0 * in_size), 2 * in_size, nr,
                          by_x);
            stage_rows_by(p.copy_h, xs + 2 * p.k_x, L.x_stride, bytes(h + row0 * hidden),
                          2 * hidden, nr, by_h);
            for (int e = tid; e < (L.tile - nr) * kw; e += blockDim.x) {
                const int r = nr + e / kw, k = e % kw;
                const int col = k < in_size ? k : p.k_x + k - in_size;
                *reinterpret_cast<unsigned short*>(xs + r * L.x_stride + 2 * col) = 0;
            }
        }
        stage_run_by(p.copy_r, rs, bytes(act + row0 * g4), 2 * nr * g4);
        const __nv_bfloat16* runs[4] = {c, c_new, dh, dc};
        for (int q = 0; q < 4; ++q)
            stage_run_by(p.copy_r, rs + L.r_act + q * L.r_run, bytes(runs[q] + row0 * hidden),
                         2 * nr * hidden);
    };
    // the first tile's copies, then the weights', in flight together
    if (t_beg < t_end) stage(t_beg);
    const DivBy by_w = div_by(8 * hidden / p.copy_w);
    stage_rows_by(p.copy_w, ws, L.w_stride, bytes(wx), 8 * hidden, in_size, by_w);
    stage_rows_by(p.copy_w, ws + p.k_x * L.w_stride, L.w_stride, bytes(wh), 8 * hidden, hidden,
                  by_w);
    __pipeline_commit();

    // what no copy writes, where the products read it: the weights' padding
    // rows and the padding columns [4H, n_pad) of the copied ones, the
    // [x | h | 1] padding columns and db's ones, the terms' padding columns
    const int pad_x = p.k_x - in_size;
    const int pad_rows = pad_x + p.k_w - p.k_x - hidden, row_words = p.n_pad / 8;
    for (int e = tid; e < pad_rows * row_words; e += blockDim.x) {
        const int i = e / row_words, w = e - i * row_words;
        const int s = i < pad_x ? in_size + i : p.k_x + hidden + (i - pad_x);
        *reinterpret_cast<uint4*>(ws + s * L.w_stride + 16 * w) = make_uint4(0, 0, 0, 0);
    }
    const int pad_words = (p.n_pad - g4) / 2;  // 4-byte words past the gate columns
    for (int e = tid; e < kw * pad_words; e += blockDim.x) {
        const int i = e / pad_words, w = e - i * pad_words;
        const int s = i < in_size ? i : p.k_x + i - in_size;
        *reinterpret_cast<unsigned*>(ws + s * L.w_stride + 2 * g4 + 4 * w) = 0;
    }
    for (int e = tid; e < BWD_TC_TERMS * L.tile * pad_words; e += blockDim.x) {
        const int row = e / pad_words, w = e - row * pad_words;   // row over the terms' rows
        *reinterpret_cast<unsigned*>(gs + row * L.w_stride + 2 * g4 + 4 * w) = 0;
    }
    const int n_const = split ? 0 : pad_x + p.k_pad - p.k_x - hidden;
    for (int e = tid; e < L.tile * n_const; e += blockDim.x) {
        const int r = e / n_const, i = e - r * n_const;
        const int col = i < pad_x ? in_size + i : p.k_x + hidden + (i - pad_x);
        *reinterpret_cast<unsigned short*>(xs + r * L.x_stride + 2 * col) =
            col == p.k_x + hidden ? 0x3F80 : 0;      // bf16 1.0
    }

    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;    // the accumulator fragment's row and column pair
    // [dx | dh_prev] tasks: an m-tile by a pair of n-tiles of the staged
    // inputs; weight-gradient tasks: an m-tile of the staged inputs by a pair
    // of n-tiles of the gate columns
    const int pairs1 = p.k_w / 16, tasks1 = p.m_tiles * pairs1;
    const int k1_steps = p.n_pad / 16;
    const int pairs2 = p.n_pad / 16, tasks2 = split ? 0 : p.k_pad / 16 * pairs2;
    __nv_bfloat16* const dxs = reinterpret_cast<__nv_bfloat16*>(os);
    __nv_bfloat16* const dhs = reinterpret_cast<__nv_bfloat16*>(os + L.o_dx);
    __nv_bfloat16* const dcs = reinterpret_cast<__nv_bfloat16*>(os + L.o_dx + L.r_run);
    const __nv_bfloat16* const act_s = reinterpret_cast<const __nv_bfloat16*>(rs);
    const __nv_bfloat16* const res_s = reinterpret_cast<const __nv_bfloat16*>(rs + L.r_act);
    const int run_elems = L.r_run / 2;         // c, c', dh, dc: runs this many bf16 apart
    const int hp = hidden / 2;
    const DivBy by_hp = div_by(hidden % 2 == 0 ? hp : hidden);

    for (int t = t_beg; t < t_end; ++t) {
        __pipeline_wait_prior(0);              // this thread's copies have landed
        __syncthreads();                       // ... every thread's, and the constants
        const long row0 = static_cast<long>(t) * L.tile;
        const int nr = min(L.tile, rows - static_cast<int>(row0));

        // the cotangents of each (row, unit), once, as three bf16 terms
        // [term][row][gate column] (zeros past the batch), and dc_prev; two
        // units a thread where H is even (4-byte loads and stores)
        if (hidden % 2 == 0) {
            for (int e = tid; e < L.tile * hp; e += blockDim.x) {
                const int r = static_cast<int>(by_hp.of(e)), j = 2 * (e - r * hp);
                float d[4][2] = {}, dcp[2];
                if (r < nr) {
                    float v[8][2];             // si, sf, tg, so, c, c', dh, dc
#pragma unroll
                    for (int q = 0; q < 8; ++q) {
                        const __nv_bfloat16* at =
                            q < 4 ? act_s + r * g4 + q * hidden + j
                                  : res_s + (q - 4) * run_elems + r * hidden + j;
                        const float2 f =
                            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
                        v[q][0] = f.x;
                        v[q][1] = f.y;
                    }
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        float du[4];
                        gate_cotangents(v[0][u], v[1][u], v[2][u], v[3][u], v[4][u], v[5][u],
                                        v[6][u], v[7][u], du, dcp[u]);
#pragma unroll
                        for (int q = 0; q < 4; ++q) d[q][u] = du[q];
                    }
                    *reinterpret_cast<__nv_bfloat162*>(dcs + r * hidden + j) =
                        __floats2bfloat162_rn(dcp[0], dcp[1]);
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    __nv_bfloat16 lo[BWD_TC_TERMS], hi[BWD_TC_TERMS];
                    split_bf16(d[q][0], lo);
                    split_bf16(d[q][1], hi);
                    unsigned char* dst = gs + r * L.w_stride + 2 * (q * hidden + j);
#pragma unroll
                    for (int k = 0; k < BWD_TC_TERMS; ++k)
                        *reinterpret_cast<__nv_bfloat162*>(dst + k * L.g_bytes) =
                            __halves2bfloat162(lo[k], hi[k]);
                }
            }
        } else {
            for (int e = tid; e < L.tile * hidden; e += blockDim.x) {
                const int r = static_cast<int>(by_hp.of(e)), j = e - r * hidden;
                float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                if (r < nr) {
                    const __nv_bfloat16* ar = act_s + r * g4 + j;
                    const __nv_bfloat16* vr = res_s + r * hidden + j;
                    float dcp;
                    gate_cotangents(repro::widen(ar[0]), repro::widen(ar[hidden]),
                                    repro::widen(ar[2 * hidden]), repro::widen(ar[3 * hidden]),
                                    repro::widen(vr[0]), repro::widen(vr[run_elems]),
                                    repro::widen(vr[2 * run_elems]),
                                    repro::widen(vr[3 * run_elems]), d, dcp);
                    dcs[r * hidden + j] = repro::narrow<__nv_bfloat16>(dcp);
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    __nv_bfloat16 terms[BWD_TC_TERMS];
                    split_bf16(d[q], terms);
                    unsigned char* dst = gs + r * L.w_stride + 2 * (q * hidden + j);
#pragma unroll
                    for (int k = 0; k < BWD_TC_TERMS; ++k)
                        *reinterpret_cast<__nv_bfloat16*>(dst + k * L.g_bytes) = terms[k];
                }
            }
        }
        __syncthreads();

        // the products, each k-step's fragments loaded while the last
        // k-step's run on the tensor cores (two register sets, the k-loop
        // unrolled by two). Every task is one m-tile by one pair of n-tiles,
        // so no mma is issued under a false predicate (one still takes its
        // slot of the tensor pipe); a sum per term, added in term order at
        // the end
        const bool first = t == t_beg;
        for (int task = warp; task < tasks1 + tasks2; task += BWD_TC_WARPS) {
            float acc[BWD_TC_TERMS][2][4] = {};
            if (task < tasks1) {
                // [dx | dh_prev] of m-tile mt, staged inputs pr * 16 .. + 15:
                // A the terms' rows (ldmatrix: lanes 0-15 rows 0-15 at k 0,
                // lanes 16-31 at k 8), B weight rows n (k contiguous)
                const int mt = task / pairs1, pr = task - mt * pairs1;
                const unsigned a_addr = smem_addr(gs) + (mt * 16 + (lane & 15)) * L.w_stride +
                                        (lane >> 4) * 16;
                const unsigned b_addr = smem_addr(ws) +
                                        (pr * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * L.w_stride +
                                        ((lane >> 3) & 1) * 16;
                unsigned a0[BWD_TC_TERMS][4], b0[4], a1[BWD_TC_TERMS][4], b1[4];
                const auto load = [&](int ks, unsigned (&a)[BWD_TC_TERMS][4], unsigned (&b)[4]) {
#pragma unroll
                    for (int k = 0; k < BWD_TC_TERMS; ++k)
                        ldmatrix_x4(a[k], a_addr + k * L.g_bytes + ks * 32);
                    ldmatrix_x4(b, b_addr + ks * 32);
                };
                const auto step = [&](int ks, const unsigned (&a)[BWD_TC_TERMS][4],
                                      const unsigned (&b)[4], unsigned (&an)[BWD_TC_TERMS][4],
                                      unsigned (&bn)[4]) {
                    if (ks + 1 < k1_steps) load(ks + 1, an, bn);
#pragma unroll
                    for (int k = 0; k < BWD_TC_TERMS; ++k) {
                        mma_bf16(acc[k][0], a[k], b[0], b[1]);
                        mma_bf16(acc[k][1], a[k], b[2], b[3]);
                    }
                };
                load(0, a0, b0);
                for (int ks = 0; ks < k1_steps; ks += 2) {
                    step(ks, a0, b0, a1, b1);
                    if (ks + 1 < k1_steps) step(ks + 1, a1, b1, a0, b0);
                }
#pragma unroll
                for (int n = 0; n < 2; ++n) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int r = mt * 16 + g + 8 * (i >> 1);
                        const int s = pr * 16 + n * 8 + 2 * tq + (i & 1);
                        if (r >= nr) continue;
                        const __nv_bfloat16 v = repro::narrow<__nv_bfloat16>(
                            acc[0][n][i] + acc[1][n][i] + acc[2][n][i]);
                        if (s < in_size) dxs[r * in_size + s] = v;
                        else if (s >= p.k_x && s < p.k_x + hidden) dhs[r * hidden + s - p.k_x] = v;
                    }
                }
            } else {
                // the weight gradients of staged inputs mt * 16 .. + 15, gate
                // columns pr * 16 .. + 15, over the tile's rows: ldmatrix.trans
                // of A from [row][input] (matrix lane / 8 is (k 0-7 | 8-15) x
                // (m 0-7 | 8-15), k outer) and of B from [row][gate column]
                // (k inner)
                const int task2 = task - tasks1;
                const int mt = task2 / pairs2, pr = task2 - mt * pairs2;
                const unsigned a_addr =
                    smem_addr(xs) + ((lane & 7) + ((lane >> 4) & 1) * 8) * L.x_stride +
                    (mt * 16 + ((lane >> 3) & 1) * 8) * 2;
                const unsigned b_addr =
                    smem_addr(gs) + ((lane & 7) + ((lane >> 3) & 1) * 8) * L.w_stride +
                    (pr * 16 + (lane >> 4) * 8) * 2;
                unsigned a0[4], b0[BWD_TC_TERMS][4], a1[4], b1[BWD_TC_TERMS][4];
                const auto load = [&](int ks, unsigned (&a)[4], unsigned (&b)[BWD_TC_TERMS][4]) {
                    ldmatrix_x4_trans(a, a_addr + ks * 16 * L.x_stride);
#pragma unroll
                    for (int k = 0; k < BWD_TC_TERMS; ++k)
                        ldmatrix_x4_trans(b[k], b_addr + k * L.g_bytes + ks * 16 * L.w_stride);
                };
                const auto step = [&](int ks, const unsigned (&a)[4],
                                      const unsigned (&b)[BWD_TC_TERMS][4], unsigned (&an)[4],
                                      unsigned (&bn)[BWD_TC_TERMS][4]) {
                    if (ks + 1 < p.m_tiles) load(ks + 1, an, bn);
#pragma unroll
                    for (int k = 0; k < BWD_TC_TERMS; ++k) {
                        mma_bf16(acc[k][0], a, b[k][0], b[k][1]);
                        mma_bf16(acc[k][1], a, b[k][2], b[k][3]);
                    }
                };
                load(0, a0, b0);
                for (int ks = 0; ks < p.m_tiles; ks += 2) {
                    step(ks, a0, b0, a1, b1);
                    if (ks + 1 < p.m_tiles) step(ks + 1, a1, b1, a0, b0);
                }
                // into the partial: staged input s is row s of dWx (s < I),
                // I + s - k_x of dWh, or I + H (db) at s = k_x + H
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int s = mt * 16 + g + 8 * half;
                    const int kr = s < in_size ? s
                                   : (s >= p.k_x && s <= p.k_x + hidden ? s - p.k_x + in_size : -1);
                    if (kr < 0) continue;
#pragma unroll
                    for (int n = 0; n < 2; ++n) {
                        const int col = pr * 16 + n * 8 + 2 * tq;
                        if (col >= g4) continue;
                        float2* q = reinterpret_cast<float2*>(ps + kr * L.p_stride + col);
                        float2 v = make_float2(
                            acc[0][n][2 * half] + acc[1][n][2 * half] + acc[2][n][2 * half],
                            acc[0][n][2 * half + 1] + acc[1][n][2 * half + 1] +
                                acc[2][n][2 * half + 1]);
                        if (!first) {
                            const float2 was = *q;
                            v = make_float2(was.x + v.x, was.y + v.y);
                        }
                        *q = v;
                    }
                }
            }
        }
        __syncthreads();                       // the tile's outputs are staged, its inputs read

        if (t + 1 < t_end) stage(t + 1);
        __pipeline_commit();
        // the tile's rows of dx, dh_prev and dc_prev are contiguous runs
        store_run_by(p.copy_out, dx + row0 * in_size, os, 2 * nr * in_size);
        store_run_by(p.copy_out, dh_prev + row0 * hidden, os + L.o_dx, 2 * nr * hidden);
        store_run_by(p.copy_out, dc_prev + row0 * hidden, os + L.o_dx + L.r_run, 2 * nr * hidden);
    }
    if (split) return;
    if (t_beg >= t_end) {                      // a block past the batch adds zeros
        for (int e = tid; e < (kw + 1) * L.p_stride; e += blockDim.x) ps[e] = 0.0f;
    }
    __pipeline_wait_prior(0);                  // (its weight copies too)

    // the cluster's sum: block rank r takes region r of the (I + H + 1) x 4H
    // gradients, 4 columns a thread, and adds the ranks' partials in rank
    // order (its own from its shared memory, the others' through the
    // cluster's)
    if (p.cluster > 1) cluster_barrier();
    else __syncthreads();
    unsigned rank_u;                           // this block's rank in its cluster
    asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank_u));
    const int rank = static_cast<int>(rank_u);
    const int g4q = g4 / 4;                    // float4s a gradient row
    const int n_out = (kw + 1) * g4;
    const int lo = rank * (n_out / 4) / p.cluster, hi = (rank + 1) * (n_out / 4) / p.cluster;
    const int clusters = p.blocks / p.cluster;
    const int cid = static_cast<int>(blockIdx.x) / p.cluster;
    float4* const out4[3] = {reinterpret_cast<float4*>(dwx), reinterpret_cast<float4*>(dwh),
                             reinterpret_cast<float4*>(db)};
    const auto out = [&](int o4) -> float4* {  // the gradients' float4 o4
        if (o4 < in_size * g4q) return out4[0] + o4;
        if (o4 < kw * g4q) return out4[1] + (o4 - in_size * g4q);
        return out4[2] + (o4 - kw * g4q);
    };
    unsigned peers[BWD_TC_CLUSTER];            // the ranks' partials, as cluster addresses
#pragma unroll
    for (int q = 0; q < BWD_TC_CLUSTER; ++q) peers[q] = cluster_addr(ps, q < p.cluster ? q : 0);
    float4* const scratch4 = reinterpret_cast<float4*>(scratch);
    for (int o4 = lo + tid; o4 < hi; o4 += blockDim.x) {
        const int kr = o4 / g4q;
        const unsigned off = 4 * (kr * L.p_stride) + 16 * (o4 - kr * g4q);   // bytes
        float4 v[BWD_TC_CLUSTER];
#pragma unroll
        for (int q = 0; q < BWD_TC_CLUSTER; ++q)
            if (q < p.cluster) v[q] = ld_cluster(peers[q] + off);
        float4 s = v[0];
#pragma unroll
        for (int q = 1; q < BWD_TC_CLUSTER; ++q) {
            if (q < p.cluster)
                s = make_float4(s.x + v[q].x, s.y + v[q].y, s.z + v[q].z, s.w + v[q].w);
        }
        if (clusters == 1) *out(o4) = s;
        else scratch4[static_cast<long>(cid) * (n_out / 4) + o4] = s;
    }
    if (p.cluster > 1) cluster_barrier_relaxed();   // every partial read before a block exits
    if (clusters == 1) return;

    // the clusters' sums: the last cluster to finish region r adds them in
    // cluster order
    __threadfence();                           // the sums are visible ...
    __syncthreads();
    if (tid == 0) {                            // ... before the ticket is taken
        const unsigned n = atomicAdd(tickets + rank, 1u);
        last = n == static_cast<unsigned>(clusters - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int o4 = lo + tid; o4 < hi; o4 += blockDim.x) {
        float4 s = __ldcg(scratch4 + o4);
        for (int c0 = 1; c0 < clusters; c0 += SUM_AHEAD) {
            float4 v[SUM_AHEAD];
#pragma unroll
            for (int a = 0; a < SUM_AHEAD; ++a)
                if (c0 + a < clusters) v[a] = __ldcg(scratch4 + (c0 + a) * (n_out / 4L) + o4);
#pragma unroll
            for (int a = 0; a < SUM_AHEAD; ++a) {
                if (c0 + a < clusters)
                    s = make_float4(s.x + v[a].x, s.y + v[a].y, s.z + v[a].z, s.w + v[a].w);
            }
        }
        *out(o4) = s;
    }
    if (tid == 0) tickets[rank] = 0;           // ready for the next launch
}

// whether the kernel takes a plan for this shape and these tensors: its
// geometry, a copy width per stream that the stream's rows (or runs) and base
// allow, and the shared memory of the layout the source computes
// (dx_only: the dx-only launch's plan, whose x and h, never read, are null and
// copied by no width)
bool bwd_tc_plan_fits(const BwdTcPlan& p, int rows, int in_size, int hidden,
                      const void* const (&ins)[9], const void* const (&outs)[3],
                      bool dx_only) {
    const auto width = [](int w) { return w == 2 || w == 4 || w == 8 || w == 16; };
    const auto on = [](const void* q, int w) { return reinterpret_cast<uintptr_t>(q) % w == 0; };
    const int k_x = (in_size + 7) / 8 * 8;
    const bool split = p.row_blocks > 0;
    const long covered = 16L * p.m_tiles * p.tiles * (split ? p.row_blocks : p.blocks);
    const bool plan_kind =
        dx_only ? p.row_blocks == p.blocks && p.cluster == 1 && p.col_rows == 0 &&
                      p.copy_x == 0 && p.copy_h == 0
        : split ? p.tiles == 1 && p.cluster == 1 && p.col_rows >= 16 && p.col_rows % 16 == 0 &&
                      p.blocks == p.row_blocks + (hidden + BWD_TC_COL_UNITS - 1) / BWD_TC_COL_UNITS
                : p.col_rows == 0 && p.blocks >= p.cluster && p.blocks % p.cluster == 0;
    const bool geometry =
        plan_kind && p.m_tiles >= 1 && p.m_tiles <= BWD_TC_MTILES && p.tiles >= 1 &&
        p.cluster >= 1 && p.cluster <= BWD_TC_CLUSTER && covered >= rows && p.k_x == k_x &&
        p.k_w == (k_x + hidden + 15) / 16 * 16 && p.k_pad == (k_x + hidden + 16) / 16 * 16 &&
        p.n_pad == (4 * hidden + 15) / 16 * 16;
    // ins: wx, wh, x, h, c, c', act, dh, dc
    bool copies = width(p.copy_w) && (8 * hidden) % p.copy_w == 0 && on(ins[0], p.copy_w) &&
                  on(ins[1], p.copy_w) && width(p.copy_r) && width(p.copy_out) &&
                  (dx_only || (width(p.copy_x) && (2 * in_size) % p.copy_x == 0 &&
                               on(ins[2], p.copy_x) && width(p.copy_h) &&
                               (2 * hidden) % p.copy_h == 0 && on(ins[3], p.copy_h)));
    for (int i = 4; i < 9; ++i) copies = copies && on(ins[i], p.copy_r);
    for (const void* o : outs) copies = copies && on(o, p.copy_out);
    const int need = bwd_tc_layout(p, in_size, hidden).total;
    return geometry && copies &&
           p.smem == (split && !dx_only ? max(need, bwd_tc_col_layout(p).total) : need);
}

// plan: BwdTcPlan's BWD_TC_PLAN_LEN ints; scratch: (blocks / cluster,
// I + H + 1, 4H) floats and tickets: cluster unsigned ints, all 0, which the
// kernel leaves at 0, both where there is more than one cluster
// dx_only: the dx-only launch (x, h, dwx, dwh, db, scratch and tickets null)
int launch_bwd_tc(const void* wx, const void* wh, const void* x, const void* h, const void* c,
                  const void* c_new, const void* act, const void* dh, const void* dc, void* dx,
                  void* dh_prev, void* dc_prev, void* dwx, void* dwh, void* db, void* scratch,
                  void* tickets, const void* plan, int plan_len, int rows, int in_size,
                  int hidden, void* stream, bool dx_only) {
    if (plan == nullptr || plan_len != BWD_TC_PLAN_LEN || rows < 1 || in_size < 1 || hidden < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int* v = static_cast<const int*>(plan);
    const BwdTcPlan p{v[0], v[1], v[2],  v[3],  v[4],  v[5],  v[6],  v[7],
                      v[8], v[9], v[10], v[11], v[12], v[13], v[14], v[15]};
    const void* const ins[9] = {wx, wh, x, h, c, c_new, act, dh, dc};
    const void* const outs[3] = {dx, dh_prev, dc_prev};
    if (!bwd_tc_plan_fits(p, rows, in_size, hidden, ins, outs, dx_only) ||
        (p.row_blocks == 0 && p.blocks > p.cluster && (scratch == nullptr || tickets == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    static repro::SmemOptIn opt_in;            // per device (common.cuh)
    static repro::SmemOptIn opt_in_dx;
    const auto kernel = dx_only ? lstm_cell_bwd_tc<true> : lstm_cell_bwd_tc<false>;
    cudaError_t err = (dx_only ? opt_in_dx : opt_in).ensure(reinterpret_cast<const void*>(kernel),
                                                           p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(p.blocks));
    cfg.blockDim = dim3(BWD_TC_THREADS);
    cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const auto in = [](const void* q) { return static_cast<const __nv_bfloat16*>(q); };
    const auto out = [](void* q) { return static_cast<__nv_bfloat16*>(q); };
    const auto f = [](void* q) { return static_cast<float*>(q); };
    err = cudaLaunchKernelEx(&cfg, kernel, in(wx), in(wh), in(x), in(h), in(c),
                             in(c_new), in(act), in(dh), in(dc), out(dx), out(dh_prev),
                             out(dc_prev), f(dwx), f(dwh), f(db), f(scratch),
                             static_cast<unsigned int*>(tickets), rows, in_size, hidden, p);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5 in bf16 at the presets' widths: every input and dx, dh_prev, dc_prev
// bf16; dwx, dwh, db (and the scratch) float, the sums over the batch before
// any rounding
extern "C" int lstm_cell_bwd_bf16(const void* wx, const void* wh, const void* x, const void* h,
                                  const void* c, const void* c_new, const void* act,
                                  const void* dh, const void* dc, void* dx, void* dh_prev,
                                  void* dc_prev, void* dwx, void* dwh, void* db, void* scratch,
                                  void* tickets, const void* plan, int plan_len, int rows,
                                  int in_size, int hidden, void* stream) {
    return launch_bwd_tc(wx, wh, x, h, c, c_new, act, dh, dc, dx, dh_prev, dc_prev, dwx, dwh, db,
                         scratch, tickets, plan, plan_len, rows, in_size, hidden, stream, false);
}

// K5's dx-only launch in bf16 at the presets' widths: dx, dh_prev and dc_prev
// only (kernels/lstm_cell.py:bwd_dx_tc_plan)
extern "C" int lstm_cell_bwd_dx_bf16(const void* wx, const void* wh, const void* c,
                                     const void* c_new, const void* act, const void* dh,
                                     const void* dc, void* dx, void* dh_prev, void* dc_prev,
                                     const void* plan, int plan_len, int rows, int in_size,
                                     int hidden, void* stream) {
    return launch_bwd_tc(wx, wh, nullptr, nullptr, c, c_new, act, dh, dc, dx, dh_prev, dc_prev,
                         nullptr, nullptr, nullptr, nullptr, nullptr, plan, plan_len, rows,
                         in_size, hidden, stream, true);
}

// The constants that kernels/lstm_cell.py sizes this kernel's launches by,
// and the plan's length, in the order of lstm_cell.py:_BWD_TC_CONSTANTS;
// writes up to n of them to out and returns how many there are.
extern "C" int repro_lstm_cell_bwd_tc_constants(int* out, int n) {
    const int values[] = {BWD_TC_WARPS, BWD_TC_MTILES, BWD_TC_CLUSTER, BWD_TC_TERMS, TC_PAD,
                          BWD_TC_COL_UNITS, BWD_TC_PLAN_LEN};
    const int count = static_cast<int>(sizeof(values) / sizeof(int));
    for (int i = 0; i < count && i < n; ++i) out[i] = values[i];
    return count;
}
