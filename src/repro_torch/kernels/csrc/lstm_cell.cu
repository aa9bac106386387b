// K3: fused LSTM cell (inference forward), K4: the same forward that also
// writes the gate activations, and K5: its backward; fp32, sm_90a.
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
// Design of K3 (lstm_cell_smem<false>) and K4 (<true>): the kernel must be
// bound by FMAs, not by the loads that feed them.
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
// K5 is described above its kernels, further down.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

constexpr int CELL_GROUPS = 8;     // row groups of threads per block
constexpr int CELL_BIG_TILES = 3;  // 64-row tiles per SM from which 8 rows per thread pay
constexpr int CELL_PAD = 4;        // floats of padding per staged input row
constexpr int CELL_LOADS = 8;      // global loads a thread keeps in flight while staging

template <bool WITH_ACT, int CELL_R>
__global__ void lstm_cell_smem(const float* __restrict__ wx,
                               const float* __restrict__ wh,
                               const float* __restrict__ b,
                               const float* __restrict__ x,
                               const float* __restrict__ h,
                               const float* __restrict__ c,
                               float* __restrict__ h_out,
                               float* __restrict__ c_out,
                               float* __restrict__ act,
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
                const float* src = k < in_size ? wx + static_cast<long>(k) * g4 + j
                                               : wh + static_cast<long>(k - in_size) * g4 + j;
                w[u] = make_float4(__ldg(src), __ldg(src + hidden), __ldg(src + 2 * hidden),
                                   __ldg(src + 3 * hidden));
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
    const float bi = __ldg(b + j), bf = __ldg(b + hidden + j);
    const float bg = __ldg(b + 2 * hidden + j), bo = __ldg(b + 3 * hidden + j);
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
            c_in[r] = active && lr < nr ? __ldg(c + (row0 + lr) * hidden + j) : 0.0f;
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
                    v[u] = k < in_size ? __ldg(x + (row0 + r) * in_size + k)
                                       : __ldg(h + (row0 + r) * hidden + (k - in_size));
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
            c_out[idx] = c_new;
            h_out[idx] = so * tanhf(c_new);
            if (WITH_ACT) {
                float* ar = act + (row0 + lr) * g4 + j;
                ar[0] = si;
                ar[hidden] = sf;
                ar[2 * hidden] = tg;
                ar[3 * hidden] = so;
            }
        }
    }
}

template <bool WITH_ACT, int CELL_R>
int launch_cell_tiles(const void* wx, const void* wh, const void* b, const void* x,
                      const void* h, const void* c, void* h_out, void* c_out, void* act,
                      int rows, int in_size, int hidden, int sm_count, cudaStream_t stream) {
    static size_t smem_opted = 0;
    const int block_groups = std::min(CELL_GROUPS, 1024 / hidden);
    if (block_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = block_groups * hidden;
    // rows per tile: the block's full block_groups * CELL_R once there are
    // enough rows for a tile on every SM; fewer (down to CELL_R) below that
    const long want = (static_cast<long>(rows) + CELL_R * sm_count - 1) / (CELL_R * sm_count);
    const int groups =
        static_cast<int>(std::min(static_cast<long>(block_groups), std::max(1L, want)));
    const int kw = in_size + hidden;
    const size_t smem = sizeof(float) * (static_cast<size_t>(kw) * 4 * hidden
                                         + static_cast<size_t>(kw) * (groups * CELL_R + CELL_PAD));
    auto kernel = lstm_cell_smem<WITH_ACT, CELL_R>;
    if (smem > smem_opted) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_opted = smem;
    }
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long tile = static_cast<long>(groups) * CELL_R;
    const long n_tiles = (rows + tile - 1) / tile;
    const unsigned grid = static_cast<unsigned>(
        std::min(n_tiles, static_cast<long>(per_sm) * sm_count));
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const float*>(wx), static_cast<const float*>(wh),
        static_cast<const float*>(b), static_cast<const float*>(x),
        static_cast<const float*>(h), static_cast<const float*>(c),
        static_cast<float*>(h_out), static_cast<float*>(c_out),
        static_cast<float*>(act), rows, in_size, hidden, groups);
    return static_cast<int>(cudaGetLastError());
}

// 4 rows per thread up to CELL_BIG_TILES full 64-row tiles per SM (more
// blocks, shorter chains), 8 above (fewer shared-memory reads per FMA); the
// sums, and so the results, are the same either way
template <bool WITH_ACT>
int launch_cell_smem(const void* wx, const void* wh, const void* b, const void* x,
                     const void* h, const void* c, void* h_out, void* c_out, void* act,
                     int rows, int in_size, int hidden, void* stream) {
    static int sm_count = 0;
    if (sm_count == 0) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (rows <= static_cast<long>(CELL_BIG_TILES) * 64 * sm_count)
        return launch_cell_tiles<WITH_ACT, 4>(wx, wh, b, x, h, c, h_out, c_out, act, rows,
                                              in_size, hidden, sm_count, st);
    return launch_cell_tiles<WITH_ACT, 8>(wx, wh, b, x, h, c, h_out, c_out, act, rows,
                                          in_size, hidden, sm_count, st);
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
// Bound on the card: operations at large B. Per row the three products do
// 2 * 4H * (I + H) flops each (dx + dh_prev, and the weight gradients), the
// gate algebra a few dozen; the row traffic is 4 * (I + 8H + 4H) bytes.
//
// The TPU kernel sums dWx/dWh/db over the batch into one output block that
// every (sequential) grid step revisits. CUDA blocks run concurrently, so
// the sum is split into two kernels with a fixed order, and no float
// atomics: two runs on the same inputs give bit-identical weight gradients.
// * lstm_bwd_rows: one block per tile of tile_rows rows (the wrapper picks
//   it; the tile lives in dynamic shared memory). Its threads
//   first form the tile's gate cotangents one per (row, unit), into shared
//   memory (row stride 4H + 1, so the column reads below hit distinct
//   banks), and write dc_prev; then dx and dh_prev one per (row, k),
//   contracting 4H against the weight row W[k, :] (read through L1, the
//   same address across a warp); then the tile's partial weight gradient
//   one per (k, gate column), summing its rows in order, into its own slice
//   of a (tiles, I + H + 1, 4H) scratch (row I + H is db).
// * lstm_bwd_reduce: one thread per weight-gradient element sums the tiles'
//   partials in tile order.

__global__ void lstm_bwd_rows(const float* __restrict__ wx,
                              const float* __restrict__ wh,
                              const float* __restrict__ x,
                              const float* __restrict__ h,
                              const float* __restrict__ c,
                              const float* __restrict__ c_new,
                              const float* __restrict__ act,
                              const float* __restrict__ dh,
                              const float* __restrict__ dc,
                              float* __restrict__ dx,
                              float* __restrict__ dh_prev,
                              float* __restrict__ dc_prev,
                              float* __restrict__ partial,
                              int rows, int in_size, int hidden, int tile_rows) {
    extern __shared__ float smem[];
    const int g4 = 4 * hidden;
    const int stride = g4 + 1;                  // padded row of dgates
    const int kw = in_size + hidden;            // x | h
    float* dgs = smem;                          // [tile_rows][4H + 1]
    float* xhs = smem + tile_rows * stride;     // [tile_rows][I + H]
    const long row0 = static_cast<long>(blockIdx.x) * tile_rows;
    const int nr = static_cast<int>(min(static_cast<long>(tile_rows), rows - row0));

    // 1. gate cotangents and dc_prev, one per (row, unit); x | h to smem
    for (int e = threadIdx.x; e < nr * hidden; e += blockDim.x) {
        const int r = e / hidden, j = e - (e / hidden) * hidden;
        const long at = (row0 + r) * hidden + j;
        const float* ar = act + (row0 + r) * g4 + j;
        const float si = ar[0], sf = ar[hidden], tg = ar[2 * hidden], so = ar[3 * hidden];
        const float tc = tanhf(c_new[at]);
        const float dh_v = dh[at];
        const float dct = dc[at] + dh_v * so * (1.0f - tc * tc);
        float* dr = dgs + r * stride + j;
        dr[0] = dct * tg * si * (1.0f - si);
        dr[hidden] = dct * c[at] * sf * (1.0f - sf);
        dr[2 * hidden] = dct * si * (1.0f - tg * tg);
        dr[3 * hidden] = dh_v * tc * so * (1.0f - so);
        dc_prev[at] = dct * sf;
    }
    for (int e = threadIdx.x; e < nr * kw; e += blockDim.x) {
        const int r = e / kw, k = e - (e / kw) * kw;
        xhs[r * kw + k] = k < in_size ? x[(row0 + r) * in_size + k]
                                      : h[(row0 + r) * hidden + (k - in_size)];
    }
    __syncthreads();

    // 2. dx and dh_prev, one per (row, k): contract 4H against W[k, :];
    //    r runs fastest, so a warp reads one weight address (a broadcast)
    for (int e = threadIdx.x; e < nr * kw; e += blockDim.x) {
        const int k = e / nr, r = e - (e / nr) * nr;
        const float* w = k < in_size ? wx + static_cast<long>(k) * g4
                                     : wh + static_cast<long>(k - in_size) * g4;
        const float* dr = dgs + r * stride;
        float acc = 0.0f;
        for (int g = 0; g < g4; ++g) acc = fmaf(dr[g], __ldg(w + g), acc);
        if (k < in_size) dx[(row0 + r) * in_size + k] = acc;
        else dh_prev[(row0 + r) * hidden + (k - in_size)] = acc;
    }

    // 3. the tile's partial weight gradient, one per (k, gate column); the
    //    tile's rows are summed in order (k == I + H is the bias row)
    float* out = partial + static_cast<long>(blockIdx.x) * (kw + 1) * g4;
    for (int e = threadIdx.x; e < (kw + 1) * g4; e += blockDim.x) {
        const int k = e / g4, g = e - (e / g4) * g4;
        float acc = 0.0f;
        if (k < kw) {
            for (int r = 0; r < nr; ++r) acc = fmaf(xhs[r * kw + k], dgs[r * stride + g], acc);
        } else {
            for (int r = 0; r < nr; ++r) acc += dgs[r * stride + g];
        }
        out[e] = acc;
    }
}

__global__ void lstm_bwd_reduce(const float* __restrict__ partial,
                                float* __restrict__ dwx,
                                float* __restrict__ dwh,
                                float* __restrict__ db,
                                int tiles, int in_size, int hidden) {
    const int g4 = 4 * hidden;
    const long total = static_cast<long>(in_size + hidden + 1) * g4;
    const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (e >= total) return;
    float acc = 0.0f;
    for (int t = 0; t < tiles; ++t) acc += partial[t * total + e];
    const long split_x = static_cast<long>(in_size) * g4;
    const long split_h = split_x + static_cast<long>(hidden) * g4;
    if (e < split_x) dwx[e] = acc;
    else if (e < split_h) dwh[e - split_x] = acc;
    else db[e - split_h] = acc;
}

}  // namespace

extern "C" int lstm_cell_f32(const void* wx, const void* wh, const void* b,
                             const void* x, const void* h, const void* c,
                             void* h_out, void* c_out,
                             int rows, int in_size, int hidden, int block,
                             void* stream) {
    (void)block;                       // the kernel picks its own geometry
    return launch_cell_smem<false>(wx, wh, b, x, h, c, h_out, c_out, nullptr,
                                   rows, in_size, hidden, stream);
}

extern "C" int lstm_cell_fwd_f32(const void* wx, const void* wh, const void* b,
                                 const void* x, const void* h, const void* c,
                                 void* h_out, void* c_out, void* act,
                                 int rows, int in_size, int hidden, int block,
                                 void* stream) {
    (void)block;
    return launch_cell_smem<true>(wx, wh, b, x, h, c, h_out, c_out, act,
                                  rows, in_size, hidden, stream);
}

// scratch: (tiles, I + H + 1, 4H) floats, tiles = ceil(rows / tile_rows)
extern "C" int lstm_cell_bwd_f32(const void* wx, const void* wh, const void* x,
                                 const void* h, const void* c, const void* c_new,
                                 const void* act, const void* dh, const void* dc,
                                 void* dx, void* dh_prev, void* dc_prev,
                                 void* dwx, void* dwh, void* db, void* scratch,
                                 int rows, int in_size, int hidden, int tile_rows,
                                 int block, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tiles = (rows + tile_rows - 1) / tile_rows;
    const size_t smem = sizeof(float) * tile_rows
                        * static_cast<size_t>(4 * hidden + 1 + in_size + hidden);
    lstm_bwd_rows<<<tiles, block, smem, st>>>(
        static_cast<const float*>(wx), static_cast<const float*>(wh),
        static_cast<const float*>(x), static_cast<const float*>(h),
        static_cast<const float*>(c), static_cast<const float*>(c_new),
        static_cast<const float*>(act), static_cast<const float*>(dh),
        static_cast<const float*>(dc), static_cast<float*>(dx),
        static_cast<float*>(dh_prev), static_cast<float*>(dc_prev),
        static_cast<float*>(scratch), rows, in_size, hidden, tile_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long total = static_cast<long>(in_size + hidden + 1) * 4 * hidden;
    const unsigned grid = static_cast<unsigned>((total + block - 1) / block);
    lstm_bwd_reduce<<<grid, block, 0, st>>>(
        static_cast<const float*>(scratch), static_cast<float*>(dwx),
        static_cast<float*>(dwh), static_cast<float*>(db), tiles, in_size, hidden);
    return static_cast<int>(cudaGetLastError());
}
