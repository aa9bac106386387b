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
// bytes of row traffic (K4: 4H more floats per row), so a well-fed kernel
// sits near the fp32 CUDA-core rate at large B; the (B, 4H) gates are never
// written to device memory (K4 writes their activations, which K5 needs).
// Design (simple first; tensor cores and a fused time loop come later):
// * one thread per (row, hidden unit j): it forms the four gate dots of unit
//   j over I + H in fp32 registers, then does the cell update, and writes
//   only h' and c' (and, in K4, the four activations of unit j);
// * neighbouring threads take neighbouring j, so the weight reads
//   W[k, gate * H + j] are coalesced; the weights ((I + H) * 4H * 4 bytes,
//   51,200 B at quarterly width, above the 48 KB static shared-memory limit)
//   are read through the read-only L1 path (__ldg), where every block of the
//   grid finds them after the first touch;
// * the x and h row values are the same for the H threads of a row and come
//   from L1 as broadcasts.
// The sigmoid and tanh are the IEEE-accurate expf/tanhf (no fast math).
//
// K5 is described above its kernels, further down.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

template <bool WITH_ACT>
__global__ void lstm_cell_kernel(const float* __restrict__ wx,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ b,
                                 const float* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 float* __restrict__ h_out,
                                 float* __restrict__ c_out,
                                 float* __restrict__ act,
                                 int rows, int in_size, int hidden) {
    const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= static_cast<long>(rows) * hidden) return;
    const long row = idx / hidden;
    const int j = static_cast<int>(idx - row * hidden);
    const int g4 = 4 * hidden;

    float gi = 0.0f, gf = 0.0f, gg = 0.0f, go = 0.0f;
    const float* xr = x + row * in_size;
    for (int k = 0; k < in_size; ++k) {
        const float v = __ldg(xr + k);
        const float* w = wx + static_cast<long>(k) * g4 + j;
        gi = fmaf(v, __ldg(w), gi);
        gf = fmaf(v, __ldg(w + hidden), gf);
        gg = fmaf(v, __ldg(w + 2 * hidden), gg);
        go = fmaf(v, __ldg(w + 3 * hidden), go);
    }
    const float* hr = h + row * hidden;
    for (int k = 0; k < hidden; ++k) {
        const float v = __ldg(hr + k);
        const float* w = wh + static_cast<long>(k) * g4 + j;
        gi = fmaf(v, __ldg(w), gi);
        gf = fmaf(v, __ldg(w + hidden), gf);
        gg = fmaf(v, __ldg(w + 2 * hidden), gg);
        go = fmaf(v, __ldg(w + 3 * hidden), go);
    }
    gi += __ldg(b + j);
    gf += __ldg(b + hidden + j);
    gg += __ldg(b + 2 * hidden + j);
    go += __ldg(b + 3 * hidden + j);

    const float si = sigmoidf(gi), sf = sigmoidf(gf), tg = tanhf(gg), so = sigmoidf(go);
    const float c_new = sf * c[idx] + si * tg;
    c_out[idx] = c_new;
    h_out[idx] = so * tanhf(c_new);
    if (WITH_ACT) {
        float* ar = act + row * g4 + j;
        ar[0] = si;
        ar[hidden] = sf;
        ar[2 * hidden] = tg;
        ar[3 * hidden] = so;
    }
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

int launch_cell(bool with_act, const void* wx, const void* wh, const void* b,
                const void* x, const void* h, const void* c, void* h_out,
                void* c_out, void* act, int rows, int in_size, int hidden,
                int block, void* stream) {
    const long threads = static_cast<long>(rows) * hidden;
    const unsigned grid = static_cast<unsigned>((threads + block - 1) / block);
    auto kernel = with_act ? lstm_cell_kernel<true> : lstm_cell_kernel<false>;
    kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(wx), static_cast<const float*>(wh),
        static_cast<const float*>(b), static_cast<const float*>(x),
        static_cast<const float*>(h), static_cast<const float*>(c),
        static_cast<float*>(h_out), static_cast<float*>(c_out),
        static_cast<float*>(act), rows, in_size, hidden);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lstm_cell_f32(const void* wx, const void* wh, const void* b,
                             const void* x, const void* h, const void* c,
                             void* h_out, void* c_out,
                             int rows, int in_size, int hidden, int block,
                             void* stream) {
    return launch_cell(false, wx, wh, b, x, h, c, h_out, c_out, nullptr,
                       rows, in_size, hidden, block, stream);
}

extern "C" int lstm_cell_fwd_f32(const void* wx, const void* wh, const void* b,
                                 const void* x, const void* h, const void* c,
                                 void* h_out, void* c_out, void* act,
                                 int rows, int in_size, int hidden, int block,
                                 void* stream) {
    return launch_cell(true, wx, wh, b, x, h, c, h_out, c_out, act,
                       rows, in_size, hidden, block, stream);
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
