// K3: fused LSTM cell (inference forward), fp32, sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lstm_cell.py:_lstm_kernel.
//
//   gates = x . Wx + h . Wh + b          (B, 4H), gate order i, f, g, o
//   c'    = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h'    = sigmoid(o) * tanh(c')
//
// Shapes: wx (I, 4H), wh (H, 4H), b (4H,), x (B, I), h and c (B, H) in,
// h' and c' (B, H) out; all contiguous fp32, in the JAX orientation.
//
// Bound on the card: at the ES-RNN widths (I + H <= 100, H <= 50) the gate
// product does 2 * (I + H) * 4H flops per row against 4 * (I + 4H) bytes of
// row traffic, so a well-fed kernel sits near the fp32 CUDA-core rate at
// large B; the (B, 4H) gates are never written to device memory.
// Design (simple first; tensor cores and a fused time loop come later):
// * one thread per (row, hidden unit j): it forms the four gate dots of unit
//   j over I + H in fp32 registers, then does the cell update, and writes
//   only h' and c';
// * neighbouring threads take neighbouring j, so the weight reads
//   W[k, gate * H + j] are coalesced; the weights ((I + H) * 4H * 4 bytes,
//   51,200 B at quarterly width, above the 48 KB static shared-memory limit)
//   are read through the read-only L1 path (__ldg), where every block of the
//   grid finds them after the first touch;
// * the x and h row values are the same for the H threads of a row and come
//   from L1 as broadcasts.
// The sigmoid and tanh are the IEEE-accurate expf/tanhf (no fast math).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

__global__ void lstm_cell_kernel(const float* __restrict__ wx,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ b,
                                 const float* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 float* __restrict__ h_out,
                                 float* __restrict__ c_out,
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

    const float c_new = sigmoidf(gf) * c[idx] + sigmoidf(gi) * tanhf(gg);
    c_out[idx] = c_new;
    h_out[idx] = sigmoidf(go) * tanhf(c_new);
}

}  // namespace

extern "C" int lstm_cell_f32(const void* wx, const void* wh, const void* b,
                             const void* x, const void* h, const void* c,
                             void* h_out, void* c_out,
                             int rows, int in_size, int hidden, int block,
                             void* stream) {
    const long threads = static_cast<long>(rows) * hidden;
    const long grid = (threads + block - 1) / block;
    lstm_cell_kernel<<<static_cast<unsigned>(grid), block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(wx), static_cast<const float*>(wh),
        static_cast<const float*>(b), static_cast<const float*>(x),
        static_cast<const float*>(h), static_cast<const float*>(c),
        static_cast<float*>(h_out), static_cast<float*>(c_out),
        rows, in_size, hidden);
    return static_cast<int>(cudaGetLastError());
}
