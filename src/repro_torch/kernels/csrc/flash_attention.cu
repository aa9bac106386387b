// K6: GQA flash attention (forward), bf16 on the tensor cores and fp32 on
// the CUDA cores, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:_flash_kernel (called at :108).
//
// For q (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D), all contiguous, query head
// h reads kv head h / (Hq / Hkv) (GQA as an index map: K/V heads are never
// repeated in memory). Per query row, over the keys in tiles:
//   s      = (q . k^T) * scale                                  fp32
//   s      = -1e30 where causal and k_idx > q_idx + (Tk - Tq)   end-aligned
//   m_new  = max(m, rowmax(s));  p = exp(s - m_new);  c = exp(m - m_new)
//   l      = c * l + rowsum(p)                                  fp32
//   acc    = c * acc + (p cast to v's type) . v                 fp32
//   o      = acc / max(l, 1e-30), in q's type
// which is what _flash_kernel computes with (m, l, acc) in VMEM scratch.
//
// Bound on the card: operations. At the LM serve path's shape (B = 8, Hq =
// 32, Hkv = 4, Tq = Tk = 2048, D = 128, bf16, causal) the kernel must do
// 2 * 2 * B * Hq * Tq * Tk * D / 2 = 2.7e11 flops (0.28 ms at 989 TFLOP/s)
// and move q, k, v and o once, 0.30 GB (0.09 ms at 3.35 TB/s).
//
// Design. On the TPU the key loop is the sequential third grid axis; CUDA
// blocks run in no order, so here one block owns one (batch * q head, query
// tile) and walks the key tiles itself, carrying (m, l, acc) in registers:
// the (Tq, Tk) scores never reach device memory. Key tiles are staged in
// shared memory and shared by the block's warps. Ragged Tq and Tk are
// masked in the kernel (rows past Tq are not stored; keys past Tk load as
// zeros and score -1e30), so nothing is padded. Under the causal mask the
// block stops after the last key tile its last row can see (the skipped
// tiles would add exactly nothing), and tiles are issued longest first.
// * bf16 (D = 64 or 128): 4 warps x 16 query rows, 64-key tiles. Both
//   products run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Each
//   warp keeps its Q fragments in registers for the whole key loop; the
//   score accumulators become, after the softmax and the cast to bf16, the
//   A fragments of the P.V product without leaving registers (the
//   accumulator layout of m16n8 matches the A layout of m16n8k16). K and V
//   tiles sit row-major in shared memory with rows padded by 16 bytes, so
//   the fragment loads are free of bank conflicts.
// * fp32 (D <= 128): 4 warps x 4 query rows, 32-key tiles; lane j scores
//   key j against the warp's rows (the K tile padded to D + 1 floats a row),
//   the row max and sum go through warp shuffles, and each lane accumulates
//   D / 32 output columns. fp32 products stay off the tensor cores (TF32
//   would cost digits the fp32 path is held to).
// No --use_fast_math: expf and the division are IEEE, as in the plain
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;     // query rows per block (16 per warp)
constexpr int MMA_BK = 64;     // keys per tile
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, round to nearest even; `lo` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
           | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4, t = lane % 4:
//   A (16 x 16, row): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                     a3 = (g+8, 2t+8..)
//   B (16 x 8, col):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int hq, int hkv, int tq, int tk, float scale, int causal) {
    constexpr int LD = D + 8;                 // shared row stride, in bf16
    constexpr int KSTEPS = D / 16;            // k-steps of the Q.K^T product
    constexpr int NT_S = MMA_BK / 8;          // 8-key column tiles of a score tile
    constexpr int NT_O = D / 8;               // 8-wide column tiles of the output
    __shared__ __align__(16) __nv_bfloat16 ks[MMA_BK * LD];
    __shared__ __align__(16) __nv_bfloat16 vs[MMA_BK * LD];

    const int bh = blockIdx.x;                              // b * hq + h
    const int b = bh / hq, h = bh % hq;
    const int kvh = h / (hq / hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;  // longest tiles first
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int offset = tk - tq;
    const __nv_bfloat16* qp = q + static_cast<long>(bh) * tq * D;
    const __nv_bfloat16* kp = k + (static_cast<long>(b) * hkv + kvh) * tk * D;
    const __nv_bfloat16* vp = v + (static_cast<long>(b) * hkv + kvh) * tk * D;
    const int row0 = q0 + warp * 16 + g;                    // and row0 + 8

    // this thread's Q fragments, for the whole key loop (rows past Tq: 0)
    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = row0 + (r & 1) * 8;
            const int col = kk * 16 + t4 * 2 + (r >> 1) * 8;
            qf[kk][r] = row < tq
                ? *reinterpret_cast<const uint32_t*>(qp + static_cast<long>(row) * D + col)
                : 0u;
        }
    }

    float acc[NT_O][4];
#pragma unroll
    for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};

    const int kv_end = causal ? min(tk, q0 + MMA_BQ + offset) : tk;
    for (int kv0 = 0; kv0 < kv_end; kv0 += MMA_BK) {
        __syncthreads();                      // the previous tile is consumed
        for (int c = threadIdx.x; c < MMA_BK * D / 8; c += MMA_THREADS) {
            const int r = c / (D / 8), col = (c % (D / 8)) * 8;
            uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
            if (kv0 + r < tk) {
                const long at = static_cast<long>(kv0 + r) * D + col;
                kv4 = *reinterpret_cast<const uint4*>(kp + at);
                vv4 = *reinterpret_cast<const uint4*>(vp + at);
            }
            *reinterpret_cast<uint4*>(ks + r * LD + col) = kv4;
            *reinterpret_cast<uint4*>(vs + r * LD + col) = vv4;
        }
        __syncthreads();

        // s = q . k^T for this warp's 16 rows x 64 keys
        float s[NT_S][4];
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
            for (int nt = 0; nt < NT_S; ++nt) {
                const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
                mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                         *reinterpret_cast<const uint32_t*>(kr + 8));
            }
        }

        // scale, mask, online softmax; rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = row0 + hr * 8;
            float mx = NEG_INF;
#pragma unroll
            for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int key = kv0 + nt * 8 + t4 * 2 + e;
                    const bool ok = key < tk && (!causal || key <= row + offset);
                    const float x = ok ? s[nt][hr * 2 + e] * scale : NEG_INF;
                    s[nt][hr * 2 + e] = x;
                    mx = fmaxf(mx, x);
                }
            }
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
            const float m_new = fmaxf(m[hr], mx);
            const float corr = expf(m[hr] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float p = expf(s[nt][hr * 2 + e] - m_new);
                    s[nt][hr * 2 + e] = p;
                    sum += p;
                }
            }
            sum += __shfl_xor_sync(FULL, sum, 1);
            sum += __shfl_xor_sync(FULL, sum, 2);
            l[hr] = corr * l[hr] + sum;
            m[hr] = m_new;
#pragma unroll
            for (int i = 0; i < NT_O; ++i) {
                acc[i][hr * 2] *= corr;
                acc[i][hr * 2 + 1] *= corr;
            }
        }

        // acc += bf16(p) . v: the score accumulators are the A fragments
#pragma unroll
        for (int kk = 0; kk < MMA_BK / 16; ++kk) {
            const uint32_t a[4] = {
                pack_f32(s[2 * kk][0], s[2 * kk][1]), pack_f32(s[2 * kk][2], s[2 * kk][3]),
                pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int i = 0; i < NT_O; ++i) {
                const __nv_bfloat16* vr = vs + (kk * 16 + t4 * 2) * LD + i * 8 + g;
                mma_bf16(acc[i], a, pack_bf16(vr[0], vr[LD]),
                         pack_bf16(vr[8 * LD], vr[9 * LD]));
            }
        }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + hr * 8;
        if (row >= tq) continue;
        const float denom = fmaxf(l[hr], 1e-30f);
        __nv_bfloat16* orow = o + (static_cast<long>(bh) * tq + row) * D + t4 * 2;
#pragma unroll
        for (int i = 0; i < NT_O; ++i) {
            *reinterpret_cast<uint32_t*>(orow + i * 8) =
                pack_f32(acc[i][hr * 2] / denom, acc[i][hr * 2 + 1] / denom);
        }
    }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int S_ROWS = 4;                // query rows per warp
constexpr int S_WARPS = 4;
constexpr int S_BQ = S_ROWS * S_WARPS;   // query rows per block
constexpr int S_BK = 32;                 // keys per tile: one per lane
constexpr int S_DMAX = 128;
constexpr int S_THREADS = 32 * S_WARPS;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, w));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) x += __shfl_xor_sync(FULL, x, w);
    return x;
}

__global__ void __launch_bounds__(S_THREADS)
flash_simt_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               int hq, int hkv, int tq, int tk, int d, float scale, int causal) {
    __shared__ float qs[S_BQ][S_DMAX];
    __shared__ float ks[S_BK][S_DMAX + 1];   // lane j reads row j: no conflicts
    __shared__ float vs[S_BK][S_DMAX];

    const int bh = blockIdx.x;
    const int b = bh / hq, h = bh % hq;
    const int kvh = h / (hq / hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * S_BQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int offset = tk - tq;
    const float* qp = q + static_cast<long>(bh) * tq * d;
    const float* kp = k + (static_cast<long>(b) * hkv + kvh) * tk * d;
    const float* vp = v + (static_cast<long>(b) * hkv + kvh) * tk * d;

    for (int i = threadIdx.x; i < S_BQ * d; i += S_THREADS) {
        const int r = i / d, c = i % d;
        qs[r][c] = q0 + r < tq ? qp[static_cast<long>(q0 + r) * d + c] : 0.f;
    }
    const int r0 = warp * S_ROWS;            // the warp's first row in the block
    float m[S_ROWS], l[S_ROWS], acc[S_ROWS][S_DMAX / 32];
#pragma unroll
    for (int r = 0; r < S_ROWS; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < S_DMAX / 32; ++i) acc[r][i] = 0.f;
    }

    const int kv_end = causal ? min(tk, q0 + S_BQ + offset) : tk;
    for (int kv0 = 0; kv0 < kv_end; kv0 += S_BK) {
        __syncthreads();
        for (int i = threadIdx.x; i < S_BK * d; i += S_THREADS) {
            const int r = i / d, c = i % d;
            const bool in = kv0 + r < tk;
            const long at = static_cast<long>(kv0 + r) * d + c;
            ks[r][c] = in ? kp[at] : 0.f;
            vs[r][c] = in ? vp[at] : 0.f;
        }
        __syncthreads();

        float s[S_ROWS];
#pragma unroll
        for (int r = 0; r < S_ROWS; ++r) s[r] = 0.f;
        for (int c = 0; c < d; ++c) {
            const float kc = ks[lane][c];
#pragma unroll
            for (int r = 0; r < S_ROWS; ++r) s[r] = fmaf(qs[r0 + r][c], kc, s[r]);
        }
        const int key = kv0 + lane;
#pragma unroll
        for (int r = 0; r < S_ROWS; ++r) {
            const int row = q0 + r0 + r;
            const bool ok = key < tk && (!causal || key <= row + offset);
            const float x = ok ? s[r] * scale : NEG_INF;
            const float m_new = fmaxf(m[r], warp_max(x));
            const float p = expf(x - m_new);
            const float corr = expf(m[r] - m_new);
            l[r] = corr * l[r] + warp_sum(p);
            m[r] = m_new;
            float part[S_DMAX / 32];
#pragma unroll
            for (int i = 0; i < S_DMAX / 32; ++i) part[i] = 0.f;
            for (int j = 0; j < S_BK; ++j) {
                const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
                for (int i = 0; i < S_DMAX / 32; ++i) {
                    const int c = lane + 32 * i;
                    if (c < d) part[i] = fmaf(pj, vs[j][c], part[i]);
                }
            }
#pragma unroll
            for (int i = 0; i < S_DMAX / 32; ++i) acc[r][i] = acc[r][i] * corr + part[i];
        }
    }

#pragma unroll
    for (int r = 0; r < S_ROWS; ++r) {
        const int row = q0 + r0 + r;
        if (row >= tq) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        float* orow = o + (static_cast<long>(bh) * tq + row) * d;
#pragma unroll
        for (int i = 0; i < S_DMAX / 32; ++i) {
            const int c = lane + 32 * i;
            if (c < d) orow[c] = acc[r][i] / denom;
        }
    }
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int batch, int hq, int hkv, int tq, int tk, int d,
                                    int causal, float scale, void* stream) {
    const dim3 grid(batch * hq, (tq + MMA_BQ - 1) / MMA_BQ);
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(o);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d == 128) {
        flash_mma_bf16<128><<<grid, MMA_THREADS, 0, s>>>(qb, kb, vb, ob, hq, hkv, tq, tk,
                                                       scale, causal);
    } else if (d == 64) {
        flash_mma_bf16<64><<<grid, MMA_THREADS, 0, s>>>(qb, kb, vb, ob, hq, hkv, tq, tk,
                                                      scale, causal);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int batch, int hq, int hkv, int tq, int tk, int d,
                                   int causal, float scale, void* stream) {
    if (d < 1 || d > S_DMAX) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(batch * hq, (tq + S_BQ - 1) / S_BQ);
    flash_simt_f32<<<grid, S_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, tq, tk, d,
        scale, causal);
    return static_cast<int>(cudaGetLastError());
}
