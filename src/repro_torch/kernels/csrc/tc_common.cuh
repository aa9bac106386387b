// Device helpers shared by the bf16 cell kernels on the tensor cores
// (lstm_cell_tc.cu: K3 and K4; lstm_cell_bwd_tc.cu: K5): ldmatrix and
// mma.sync m16n8k16 fragments, and the copies that stage a stream's rows or
// a contiguous run of it in shared memory (cp.async as wide as the stream
// allows) and store a run back.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TC_PAD = 8;        // bf16 of padding per staged row read by ldmatrix

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), d float
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e / d by a multiply, exact for e * d < 2^32 (d >= 1)
struct DivBy {
    unsigned long long m;
    __device__ explicit DivBy(unsigned d) : m((0x100000000ull + d - 1) / d) {}
    __device__ unsigned of(unsigned e) const { return static_cast<unsigned>((e * m) >> 32); }
};

// the word a copy of W bytes moves
template <int W> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// rows [0, nr) of a row-major stream (row_bytes a row, from src) into shared
// memory at dst (dst_stride bytes a row), W bytes a copy: cp.async for
// W = 4, 8 and 16, a 2-byte load and store for W = 2
// (by: division by the copies a row, row_bytes / W)
template <int W>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_stride,
                                           const unsigned char* src, int row_bytes, int nr,
                                           const DivBy& by) {
    const unsigned per_row = row_bytes / W;
    const unsigned n = nr * per_row;
    for (unsigned e = threadIdx.x; e < n; e += blockDim.x) {
        const unsigned r = by.of(e), off = (e - r * per_row) * W;
        unsigned char* to = dst + r * dst_stride + off;
        const unsigned char* from = src + static_cast<size_t>(r) * row_bytes + off;
        if constexpr (W == 2) {
            *reinterpret_cast<unsigned short*>(to) =
                __ldg(reinterpret_cast<const unsigned short*>(from));
        } else {
            __pipeline_memcpy_async(to, from, W);
        }
    }
}

__device__ __forceinline__ void stage_rows_by(int w, unsigned char* dst, int dst_stride,
                                              const unsigned char* src, int row_bytes, int nr,
                                              const DivBy& by) {
    if (w == 16) stage_rows<16>(dst, dst_stride, src, row_bytes, nr, by);
    else if (w == 8) stage_rows<8>(dst, dst_stride, src, row_bytes, nr, by);
    else if (w == 4) stage_rows<4>(dst, dst_stride, src, row_bytes, nr, by);
    else stage_rows<2>(dst, dst_stride, src, row_bytes, nr, by);
}

// a contiguous run of nbytes (even) from src into shared memory at dst: W
// bytes a copy by cp.async (W = 4, 8, 16), the rest by 2-byte loads
template <int W>
__device__ __forceinline__ void stage_run(unsigned char* dst, const unsigned char* src,
                                          int nbytes) {
    int done = 0;
    if constexpr (W > 2) {
        const int n = nbytes / W;
        for (int e = threadIdx.x; e < n; e += blockDim.x)
            __pipeline_memcpy_async(dst + e * W, src + e * W, W);
        done = n * W;
    }
    for (int e = done + 2 * static_cast<int>(threadIdx.x); e < nbytes; e += 2 * blockDim.x)
        *reinterpret_cast<unsigned short*>(dst + e) =
            __ldg(reinterpret_cast<const unsigned short*>(src + e));
}

__device__ __forceinline__ void stage_run_by(int w, unsigned char* dst, const unsigned char* src,
                                             int nbytes) {
    if (w == 16) stage_run<16>(dst, src, nbytes);
    else if (w == 8) stage_run<8>(dst, src, nbytes);
    else if (w == 4) stage_run<4>(dst, src, nbytes);
    else stage_run<2>(dst, src, nbytes);
}

// a contiguous run of nbytes (even) from shared memory at src to dst, W
// bytes a store, the rest 2 bytes a store
template <int W>
__device__ __forceinline__ void store_run(unsigned char* dst, const unsigned char* src,
                                          int nbytes) {
    using V = typename Word<W>::type;
    const int n = nbytes / W;
    for (int e = threadIdx.x; e < n; e += blockDim.x)
        *reinterpret_cast<V*>(dst + e * W) = *reinterpret_cast<const V*>(src + e * W);
    for (int e = n * W + 2 * static_cast<int>(threadIdx.x); e < nbytes; e += 2 * blockDim.x)
        *reinterpret_cast<unsigned short*>(dst + e) =
            *reinterpret_cast<const unsigned short*>(src + e);
}

__device__ __forceinline__ void store_run_by(int w, void* dst, const unsigned char* src,
                                             int nbytes) {
    unsigned char* d = static_cast<unsigned char*>(dst);
    if (w == 16) store_run<16>(d, src, nbytes);
    else if (w == 8) store_run<8>(d, src, nbytes);
    else if (w == 4) store_run<4>(d, src, nbytes);
    else store_run<2>(d, src, nbytes);
}

}  // namespace
