// K6: GQA flash attention (forward), bf16 on the tensor cores and fp32 on
// the CUDA cores, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:_flash_kernel (called at :108).
//
// For q (B, Hq, Tq, D), k (B, Hkv, Tk, D) and v (B, Hkv, Tk, DV), all
// contiguous, with DV <= D (MLA: q . k 192 wide, v 128; every other model
// DV = D), query head h reads kv head h / (Hq / Hkv) (GQA as an index map:
// K/V heads are never repeated in memory); o is (B, Hq, Tq, DV). Per query
// row, over the keys in tiles:
//   s      = (q . k^T) * scale                                  fp32
//   s      = -1e30 where causal and k_idx > q_idx + (Tk - Tq)   end-aligned
//   m_new  = max(m, rowmax(s));  p = exp(s - m_new);  c = exp(m - m_new)
//   l      = c * l + rowsum(p)                                  fp32
//   acc    = c * acc + (p cast to v's type) . v                 fp32
//   o      = acc / max(l, 1e-30), in q's type
// which is what _flash_kernel computes with (m, l, acc) in VMEM scratch.
//
// Bound on the card: operations. At the LM serve path's shape (B = 8, Hq =
// 32, Hkv = 4, Tq = Tk = 2048, D = DV = 128, bf16, causal) the kernel must
// do 2 * B * Hq * (D + DV) * Tq * Tk / 2 = 2.7e11 flops (0.28 ms at 989
// TFLOP/s) and move q, k, v and o once, 0.30 GB (0.09 ms at 3.35 TB/s); at
// deepseek-v2-lite's MLA prefill (B = 8, Hq = Hkv = 16, T = 2048, D = 192,
// DV = 128) 1.72e11 flops (0.174 ms) against 0.34 GB (0.100 ms). The decode
// route is bound by bytes: at whisper's cross-attention decode step (B = 8,
// Hq = Hkv = 8, Tq = 1, Tk = 1500, D = DV = 64) k and v are 24.6 MB (0.0073
// ms at 3.35 TB/s) against 2.5e7 flops.
//
// Design. On the TPU the key loop is the sequential third grid axis; CUDA
// blocks run in no order, so here one block owns one (batch * q head, query
// tile) and walks the key tiles itself, carrying (m, l, acc) in registers:
// the (Tq, Tk) scores never reach device memory. Ragged Tq and Tk are
// masked in the kernel, so nothing is padded. Under the causal mask the
// block stops after the last key tile its last row can see (the skipped
// tiles would add exactly nothing), and tiles are issued longest first.
// * bf16, flash_tc_bf16<D, DV, HD> at (D, DV) = (128, 128) and (192, 128),
//   and at head dim 80 on the (128, 128) tile (below): 128 query
//   rows per block, 128-key tiles, three warpgroups. The
//   producer warpgroup gives up registers (setmaxnreg) and one of its
//   threads issues TMA loads: Q once, then K
//   and V tiles into a 2-stage ring guarded by full/empty mbarriers. The
//   two consumer warpgroups (64 query rows each, registers raised) run
//   S = Q . K^T as wgmma m64n128k16 with both operands in shared memory,
//   then the online softmax in registers, then O += P . V as wgmma with P
//   in registers: the fp32 score accumulators, cast to bf16x2 in place,
//   are the A fragments (the m64nN accumulator layout is the register-A
//   layout), and V is read in its [key][d] layout through the descriptor's
//   transpose bit. The tensor maps are 3-D (D or DV, T, B * H), so TMA
//   zero-fills keys past Tk and query rows past Tq per head; all tiles use
//   the 128-byte swizzle (a row is D / 64 or DV / 64 boxes of 64 elements),
//   and the wgmma descriptors describe the same layout. Q and K tiles are D
//   wide, V tiles DV wide: S = Q . K^T takes D / 16 k-steps, O and P . V are
//   DV wide. The mask runs only on tiles that cross the diagonal or Tk; exp2
//   with scale * log2(e) folded in. Shared memory (TcSmem): Q + 2 K + 2 V
//   tiles, 160 KB at D = DV = 128, 208 KB at (192, 128), under the 227 KB
//   a block may opt into. ptxas -v (sm_90a) reports, for each of
//   <128, 128> and <192, 128>: 168 registers, 0 bytes of stack
//   and spills (the __launch_bounds__ ceiling; setmaxnreg then moves them
//   to 40 for the producer and 232 for the consumers). D = 192 adds k-steps
//   to S = Q . K^T, not registers: acc stays DV / 2 = 64 floats.
// * bf16 at (64, 64), flash_tc_bf16_overlap: the same tiles, TMA, wgmma and
//   swizzle, with the consumers rescheduled. At D = 64 a 128 x 128 tile's
//   wgmma work (4.2 MFLOP, ~1,024 cycles of an SM's tensor cores) costs
//   about as much as its 16,384 exp2 on the SM's 16 MUFU lanes a cycle, so
//   a schedule that runs GEMM, softmax and GEMM in lockstep leaves the
//   tensor cores idle through every softmax. Here (a) within a warpgroup,
//   S_j = Q . K_j^T and P_{j-1} . V_{j-1} are issued together as two
//   commit groups; wgmma.wait_group 1 returns with S_j and the softmax of
//   tile j runs under P_{j-1} . V_{j-1}; (b) the two consumer warpgroups
//   take turns to issue (named barriers 1 and 2 over their 256 threads:
//   pingpong), so one's softmax also runs under the other's products; (c)
//   the K/V ring is 4 stages deep (16 KB of Q + 4 x 32 KB), K and V stages
//   freed apart. p = exp2(s * scale * log2(e) - m) is one fma and one
//   MUFU ex2 (the row max is taken over the raw scores: the wrapper takes
//   scale >= 0), the row's max and sum in 4 partial chains, the mask only
//   on tiles that cross the diagonal or Tk (a branch a tile). The
//   softmax's results are tied (empty asm) before wait_group 0 in program
//   order: an earlier build put that wait ahead of most of the softmax,
//   which lost (a). On the H100 (a) then measured no faster than (b)
//   alone. The kernel still runs at about 3.2-3.6x its operations bound
//   at whisper's and granite's shapes (`chip_smoke.py --k6`): the MUFU's
//   exp2 (16 a cycle an SM) costs as much as the tile's wgmma, and one
//   block an SM (registers) leaves two consumer warps a scheduler to hide
//   the softmax's latency.
// * bf16 decode, flash_decode_bf16 + flash_decode_combine, for a few query
//   rows over many keys (G * Tq <= 16 rows a kv head at (64, 64): whisper's
//   cross-attention at Tq = 1). The 128-row wgmma tile would be 127/128
//   padding there, and one block per head would walk all keys alone (64
//   blocks on 132 SMs at whisper's shape). Instead the grid is (B * Hkv,
//   S): the GQA group's rows share a block, so K and V are read once per
//   kv head, and the keys are split S ways (the host's plan: >= 2 blocks
//   an SM where Tk allows, >= 128 keys a split, every key in one split).
//   Each block streams its keys through a 4-stage cp.async ring of 64-key
//   stages (16-byte loads, XOR-swizzled rows), each warp scores 16 keys
//   against the m16 row tile with mma.sync m16n8k16 (ldmatrix, .trans for
//   V), keeps (m, l, acc) in registers, and the block's warps are merged
//   through shared memory into one fp32 partial (m, l, acc[64]) in a
//   workspace the wrapper allocates. The combine kernel (a programmatic
//   dependent launch) rescales the splits by 2^(m_s - m*) and writes o. A
//   split in which a row sees no key has m = -1e30, l = 0 and adds 0: no
//   NaN. No atomics: every partial has one writer and the combine sums them
//   in a fixed order, so two launches give the same bits.
// * bf16 at D = DV = 80 (zamba2-2.7b: d_model 2560 over 32 heads),
//   flash_tc_bf16<128, 128, 80>: 80 is not a multiple of the 64-element box,
//   and the 128-byte swizzle caps a box row at 64 bf16, so the 128-wide tile
//   runs over tensors whose rows are 80 wide. The tensor maps take dims[0] =
//   80 and a row stride of 160 bytes (a multiple of 16, as TMA requires);
//   TMA zero-fills columns 80-127 of each tile's second box, and a
//   transaction still counts the whole box. Q . K^T over the zero columns is
//   exact; V's zero columns give zero output columns, which the epilogue
//   skips, storing rows 80 wide. The scale is the caller's (1/sqrt(80)), not
//   the tile width's. It wastes 48/128 of the MMA work and of the tile
//   bytes; an exact 80-wide tile (a 64-element box under the 128-byte swizzle
//   beside a 16-element box under the 32-byte one, two descriptor layouts)
//   would not, for more code than this slice needs.
// * fp32 (D <= 192, DV <= min(D, 128)), flash_simt_f32<DMAX>: 4 warps x 4
//   query rows, 32-key tiles; lane j scores key j against the warp's rows
//   (the K tile padded to DMAX + 1 floats a row), the row max and sum go
//   through warp shuffles, and each lane accumulates DV / 32 output
//   columns. Two instantiations: <128, false> for D = DV <= 128, the
//   kernel as it was before v had a head dim of its own (static tiles,
//   41,088 B; ptxas -v: 96 registers, no spills), and <192, true> for every
//   other pair (tiles at row strides 192 / 193 / 128 in 53,376 B of
//   dynamic shared memory, past the 48 KB static limit: opted in; 64
//   registers, no spills). One kernel for both, with v's stride and the
//   predicates on DV at run time, compiled to 64 registers and ran the D =
//   DV = 128 shapes 1.5-2.1x slower on the H100. fp32 products stay off
//   the tensor cores (TF32 would cost digits the fp32 path is held to).
// No --use_fast_math: the fp32 path's expf and the divisions are IEEE, as
// in the plain version.

#include <cuda.h>            // CUtensorMap; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;          // query rows per block (64 per consumer)
constexpr int TC_BK = 128;          // keys per tile
constexpr int TC_STAGES = 2;        // depth of the K/V ring
constexpr int WG = 128;             // threads per warpgroup
constexpr int TC_THREADS = 3 * WG;  // producer + two consumers
constexpr int BOX = 64;             // bf16 per TMA box row: 128 B, the swizzle width
constexpr int BOX_BYTES = 128 * BOX * 2;   // one box: 128 rows x 128 B
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = 8;

constexpr int MAX_OPT_IN_SMEM = 232448;   // the most a block may opt into (227 KB)

// dynamic shared memory: Q | K ring | V ring | mbarriers, 1024-byte aligned;
// the mbarriers: Q full, then K full, V full, K empty and V empty per stage
template <int D, int DV, int STAGES = TC_STAGES>
struct TcSmem {
    static constexpr int TILE = 128 * D * 2;                 // 128 rows x D: Q, K
    static constexpr int V_TILE = 128 * DV * 2;              // 128 rows x DV
    static constexpr int Q = 0;
    static constexpr int K = TILE;
    static constexpr int V = K + STAGES * TILE;
    static constexpr int BAR = V + STAGES * V_TILE;
    static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;   // + alignment slack
    static_assert(BYTES <= MAX_OPT_IN_SMEM, "K6 bf16 tiles exceed the shared-memory opt-in");
    static_assert(D % 64 == 0 && (DV == 64 || DV == 128) && DV <= D,
                  "K6 bf16 takes D a multiple of 64 and DV of 64 or 128, DV <= D");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (in 16-byte units), layout type
// 1 (B128) in bits 62-63; base offset 0 (every tile is 1024-byte aligned)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
           | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
           | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep registers that an asynchronous wgmma reads or writes in place
// across its issue and its wait (the compiler sees the asm as instantaneous)
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N, int M>
__device__ __forceinline__ void hold(uint32_t (&r)[N][M]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d (+)= A . B, m64n128k16, A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B, m64n128k16, A from registers, B from shared memory, MN-major
// (the transpose bit: B is stored [k][n] with n contiguous)
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n64k16, A from registers, B from shared memory, MN-major
// (the transpose bit: B is stored [k][n] with n contiguous)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// two floats -> bf16x2, round to nearest even; `lo` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// HD: the head dim of q, k and v in memory where it is narrower than the
// tile (D = DV = 128 over rows of HD = 80, zero-filled by TMA past HD); 0
// where the tensors are D and DV wide. o's rows are HD (else DV) wide.
//
// Accumulator layout of wgmma m64nN (fp32), for thread t of a warpgroup
// with w = t / 32, g = (t % 32) / 4, t4 = t % 4: d[4 i + 2 hr + e] holds row
// 16 w + g + 8 hr, column 8 i + 2 t4 + e. The register-A fragment of
// m64k16 for k-step kk is {P(g, 16kk + 2t4..), P(g + 8, ..), P(g, 16kk + 8
// + 2t4..), P(g + 8, ..)}: chunks 2kk and 2kk + 1 of the score accumulators.
template <int D, int DV, int HD = 0>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc_bf16(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              __nv_bfloat16* __restrict__ o, int hq, int hkv, int tq, int tk,
              float scale_log2, int causal) {
    using L = TcSmem<D, DV>;
    static_assert(HD == 0 || (D == DV && DV - BOX < HD && HD < DV && HD % 8 == 0),
                  "K6 bf16 pads a head dim HD only within the last box of a D = DV tile, "
                  "over rows of a multiple of 16 bytes");
    constexpr int O_DV = HD ? HD : DV;        // o's row width
    constexpr int BOXES = D / BOX;             // 64-element boxes per Q or K tile row
    constexpr int V_BOXES = DV / BOX;          // and per V tile row
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_full = base + L::BAR;     // then K full [2], V full [2], empty [2]
    auto k_full = [&](int s) { return base + L::BAR + 8 * (1 + s); };
    auto v_full = [&](int s) { return base + L::BAR + 8 * (1 + TC_STAGES + s); };
    auto empty = [&](int s) { return base + L::BAR + 8 * (1 + 2 * TC_STAGES + s); };

    const int bh = blockIdx.x;                                // b * hq + h
    const int b = bh / hq, h = bh % hq;
    const int kv_bh = b * hkv + h / (hq / hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;     // longest tiles first
    const int offset = tk - tq;
    const int kv_end = causal ? min(tk, q0 + TC_BQ + offset) : tk;
    const int n_tiles = (kv_end + TC_BK - 1) / TC_BK;
    const int wg = threadIdx.x / WG;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < TC_STAGES; ++s) {
            mbar_init(k_full(s), 1);
            mbar_init(v_full(s), 1);
            mbar_init(empty(s), CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
        if (threadIdx.x == 0) {
            mbar_expect_tx(q_full, TC_BQ * D * 2);
#pragma unroll
            for (int x = 0; x < BOXES; ++x)
                tma_load_3d(base + L::Q + x * BOX_BYTES, &q_map, q_full, x * BOX, q0, bh);
            for (int j = 0; j < n_tiles; ++j) {
                const int s = j % TC_STAGES;
                if (j >= TC_STAGES) mbar_wait(empty(s), (j / TC_STAGES - 1) & 1);
                const uint32_t kt = base + L::K + s * L::TILE, vt = base + L::V + s * L::V_TILE;
                mbar_expect_tx(k_full(s), TC_BK * D * 2);
#pragma unroll
                for (int x = 0; x < BOXES; ++x)
                    tma_load_3d(kt + x * BOX_BYTES, &k_map, k_full(s), x * BOX, j * TC_BK, kv_bh);
                mbar_expect_tx(v_full(s), TC_BK * DV * 2);
#pragma unroll
                for (int x = 0; x < V_BOXES; ++x)
                    tma_load_3d(vt + x * BOX_BYTES, &v_map, v_full(s), x * BOX, j * TC_BK, kv_bh);
            }
        }
    } else {
        // consumers: 64 query rows each
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
        const int ci = wg - 1;
        const int t = threadIdx.x % WG;
        const int warp = t / 32, lane = t % 32;
        const int g = lane / 4, t4 = lane % 4;
        const int first_row = q0 + ci * 64;               // this warpgroup's first row
        const int row0 = first_row + warp * 16 + g;        // this thread's rows: row0, row0 + 8
        const uint32_t q_at = base + L::Q + ci * 64 * 128; // row ci * 64 of each Q box

        float acc[DV / 2];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF};
        float l[2] = {0.f, 0.f};
        float s[64];
        uint32_t p[TC_BK / 16][4];

        mbar_wait(q_full, 0);
        for (int j = 0; j < n_tiles; ++j) {
            const int st = j % TC_STAGES, parity = (j / TC_STAGES) & 1;
            const int kv0 = j * TC_BK;
            const uint32_t kt = base + L::K + st * L::TILE, vt = base + L::V + st * L::V_TILE;

            // S = Q . K^T: D / 16 k-steps, 32 bytes apart inside a box
            mbar_wait(k_full(st), parity);
            hold(s);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
                wgmma_ss_m64n128(s, gmma_desc(q_at + off, 16, 1024),
                                 gmma_desc(kt + off, 16, 1024), kk > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
            hold(s);

            // scale (log2 units), mask where the tile crosses the diagonal or
            // Tk, online softmax; rows row0 (hr = 0) and row0 + 8 (hr = 1)
            const bool edge = kv0 + TC_BK > tk || (causal && kv0 + TC_BK - 1 > first_row + offset);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = row0 + hr * 8;
                float mx = NEG_INF;
#pragma unroll
                for (int i = 0; i < TC_BK / 8; ++i) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float x = s[4 * i + 2 * hr + e] * scale_log2;
                        if (edge) {
                            const int key = kv0 + 8 * i + 2 * t4 + e;
                            if (key >= tk || (causal && key > row + offset)) x = NEG_INF;
                        }
                        s[4 * i + 2 * hr + e] = x;
                        mx = fmaxf(mx, x);
                    }
                }
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
                const float m_new = fmaxf(m[hr], mx);
                const float corr = exp2f(m[hr] - m_new);
                float sum = 0.f;
#pragma unroll
                for (int i = 0; i < TC_BK / 8; ++i) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float pv = exp2f(s[4 * i + 2 * hr + e] - m_new);
                        s[4 * i + 2 * hr + e] = pv;
                        sum += pv;
                    }
                }
                sum += __shfl_xor_sync(FULL, sum, 1);
                sum += __shfl_xor_sync(FULL, sum, 2);
                l[hr] = corr * l[hr] + sum;
                m[hr] = m_new;
#pragma unroll
                for (int i = 0; i < DV / 8; ++i) {
                    acc[4 * i + 2 * hr] *= corr;
                    acc[4 * i + 2 * hr + 1] *= corr;
                }
            }
#pragma unroll
            for (int kk = 0; kk < TC_BK / 16; ++kk) {
                p[kk][0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
                p[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
                p[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
                p[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
            }

            // O += P . V: 16 keys per k-step (2,048 B of V rows); the second
            // 64 columns of d sit one box (LBO) further, 8 keys one SBO
            mbar_wait(v_full(st), parity);
            hold(acc);
            hold(p);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < TC_BK / 16; ++kk) {
                const uint64_t db = gmma_desc(vt + kk * 16 * 128, BOX_BYTES, 1024);
                if constexpr (DV == 128) wgmma_rs_m64n128(acc, p[kk], db);
                else wgmma_rs_m64n64(acc, p[kk], db);
            }
            wgmma_commit();
            wgmma_wait_all();
            hold(acc);
            hold(p);
            if (lane == 0) mbar_arrive(empty(st));
        }

#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = row0 + hr * 8;
            if (row >= tq) continue;
            const float denom = fmaxf(l[hr], 1e-30f);
            __nv_bfloat16* orow = o + (static_cast<long>(bh) * tq + row) * O_DV + t4 * 2;
#pragma unroll
            for (int i = 0; i < DV / 8; ++i) {
                if (O_DV < DV && i * 8 + t4 * 2 >= O_DV) continue;   // a zero column
                *reinterpret_cast<uint32_t*>(orow + i * 8) =
                    pack_f32(acc[4 * i + 2 * hr] / denom, acc[4 * i + 2 * hr + 1] / denom);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 at D = DV = 64: the same tiles, the softmax under the tensor cores
// ---------------------------------------------------------------------------

constexpr int OV_STAGES = 4;        // depth of the K/V ring of the overlapped schedule

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// named barriers over the two consumer warpgroups (256 threads; id 0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// 2**x on the MUFU, denormal results flushed to 0 (a probability below
// 2**-126 adds nothing a bf16 P . V can hold)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// S = Q . K^T for one 128-key tile: D / 16 k-steps, 32 bytes apart in a box
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_at, uint32_t kt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss_m64n128(s, gmma_desc(q_at + off, 16, 1024), gmma_desc(kt + off, 16, 1024),
                         kk > 0);
    }
}

// acc += P . V for one 128-key tile: 16 keys a k-step
template <int DV>
__device__ __forceinline__ void issue_pv(float (&acc)[DV / 2], const uint32_t (&p)[TC_BK / 16][4],
                                         uint32_t vt) {
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint64_t db = gmma_desc(vt + kk * 16 * 128, BOX_BYTES, 1024);
        if constexpr (DV == 128) wgmma_rs_m64n128(acc, p[kk], db);
        else wgmma_rs_m64n64(acc, p[kk], db);
    }
}

// the online softmax of one tile's scores, rows row0 (hr = 0) and row0 + 8
// (hr = 1), scale >= 0: the row max over the raw scores (masked where the
// tile crosses the diagonal or Tk), then p = 2**(s * scale * log2(e) - m)
// as one fma and the MUFU's exp2, masked keys' p exactly 0 (whatever the
// scale); s is turned into p and (m, l) moved on; corr is the factor acc
// must be rescaled by before this tile's P . V. The maxima and sums run in
// CHAINS partial chains a row (fewer dependent adds in a row for the
// consumers' few warps). EDGE: the tile crosses the diagonal or Tk (the
// mask runs only there: a branch a tile, not a select an element)
constexpr int CHAINS = 4;

template <bool EDGE>
__device__ __forceinline__ void tile_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int kv0, int row0, int t4,
                                             int tk, int causal, int offset, float scale_log2) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        // the last key the row sees, as an offset from this thread's column
        // 0 of the tile
        const int last = min(tk - 1, causal ? row0 + hr * 8 + offset : tk - 1) - kv0 - 2 * t4;
        float mx[CHAINS], sum[CHAINS];
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) {
            mx[c] = NEG_INF;
            sum[c] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < TC_BK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float& x = s[4 * i + 2 * hr + e];
                if (EDGE && 8 * i + e > last) x = NEG_INF;
                mx[i % CHAINS] = fmaxf(mx[i % CHAINS], x);
            }
#pragma unroll
        for (int c = 1; c < CHAINS; ++c) mx[0] = fmaxf(mx[0], mx[c]);
        float r = fmaxf(mx[0], __shfl_xor_sync(FULL, mx[0], 1));
        r = fmaxf(r, __shfl_xor_sync(FULL, r, 2));
        const float m_new = fmaxf(m[hr], r * scale_log2);
        corr[hr] = ex2(m[hr] - m_new);
#pragma unroll
        for (int i = 0; i < TC_BK / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float& x = s[4 * i + 2 * hr + e];
                x = EDGE && 8 * i + e > last ? 0.f : ex2(fmaf(x, scale_log2, -m_new));
                sum[i % CHAINS] += x;
            }
#pragma unroll
        for (int c = 1; c < CHAINS; ++c) sum[0] += sum[c];
        r = sum[0] + __shfl_xor_sync(FULL, sum[0], 1);
        r += __shfl_xor_sync(FULL, r, 2);
        l[hr] = corr[hr] * l[hr] + r;
        m[hr] = m_new;
    }
}

// flash_tc_bf16's tiles, producer and epilogue, with the consumers'
// schedule changed so the exponentials run under the tensor cores:
// * within a warpgroup, S_j = Q . K_j^T is issued together with P_{j-1} .
//   V_{j-1} (two commit groups); wgmma.wait_group 1 returns with S_j while
//   P_{j-1} . V_{j-1} still runs, and the softmax of tile j overlaps it;
//   acc is rescaled by tile j - 1's factor just before that product is issued;
// * pingpong: the two consumer warpgroups take turns to issue their
//   products (named barriers 1 and 2, 256 threads), so one warpgroup's
//   softmax runs under the other's products;
// * K and V stages are freed apart (K after S_j, V after its product) in an
//   OV_STAGES-deep ring.
template <int D, int DV>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc_bf16_overlap(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ o, int hq, int hkv, int tq, int tk,
                      float scale_log2, int causal) {
    constexpr int STAGES = OV_STAGES;
    using L = TcSmem<D, DV, STAGES>;
    constexpr int BOXES = D / BOX, V_BOXES = DV / BOX;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t q_full = base + L::BAR;
    auto k_full = [&](int s) { return base + L::BAR + 8 * (1 + s); };
    auto v_full = [&](int s) { return base + L::BAR + 8 * (1 + STAGES + s); };
    auto k_empty = [&](int s) { return base + L::BAR + 8 * (1 + 2 * STAGES + s); };
    auto v_empty = [&](int s) { return base + L::BAR + 8 * (1 + 3 * STAGES + s); };
    auto k_tile = [&](int s) { return base + L::K + s * L::TILE; };
    auto v_tile = [&](int s) { return base + L::V + s * L::V_TILE; };

    const int bh = blockIdx.x;
    const int b = bh / hq, h = bh % hq;
    const int kv_bh = b * hkv + h / (hq / hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;     // longest tiles first
    const int offset = tk - tq;
    const int kv_end = causal ? min(tk, q0 + TC_BQ + offset) : tk;
    const int n_tiles = (kv_end + TC_BK - 1) / TC_BK;
    const int wg = threadIdx.x / WG;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full(s), 1);
            mbar_init(v_full(s), 1);
            mbar_init(k_empty(s), CONSUMER_WARPS);
            mbar_init(v_empty(s), CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
        if (threadIdx.x == 0) {
            mbar_expect_tx(q_full, TC_BQ * D * 2);
#pragma unroll
            for (int x = 0; x < BOXES; ++x)
                tma_load_3d(base + L::Q + x * BOX_BYTES, &q_map, q_full, x * BOX, q0, bh);
            for (int j = 0; j < n_tiles; ++j) {
                const int s = j % STAGES, parity = (j / STAGES - 1) & 1;
                if (j >= STAGES) mbar_wait(k_empty(s), parity);
                mbar_expect_tx(k_full(s), TC_BK * D * 2);
#pragma unroll
                for (int x = 0; x < BOXES; ++x)
                    tma_load_3d(k_tile(s) + x * BOX_BYTES, &k_map, k_full(s), x * BOX,
                                j * TC_BK, kv_bh);
                if (j >= STAGES) mbar_wait(v_empty(s), parity);
                mbar_expect_tx(v_full(s), TC_BK * DV * 2);
#pragma unroll
                for (int x = 0; x < V_BOXES; ++x)
                    tma_load_3d(v_tile(s) + x * BOX_BYTES, &v_map, v_full(s), x * BOX,
                                j * TC_BK, kv_bh);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
        const int ci = wg - 1;
        const int t = threadIdx.x % WG;
        const int warp = t / 32, lane = t % 32;
        const int g = lane / 4, t4 = lane % 4;
        const int first_row = q0 + ci * 64;
        const int row0 = first_row + warp * 16 + g;
        const uint32_t q_at = base + L::Q + ci * 64 * 128;
        // the issue turns: warpgroup ci waits on barrier 1 + ci and passes the
        // turn to the other's; consumer 1 starts (consumer 2 arrives first),
        // and consumer 2 does not pass its last turn, so every barrier
        // completes as often as it is waited on
        auto turn = [&]() { named_sync(1 + ci); };
        auto pass = [&](bool last) { if (!(last && ci == 1)) named_arrive(2 - ci); };
        if (ci == 1) named_arrive(1);

        float acc[DV / 2];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF};
        float l[2] = {0.f, 0.f};
        float corr[2] = {1.f, 1.f};
        float s[64];
        uint32_t p[TC_BK / 16][4];
        auto softmax = [&](int kv0) {
            if (kv0 + TC_BK > tk || (causal && kv0 + TC_BK - 1 > first_row + offset))
                tile_softmax<true>(s, m, l, corr, kv0, row0, t4, tk, causal, offset, scale_log2);
            else
                tile_softmax<false>(s, m, l, corr, kv0, row0, t4, tk, causal, offset, scale_log2);
        };
        auto rescale = [&]() {
#pragma unroll
            for (int i = 0; i < DV / 8; ++i)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    acc[4 * i + 2 * hr] *= corr[hr];
                    acc[4 * i + 2 * hr + 1] *= corr[hr];
                }
        };
        auto pack = [&]() {
#pragma unroll
            for (int kk = 0; kk < TC_BK / 16; ++kk) {
                p[kk][0] = pack_f32(s[8 * kk + 0], s[8 * kk + 1]);
                p[kk][1] = pack_f32(s[8 * kk + 2], s[8 * kk + 3]);
                p[kk][2] = pack_f32(s[8 * kk + 4], s[8 * kk + 5]);
                p[kk][3] = pack_f32(s[8 * kk + 6], s[8 * kk + 7]);
            }
        };

        // tile 0: S_0 alone
        mbar_wait(q_full, 0);
        mbar_wait(k_full(0), 0);
        turn();
        hold(s);
        wgmma_fence();
        issue_qk<D>(s, q_at, k_tile(0));
        wgmma_commit();
        pass(false);
        wgmma_wait<0>();
        hold(s);
        if (lane == 0) mbar_arrive(k_empty(0));
        softmax(0);
        pack();

        // tile j: S_j with P_{j-1} . V_{j-1}, the softmax of S_j under the latter
        for (int j = 1; j < n_tiles; ++j) {
            const int st = j % STAGES, pst = (j - 1) % STAGES;
            mbar_wait(k_full(st), (j / STAGES) & 1);
            mbar_wait(v_full(pst), ((j - 1) / STAGES) & 1);
            rescale();
            turn();
            hold(s);
            hold(acc);
            hold(p);
            wgmma_fence();
            issue_qk<D>(s, q_at, k_tile(st));
            wgmma_commit();
            issue_pv<DV>(acc, p, v_tile(pst));
            wgmma_commit();
            pass(false);
            wgmma_wait<1>();
            hold(s);
            if (lane == 0) mbar_arrive(k_empty(st));
            softmax(j * TC_BK);
            // the softmax's results tied here, before the wait in program
            // order, so the compiler cannot sink any of it past the wait
            hold(s);
            hold(l);
            wgmma_wait<0>();
            hold(acc);
            hold(p);
            if (lane == 0) mbar_arrive(v_empty(pst));
            pack();
        }

        // the last tile's P . V
        const int lst = (n_tiles - 1) % STAGES;
        mbar_wait(v_full(lst), ((n_tiles - 1) / STAGES) & 1);
        rescale();
        turn();
        hold(acc);
        hold(p);
        wgmma_fence();
        issue_pv<DV>(acc, p, v_tile(lst));
        wgmma_commit();
        pass(true);
        wgmma_wait<0>();
        hold(acc);
        hold(p);

#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = row0 + hr * 8;
            if (row >= tq) continue;
            const float denom = fmaxf(l[hr], 1e-30f);
            __nv_bfloat16* orow = o + (static_cast<long>(bh) * tq + row) * DV + t4 * 2;
#pragma unroll
            for (int i = 0; i < DV / 8; ++i)
                *reinterpret_cast<uint32_t*>(orow + i * 8) =
                    pack_f32(acc[4 * i + 2 * hr] / denom, acc[4 * i + 2 * hr + 1] / denom);
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 decode: a few query rows over many keys, the keys split over blocks
// ---------------------------------------------------------------------------

constexpr int DEC_D = 64;                  // head dim of q, k and v
constexpr int DEC_ROWS = 16;               // query rows a block: G * Tq <= 16, one m16 tile
constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_BK = 16 * DEC_WARPS;     // keys a stage: 16 a warp
constexpr int DEC_STAGES = 4;              // depth of the K/V ring
constexpr int DEC_ROW_BYTES = DEC_D * 2;   // 128: eight 16-byte chunks
constexpr int DEC_TILE = DEC_BK * DEC_ROW_BYTES;
constexpr int DEC_COMBINE_THREADS = DEC_D;

// dynamic shared memory: Q | K ring | V ring; after the key loop the ring
// holds each warp's (acc, m, l) for the block's combine
struct DecSmem {
    static constexpr int Q = 0;
    static constexpr int K = DEC_ROWS * DEC_ROW_BYTES;
    static constexpr int V = K + DEC_STAGES * DEC_TILE;
    static constexpr int BYTES = V + DEC_STAGES * DEC_TILE;
    static constexpr int ACC = K;                                        // [warp][row][64] f32
    static constexpr int ML = ACC + DEC_WARPS * DEC_ROWS * DEC_D * 4;    // [warp][row] (m, l)
    static_assert(ML + DEC_WARPS * DEC_ROWS * 8 <= BYTES, "the combine scratch overflows the ring");
};

// byte offset of 16-byte chunk c of row r in a 128-byte-row tile: the chunk
// index XOR the row's low 3 bits, so the 8 rows an ldmatrix reads at one
// column fall in 8 different bank groups
__device__ __forceinline__ uint32_t dec_swz(int r, int c) {
    return static_cast<uint32_t>(r * DEC_ROW_BYTES + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += A . B, m16n8k16, bf16 in, fp32 sums
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// exp2 of x - m where m may be NEG_INF (a row that has seen no key): the
// reference point is then 0, so masked scores give exactly 0 and no NaN
__device__ __forceinline__ float ref_point(float m) { return m == NEG_INF ? 0.f : m; }

// One block per (batch * kv head, split): the GQA group's R = G * Tq query
// rows (contiguous in q and o: heads kvh * G .. kvh * G + G - 1, Tq rows
// each) against keys [split * keys, min(split * keys + keys, Tk)). Each
// warp takes 16 keys of every 64-key stage; the mma.sync fragments: thread
// t (g = lane / 4, t4 = lane % 4) holds rows g and g + 8, columns 8 n + 2 t4
// + {0, 1} of each n8 tile. Writes the split's (m, l) in log2 units and its
// unnormalised acc, fp32, to the workspace: row (bkv * S + split) * R + r.
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int rows, int tq, int tk, int keys,
                  float scale_log2, int causal) {
    extern __shared__ __align__(128) uint8_t dec_smem[];
    const uint32_t base = smem_u32(dec_smem);
    const int bkv = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int k_lo = split * keys, k_hi = min(tk, k_lo + keys);
    const int n_tiles = (k_hi - k_lo + DEC_BK - 1) / DEC_BK;
    const __nv_bfloat16* kp = k + static_cast<long>(bkv) * tk * DEC_D;
    const __nv_bfloat16* vp = v + static_cast<long>(bkv) * tk * DEC_D;

    // one stage: 64 rows of K and of V, 8 chunks a row, 4 + 4 per thread;
    // rows past the split are zero-filled (and masked below)
    auto load_tile = [&](int j) {
        const int st = j % DEC_STAGES;
#pragma unroll
        for (int x = 0; x < DEC_BK * 8 / DEC_THREADS; ++x) {
            const int i = tid + x * DEC_THREADS, r = i / 8, c = i % 8;
            const int key = k_lo + j * DEC_BK + r;
            const bool in = key < k_hi;
            const long at = static_cast<long>(in ? key : 0) * DEC_D + c * 8;
            const uint32_t off = st * DEC_TILE + dec_swz(r, c);
            cp_async16(base + DecSmem::K + off, kp + at, in ? 16 : 0);
            cp_async16(base + DecSmem::V + off, vp + at, in ? 16 : 0);
        }
    };

    // Q: R rows, one chunk per thread, rows past R zero; with tile 0
    {
        const int r = tid / 8, c = tid % 8;
        const bool in = r < rows;
        cp_async16(base + DecSmem::Q + dec_swz(r, c),
                   q + (static_cast<long>(bkv) * rows + (in ? r : 0)) * DEC_D + c * 8,
                   in ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < DEC_STAGES - 1; ++j) {
        if (j < n_tiles) load_tile(j);
        cp_async_commit();
    }

    // the last key each of this thread's rows sees: end-aligned causal
    int limit[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
        limit[hr] = causal ? (g + 8 * hr) % tq + tk - tq : tk - 1;

    float acc[DEC_D / 8][4];
#pragma unroll
    for (int n = 0; n < DEC_D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    uint32_t qa[DEC_D / 16][4];

    for (int j = 0; j < n_tiles; ++j) {
        cp_async_wait<DEC_STAGES - 2>();
        __syncthreads();                      // tile j landed; tile j - 1 is free
        if (j + DEC_STAGES - 1 < n_tiles) load_tile(j + DEC_STAGES - 1);
        cp_async_commit();
        if (j == 0) {
#pragma unroll
            for (int ks = 0; ks < DEC_D / 16; ++ks)
                ldmatrix_x4(qa[ks], base + DecSmem::Q + dec_swz(lane % 16, 2 * ks + lane / 16));
        }
        const uint32_t kt = base + DecSmem::K + (j % DEC_STAGES) * DEC_TILE;
        const uint32_t vt = base + DecSmem::V + (j % DEC_STAGES) * DEC_TILE;
        const int r0 = warp * 16;             // this warp's first key row in the tile

        // S = Q . K^T over the warp's 16 keys: two n8 tiles, 4 k-steps
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < DEC_D / 16; ++ks) {
            uint32_t b[4];
            ldmatrix_x4(b, kt + dec_swz(r0 + lane % 8 + 8 * (lane / 16), 2 * ks + (lane / 8) % 2));
            mma_m16n8k16(s[0], qa[ks], b[0], b[1]);
            mma_m16n8k16(s[1], qa[ks], b[2], b[3]);
        }

        // scale (log2 units), mask past the split or the diagonal, online
        // softmax on rows g (hr = 0) and g + 8 (hr = 1)
        const int key0 = k_lo + j * DEC_BK + r0 + 2 * t4;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float mx = NEG_INF;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int key = key0 + 8 * n + e;
                    float x = s[n][2 * hr + e] * scale_log2;
                    if (key >= k_hi || key > limit[hr]) x = NEG_INF;
                    s[n][2 * hr + e] = x;
                    mx = fmaxf(mx, x);
                }
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
            const float m_new = fmaxf(m[hr], mx);
            const float ref = ref_point(m_new);
            const float corr = exp2f(m[hr] - ref);
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float p = exp2f(s[n][2 * hr + e] - ref);
                    s[n][2 * hr + e] = p;
                    sum += p;
                }
            sum += __shfl_xor_sync(FULL, sum, 1);
            sum += __shfl_xor_sync(FULL, sum, 2);
            l[hr] = corr * l[hr] + sum;
            m[hr] = m_new;
#pragma unroll
            for (int n = 0; n < DEC_D / 8; ++n) {
                acc[n][2 * hr] *= corr;
                acc[n][2 * hr + 1] *= corr;
            }
        }

        // O += P . V: the score fragments are the A fragment of k16
        const uint32_t pa[4] = {pack_f32(s[0][0], s[0][1]), pack_f32(s[0][2], s[0][3]),
                                pack_f32(s[1][0], s[1][1]), pack_f32(s[1][2], s[1][3])};
#pragma unroll
        for (int pair = 0; pair < DEC_D / 16; ++pair) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vt + dec_swz(r0 + lane % 8 + 8 * ((lane / 8) % 2),
                                              2 * pair + lane / 16));
            mma_m16n8k16(acc[2 * pair], pa, b[0], b[1]);
            mma_m16n8k16(acc[2 * pair + 1], pa, b[2], b[3]);
        }
    }
    // the combine may start launching: it waits for this grid's writes
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

    // the block's four warps into one partial, through the drained ring
    cp_async_wait<0>();
    __syncthreads();
    float* red_acc = reinterpret_cast<float*>(dec_smem + DecSmem::ACC);
    float2* red_ml = reinterpret_cast<float2*>(dec_smem + DecSmem::ML);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int r = g + 8 * hr;
        float* at = red_acc + (warp * DEC_ROWS + r) * DEC_D + 2 * t4;
#pragma unroll
        for (int n = 0; n < DEC_D / 8; ++n)
            *reinterpret_cast<float2*>(at + 8 * n) = make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
        if (t4 == 0) red_ml[warp * DEC_ROWS + r] = make_float2(m[hr], l[hr]);
    }
    __syncthreads();
    const long out_row = (static_cast<long>(bkv) * splits + split) * rows;
    for (int i = tid; i < rows * DEC_D; i += DEC_THREADS) {
        const int r = i / DEC_D, d = i % DEC_D;
        float mx = NEG_INF;
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, red_ml[w * DEC_ROWS + r].x);
        const float ref = ref_point(mx);
        float a = 0.f, sum = 0.f;
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w) {
            const float2 ml = red_ml[w * DEC_ROWS + r];
            const float c = exp2f(ml.x - ref);
            a += c * red_acc[(w * DEC_ROWS + r) * DEC_D + d];
            sum += c * ml.y;
        }
        part_acc[(out_row + r) * DEC_D + d] = a;
        if (d == 0) reinterpret_cast<float2*>(part_ml)[out_row + r] = make_float2(mx, sum);
    }
}

// One block per (batch * kv head, row): the splits' partials rescaled to
// their common max, o = acc / max(l, 1e-30) in bf16. Launched as a
// programmatic dependent of flash_decode_bf16: it waits for that grid here.
__global__ void __launch_bounds__(DEC_COMBINE_THREADS)
flash_decode_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ o, int rows, int splits) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const int bkv = blockIdx.x / rows, r = blockIdx.x % rows, d = threadIdx.x;
    const float2* ml = reinterpret_cast<const float2*>(part_ml);
    const long first = static_cast<long>(bkv) * splits * rows + r;   // split 0's row
    float mx = NEG_INF;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[first + static_cast<long>(s) * rows].x);
    const float ref = ref_point(mx);
    float a = 0.f, sum = 0.f;
    for (int s = 0; s < splits; ++s) {
        const long at = first + static_cast<long>(s) * rows;
        const float2 p = ml[at];
        const float c = exp2f(p.x - ref);
        a += c * part_acc[at * DEC_D + d];
        sum += c * p.y;
    }
    o[(static_cast<long>(bkv) * rows + r) * DEC_D + d] = __float2bfloat16_rn(a / fmaxf(sum, 1e-30f));
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int S_ROWS = 4;                // query rows per warp
constexpr int S_WARPS = 4;
constexpr int S_BQ = S_ROWS * S_WARPS;   // query rows per block
constexpr int S_BK = 32;                 // keys per tile: one per lane
constexpr int S_DMAX = 192;              // q and k head dim
constexpr int S_DVMAX = 128;             // v head dim: S_DVMAX / 32 columns a lane
constexpr int S_THREADS = 32 * S_WARPS;

// the tiles of flash_simt_f32<DMAX>: Q (S_BQ x DMAX), K padded to DMAX + 1
// floats a row (lane j reads row j: no bank conflicts), V (S_BK x S_DVMAX);
// 41,088 B at DMAX = 128, 53,376 B at 192
template <int DMAX>
struct SimtTiles {
    float qs[S_BQ][DMAX];
    float ks[S_BK][DMAX + 1];
    float vs[S_BK][S_DVMAX];
};

// static shared memory where the tiles fit the 48 KB a block has without
// opting in (DMAX = 128: the kernel as it was before v had a head dim of its
// own), else dynamic shared memory, opted in at launch (DMAX = 192)
template <int DMAX>
__host__ __device__ constexpr int simt_dynamic_smem() {
    return sizeof(SimtTiles<DMAX>) <= 48 * 1024 ? 0 : static_cast<int>(sizeof(SimtTiles<DMAX>));
}

template <int DMAX>
__device__ __forceinline__ SimtTiles<DMAX>& simt_tiles() {
    if constexpr (simt_dynamic_smem<DMAX>() == 0) {
        __shared__ SimtTiles<DMAX> tiles;
        return tiles;
    } else {
        extern __shared__ float simt_dynamic[];
        return *reinterpret_cast<SimtTiles<DMAX>*>(simt_dynamic);
    }
}

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

// d <= DMAX; the tiles' row strides are DMAX, DMAX + 1 and S_DVMAX whatever
// d, so shared addresses fold to constants. OWN_DV: v's head dim is dv_arg
// <= min(d, S_DVMAX); else it is d, and every index is the one the kernel
// computed before v had a head dim of its own (same code, same registers)
template <int DMAX, bool OWN_DV>
__global__ void __launch_bounds__(S_THREADS)
flash_simt_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               int hq, int hkv, int tq, int tk, int d, int dv_arg, float scale, int causal) {
    const int dv = OWN_DV ? dv_arg : d;
    SimtTiles<DMAX>& tiles = simt_tiles<DMAX>();
    auto& qs = tiles.qs;
    auto& ks = tiles.ks;
    auto& vs = tiles.vs;

    const int bh = blockIdx.x;
    const int b = bh / hq, h = bh % hq;
    const int kvh = h / (hq / hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * S_BQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int offset = tk - tq;
    const float* qp = q + static_cast<long>(bh) * tq * d;
    const float* kp = k + (static_cast<long>(b) * hkv + kvh) * tk * d;
    const float* vp = v + (static_cast<long>(b) * hkv + kvh) * tk * dv;

    for (int i = threadIdx.x; i < S_BQ * d; i += S_THREADS) {
        const int r = i / d, c = i % d;
        qs[r][c] = q0 + r < tq ? qp[static_cast<long>(q0 + r) * d + c] : 0.f;
    }
    const int r0 = warp * S_ROWS;            // the warp's first row in the block
    float m[S_ROWS], l[S_ROWS], acc[S_ROWS][S_DVMAX / 32];
#pragma unroll
    for (int r = 0; r < S_ROWS; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int i = 0; i < S_DVMAX / 32; ++i) acc[r][i] = 0.f;
    }

    const int kv_end = causal ? min(tk, q0 + S_BQ + offset) : tk;
    for (int kv0 = 0; kv0 < kv_end; kv0 += S_BK) {
        __syncthreads();
        for (int i = threadIdx.x; i < S_BK * d; i += S_THREADS) {
            const int r = i / d, c = i % d;    // a V row is the first dv of these columns
            const bool in = kv0 + r < tk;
            const long at = static_cast<long>(kv0 + r) * d + c;
            ks[r][c] = in ? kp[at] : 0.f;
            if (!OWN_DV) vs[r][c] = in ? vp[at] : 0.f;
            else if (c < dv) vs[r][c] = in ? vp[static_cast<long>(kv0 + r) * dv + c] : 0.f;
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
            float part[S_DVMAX / 32];
#pragma unroll
            for (int i = 0; i < S_DVMAX / 32; ++i) part[i] = 0.f;
            for (int j = 0; j < S_BK; ++j) {
                const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
                for (int i = 0; i < S_DVMAX / 32; ++i) {
                    const int c = lane + 32 * i;
                    if (c < dv) part[i] = fmaf(pj, vs[j][c], part[i]);
                }
            }
#pragma unroll
            for (int i = 0; i < S_DVMAX / 32; ++i) acc[r][i] = acc[r][i] * corr + part[i];
        }
    }

#pragma unroll
    for (int r = 0; r < S_ROWS; ++r) {
        const int row = q0 + r0 + r;
        if (row >= tq) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        float* orow = o + (static_cast<long>(bh) * tq + row) * dv;
#pragma unroll
        for (int i = 0; i < S_DVMAX / 32; ++i) {
            const int c = lane + 32 * i;
            if (c < dv) orow[c] = acc[r][i] / denom;
        }
    }
}

template <int DMAX, bool OWN_DV>
int launch_simt(const void* q, const void* k, const void* v, void* o, int batch, int hq,
                int hkv, int tq, int tk, int d, int dv, int causal, float scale,
                cudaStream_t stream) {
    static repro::SmemOptIn opt_in;          // per device (common.cuh)
    constexpr int smem = simt_dynamic_smem<DMAX>();
    cudaError_t err = opt_in.ensure(
        reinterpret_cast<const void*>(flash_simt_f32<DMAX, OWN_DV>), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(batch * hq, (tq + S_BQ - 1) / S_BQ);
    flash_simt_f32<DMAX, OWN_DV><<<grid, S_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, tq, tk, d, dv,
        scale, causal);
    return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: look it up
// once through the runtime's entry-point query, so the library needs no -lcuda
EncodeTiled tensor_map_encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                  cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
        fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// a (D, T, heads) bf16 tensor, boxes of 64 x 128 x 1, 128-byte swizzle; reads
// past T (per head), or past D in a box that starts below it, fill with zeros
bool tile_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int t, int heads) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(t),
                                static_cast<cuuint64_t>(heads)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                   static_cast<cuuint64_t>(t) * d * 2};
    const cuuint32_t box[3] = {BOX, 128, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class Kernel>
int launch_tc_kernel(Kernel kernel, int smem, int qk_w, int v_w, const void* q, const void* k,
                     const void* v, void* o, int batch, int hq, int hkv, int tq, int tk,
                     int causal, float scale, cudaStream_t stream, repro::SmemOptIn& opt_in) {
    cudaError_t err = opt_in.ensure(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    CUtensorMap qm, km, vm;
    if (!tile_map(encode, &qm, q, qk_w, tq, batch * hq)
        || !tile_map(encode, &km, k, qk_w, tk, batch * hkv)
        || !tile_map(encode, &vm, v, v_w, tk, batch * hkv))
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(batch * hq, (tq + TC_BQ - 1) / TC_BQ);
    const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
    kernel<<<grid, TC_THREADS, smem, stream>>>(
        qm, km, vm, static_cast<__nv_bfloat16*>(o), hq, hkv, tq, tk, scale_log2, causal);
    return static_cast<int>(cudaGetLastError());
}

// (64, 64) runs the overlapped schedule; every other pair flash_tc_bf16's
template <int D, int DV, int HD = 0>
int launch_tc(const void* q, const void* k, const void* v, void* o, int batch, int hq,
              int hkv, int tq, int tk, int causal, float scale, cudaStream_t stream) {
    static repro::SmemOptIn opt_in;          // per device (common.cuh)
    constexpr int QK_W = HD ? HD : D, V_W = HD ? HD : DV;     // the rows in memory
    if constexpr (D == 64 && DV == 64 && HD == 0)
        return launch_tc_kernel(flash_tc_bf16_overlap<D, DV>,
                                TcSmem<D, DV, OV_STAGES>::BYTES, QK_W, V_W, q, k, v, o, batch,
                                hq, hkv, tq, tk, causal, scale, stream, opt_in);
    else
        return launch_tc_kernel(flash_tc_bf16<D, DV, HD>, TcSmem<D, DV>::BYTES, QK_W, V_W, q, k,
                                v, o, batch, hq, hkv, tq, tk, causal, scale, stream, opt_in);
}

// the split kernel, then the combine as its programmatic dependent (its
// launch overlaps the split kernel's tail; griddepcontrol.wait orders it)
int launch_decode(const void* q, const void* k, const void* v, void* o, void* part_acc,
                  void* part_ml, int batch, int hq, int hkv, int tq, int tk, int splits,
                  int keys, int causal, float scale, cudaStream_t stream) {
    static repro::SmemOptIn opt_in;          // per device (common.cuh)
    const int rows = hq / hkv * tq;
    if (rows > DEC_ROWS || splits < 1 || keys < 1 || static_cast<long>(splits) * keys < tk
        || static_cast<long>(splits - 1) * keys >= tk)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = opt_in.ensure(reinterpret_cast<const void*>(flash_decode_bf16),
                                    DecSmem::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
    flash_decode_bf16<<<dim3(batch * hkv, splits), DEC_THREADS, DecSmem::BYTES, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<float*>(part_acc),
        static_cast<float*>(part_ml), rows, tq, tk, keys, scale_log2, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * hkv * rows);
    cfg.blockDim = dim3(DEC_COMBINE_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, flash_decode_combine, static_cast<const float*>(part_acc),
                             static_cast<const float*>(part_ml),
                             static_cast<__nv_bfloat16*>(o), rows, splits);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (D, DV) pairs outside the instantiations below are refused
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int batch, int hq, int hkv, int tq, int tk, int d, int dv,
                                    int causal, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d == 128 && dv == 128)
        return launch_tc<128, 128>(q, k, v, o, batch, hq, hkv, tq, tk, causal, scale, s);
    if (d == 64 && dv == 64)
        return launch_tc<64, 64>(q, k, v, o, batch, hq, hkv, tq, tk, causal, scale, s);
    if (d == 192 && dv == 128)
        return launch_tc<192, 128>(q, k, v, o, batch, hq, hkv, tq, tk, causal, scale, s);
    if (d == 80 && dv == 80)
        return launch_tc<128, 128, 80>(q, k, v, o, batch, hq, hkv, tq, tk, causal, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// G * Tq <= 16 query rows a kv head at D = DV = 64: `splits` blocks a kv
// head of `keys` keys each (the last one shorter), partials into part_acc
// (B * Hkv * splits * G * Tq rows of 64 floats) and part_ml (the same rows
// of (m, l)), combined into o
extern "C" int flash_attention_decode_bf16(const void* q, const void* k, const void* v,
                                           void* o, void* part_acc, void* part_ml, int batch,
                                           int hq, int hkv, int tq, int tk, int splits, int keys,
                                           int causal, float scale, void* stream) {
    return launch_decode(q, k, v, o, part_acc, part_ml, batch, hq, hkv, tq, tk, splits, keys,
                         causal, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int batch, int hq, int hkv, int tq, int tk, int d, int dv,
                                   int causal, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d < 1 || d > S_DMAX || dv < 1 || dv > S_DVMAX || dv > d)
        return static_cast<int>(cudaErrorInvalidValue);
    if (d <= 128 && dv == d)
        return launch_simt<128, false>(q, k, v, o, batch, hq, hkv, tq, tk, d, dv, causal, scale,
                                       s);
    return launch_simt<S_DMAX, true>(q, k, v, o, batch, hq, hkv, tq, tk, d, dv, causal, scale,
                                     s);
}
