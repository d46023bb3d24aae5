// f32-accurate matrix products on Hopper's tensor cores (sm_90a): the
// mainloop shared by dml_pair, metric_topk and pairwise_dist (the bf16
// flash_attention kernel and the ssd_chunk scan use its barrier, TMA,
// wgmma and split helpers).
//
// 3xTF32. Each f32 operand x is split as hi = rna_tf32(x) and
// lo = rna_tf32(x - hi) (x - hi is exact in f32), and a . b is taken as
// hi_a.lo_b + lo_a.hi_b + hi_a.hi_b, three TF32 wgmmas accumulating in
// f32. The dropped lo.lo term and lo's own rounding leave about 2^-21 of
// |a||b| a product, near f32's 2^-24, at 495 / 3 = 165 TFLOP/s, where f32
// FFMA outside the tensor cores runs at 67. hi is rounded with cvt.rna,
// never truncated: wgmma itself ignores the low 13 mantissa bits.
//
// Layout. Every operand is K-major: rows of BK = 32 floats (128 bytes),
// brought into shared memory by TMA with the 128-byte swizzle, which is
// the layout a K-major wgmma descriptor reads (8-row atoms of 1024 bytes;
// a k-step of 8 floats advances the descriptor by 32 bytes). TMA
// zero-fills rows and columns past the tensor's edge, so no main loop
// masks anything. A tensor map needs a row stride that is a multiple of
// 16 bytes; the wrappers zero-pad the columns of an operand whose rows
// are not a multiple of 4 floats (zero columns change no product).
//
// Accumulation. The tensor cores add each wgmma's products into its
// accumulator with truncation, so a long run of wgmmas into one
// accumulator drifts toward zero by up to ~2^-24 of it a wgmma, enough to
// break dml_pair's f32 tolerance from d = 2048 on. So each stage's 12
// wgmmas go into a fresh accumulator, which is then added to the running
// sum with a round-to-nearest f32 add ("promotion", as fp8 GEMMs do it).
//
// Pipeline. A block is two warpgroups (the M side: 64 rows each, BM =
// 128). A ring of stages is kept in flight with TMA, each stage's landing
// signalled on its `full` mbarrier; a warpgroup releases a stage on its
// `empty` mbarrier once the wgmmas that read it have completed. In
// partial_product thread 0 refills a stage as soon as both warpgroups
// released it: a separate producer warp would make the block 288 threads,
// which ptxas budgets as three warpgroups (168 registers a thread, and the
// main loop spills), where two get 255. (The metric_topk scan keeps a
// producer warp: its ring has to run ahead through the tile epilogues.)
// The A operand reaches wgmma from registers: each warpgroup reads its 64
// rows' fragments from the landed stage and splits them there, so A costs
// no stores and no second read. The N side, shared by both warpgroups, is
// read from shared memory: split there by both warpgroups (hi over the
// raw values, lo into one of two lo buffers, the generic-proxy stores
// fenced against the async proxy wgmma reads through), or landed already
// split (the scan's queries). A stage's N-side split and A reads overlap
// the wgmmas of the stage before.
//
// Host side: tensor maps are encoded with the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// the shared library links against nothing but the CUDA runtime; they
// reach the kernel as `const __grid_constant__ CUtensorMap` parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int BK = 32;                  // floats of a staged row: 128 bytes
constexpr int ROW_BYTES = BK * 4;
constexpr int BM = 128;                 // M rows of a block: 2 warpgroups
constexpr int THREADS = 256;            // two warpgroups; thread 0 also
                                        // issues the TMA loads
constexpr int ALIGN = 1024;             // a 128-byte-swizzle atom
constexpr int SMEM_LIMIT = 232448;      // a block's shared memory on sm_90
constexpr int A_BYTES = BM * ROW_BYTES; // one stage's M-side tile

// -- barriers, TMA, proxies --------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// arrive and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// spin until the phase of parity `parity` has completed; a wait that
// never ends (a broken pipeline) traps, so the launch fails and the
// caller raises instead of the card hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    const long long t0 = clock64();
    uint32_t done = 0;
    while (!done) {
        if (clock64() - t0 > (1ll << 35)) __trap();     // ~20 s
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

// one 2-D box of a tensor map -> shared memory, completing on `bar`;
// (col, row) is the box's first element
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_addr(bar)), "r"(col), "r"(row)
        : "memory");
}

// one 4-D box of a tensor map -> shared memory, completing on `bar`;
// (c0, c1, c2, c3) are the coordinates of its first element, innermost
// first
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// generic-proxy shared-memory stores -> visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// -- wgmma ---------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING)
                 : "memory");
}

// keep the compiler from moving accumulator accesses across an async wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&acc)[R]) {
    #pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
}

// K-major operand tile with the 128-byte swizzle: 8-row atoms of 1024
// bytes (stride byte offset 64 x 16 B), layout type 1 (SWIZZLE_128B)
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
    const uint64_t a = smem_addr(tile);
    return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x N, f32) += a (64 x 8, tf32) b^T (N x 8, tf32): a from registers,
// b from shared memory. Fragments, thread t of the warpgroup, r0 = 16 (t /
// 32) + (t % 32) / 4, c0 = t % 4: a[v] holds row r0 + 8 (v % 2), column
// c0 + 4 (v / 2); d[4i + 2h + e] holds row r0 + 8 h, column 8 i + 2 c0 + e.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
    __device__ static __forceinline__ void mma(float (&d)[4], const float* a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
            " %0, %1, %2, %3},"
            " {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
              "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
              "l"(b), "r"(1));
    }
};

template <>
struct Wgmma<16> {
    __device__ static __forceinline__ void mma(float (&d)[8], const float* a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
            " %0, %1, %2, %3, %4, %5, %6, %7},"
            " {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7])
            : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
              "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
              "l"(b), "r"(1));
    }
};

template <>
struct Wgmma<32> {
    __device__ static __forceinline__ void mma(float (&d)[16], const float* a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15},"
            " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
              "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
              "l"(b), "r"(1));
    }
};

template <>
struct Wgmma<64> {
    __device__ static __forceinline__ void mma(float (&d)[32], const float* a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31},"
            " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
              "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
              "l"(b), "r"(1));
    }
};

template <>
struct Wgmma<128> {
    __device__ static __forceinline__ void mma(float (&d)[64], const float* a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31,"
            " %32, %33, %34, %35, %36, %37, %38, %39,"
            " %40, %41, %42, %43, %44, %45, %46, %47,"
            " %48, %49, %50, %51, %52, %53, %54, %55,"
            " %56, %57, %58, %59, %60, %61, %62, %63},"
            " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
            : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
              "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
              "l"(b), "r"(1));
    }
};


// -- bf16 wgmma (flash_attention, ssd_chunk) --------------------------------

// A bf16 tile of 128-byte rows along K (64-column boxes, as TMA lands
// them, e.g. flash's V tile of BK keys) as wgmma's MN-major operand with
// the 128-byte swizzle: the MN side's 64-column atoms lie tile_rows * 128
// bytes apart (leading byte offset), 8-row groups of K 1024 bytes apart
// (stride byte offset)
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* tile,
                                                  int tile_rows) {
    const uint64_t a = smem_addr(tile);
    return ((a & 0x3FFFF) >> 4) | ((uint64_t)(tile_rows * 8) << 16) |
           (64ull << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
    #pragma unroll
    for (int i = 0; i < R; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// s (64 x N, f32) = a (64 x 16) b^T (N x 16) when acc == 0, += when 1:
// both bf16 K-major in shared memory (tf32x3::desc_sw128). Fragments, as
// tf32x3::Wgmma: thread t of the warpgroup holds d[4i + 2h + e] at row
// 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 i + 2 (t % 4) + e.
template <int N>
struct WgmmaSS;

// o (64 x N, f32) += a (64 x 16, bf16 registers) b (16 x N, bf16 MN-major
// in shared memory, desc_mn_sw128). a[v] holds the bf16 pair at row
// 16 (t / 32) + (t % 32) / 4 + 8 (v % 2), columns 2 (t % 4) + 8 (v / 2)
// and + 1.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<80> {
    __device__ static __forceinline__ void mma(float (&d)[40], uint64_t a,
                                               uint64_t b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31,"
            " %32, %33, %34, %35, %36, %37, %38, %39},"
            " %40, %41, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
            : "l"(a), "l"(b), "r"(acc));
    }
};

template <>
struct WgmmaSS<128> {
    __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a,
                                               uint64_t b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31,"
            " %32, %33, %34, %35, %36, %37, %38, %39,"
            " %40, %41, %42, %43, %44, %45, %46, %47,"
            " %48, %49, %50, %51, %52, %53, %54, %55,"
            " %56, %57, %58, %59, %60, %61, %62, %63},"
            " %64, %65, p, 1, 1, 0, 0;\n}\n"
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
            : "l"(a), "l"(b), "r"(acc));
    }
};

template <>
struct WgmmaRS<64> {
    __device__ static __forceinline__ void mma(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31},"
            " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <>
struct WgmmaRS<80> {
    __device__ static __forceinline__ void mma(float (&d)[40],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31,"
            " %32, %33, %34, %35, %36, %37, %38, %39},"
            " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <>
struct WgmmaRS<96> {
    __device__ static __forceinline__ void mma(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31,"
            " %32, %33, %34, %35, %36, %37, %38, %39,"
            " %40, %41, %42, %43, %44, %45, %46, %47},"
            " {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <>
struct WgmmaRS<112> {
    __device__ static __forceinline__ void mma(float (&d)[56],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31,"
            " %32, %33, %34, %35, %36, %37, %38, %39,"
            " %40, %41, %42, %43, %44, %45, %46, %47,"
            " %48, %49, %50, %51, %52, %53, %54, %55},"
            " {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <>
struct WgmmaRS<128> {
    __device__ static __forceinline__ void mma(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31,"
            " %32, %33, %34, %35, %36, %37, %38, %39,"
            " %40, %41, %42, %43, %44, %45, %46, %47,"
            " %48, %49, %50, %51, %52, %53, %54, %55,"
            " %56, %57, %58, %59, %60, %61, %62, %63},"
            " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <>
struct WgmmaRS<256> {
    __device__ static __forceinline__ void mma(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31,"
            " %32, %33, %34, %35, %36, %37, %38, %39,"
            " %40, %41, %42, %43, %44, %45, %46, %47,"
            " %48, %49, %50, %51, %52, %53, %54, %55,"
            " %56, %57, %58, %59, %60, %61, %62, %63,"
            " %64, %65, %66, %67, %68, %69, %70, %71,"
            " %72, %73, %74, %75, %76, %77, %78, %79,"
            " %80, %81, %82, %83, %84, %85, %86, %87,"
            " %88, %89, %90, %91, %92, %93, %94, %95,"
            " %96, %97, %98, %99, %100, %101, %102, %103,"
            " %104, %105, %106, %107, %108, %109, %110, %111,"
            " %112, %113, %114, %115, %116, %117, %118, %119,"
            " %120, %121, %122, %123, %124, %125, %126, %127},"
            " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
              "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
              "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
              "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
              "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
              "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
              "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
              "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
              "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
              "+f"(d[126]), "+f"(d[127])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

// s (64 x 32, f32) = a b^T as WgmmaSS: both bf16 K-major in shared memory
template <>
struct WgmmaSS<32> {
    __device__ static __forceinline__ void mma(float (&d)[16], uint64_t a,
                                               uint64_t b, int acc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15},"
            " %16, %17, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "l"(a), "l"(b), "r"(acc));
    }
};

// o (64 x 64, f32) += a (64 x 16, bf16 registers, as WgmmaRS) b^T with b
// (64 x 16) K-major in shared memory (desc_sw128)
struct WgmmaRSK64 {
    __device__ static __forceinline__ void mma(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            " %0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31},"
            " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};


// -- 3xTF32 ---------------------------------------------------------------

__device__ __forceinline__ float to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return __uint_as_float(r);
}

__device__ __forceinline__ void split1(float x, float& hi, float& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - hi);
}

// split1 on the integer pipes: round to nearest with ties away from zero
// by adding half of the dropped 13 bits to the magnitude and clearing
// them, bit for bit cvt.rna's result for finite x (and
// _dispatch._tf32's). cvt runs on the conversion pipe, a quarter of the
// FMA rate; a kernel that splits every operand of every product itself
// (ssd_chunk) takes this one.
__device__ __forceinline__ float to_tf32_int(float x) {
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split1_int(float x, float& hi, float& lo) {
    hi = to_tf32_int(x);
    lo = to_tf32_int(x - hi);
}

// x <- hi(x), lo <- lo(x) over `bytes` of a tile; threads [tid, nthr)
__device__ __forceinline__ void split_tile(void* x, void* lo, int bytes,
                                           int tid, int nthr) {
    float4* xv = static_cast<float4*>(x);
    float4* lv = static_cast<float4*>(lo);
    for (int i = tid; i < bytes / 16; i += nthr) {
        float4 v = xv[i], h, l;
        split1(v.x, h.x, l.x);
        split1(v.y, h.y, l.y);
        split1(v.z, h.z, l.z);
        split1(v.w, h.w, l.w);
        xv[i] = h;
        lv[i] = l;
    }
}

// A fragments of one stage: 4 k-steps x 4 values (layout at Wgmma)
constexpr int AFRAG = 4 * (BK / 8);

// element (r, c) of a 128-byte-swizzled tile of BK-float rows: the
// 16-byte chunk c / 4 of row r sits at chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ int sw128(int r, int c) {
    return r * BK + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// this thread's A fragment values of a stage from its warpgroup's 64-row
// tile (a - b when `b` is given, one f32 subtraction)
__device__ __forceinline__ void read_a(const float* a, const float* b,
                                       float (&x)[AFRAG]) {
    const int lane = threadIdx.x % 32;
    const int r = (threadIdx.x / 32) % 4 * 16 + lane / 4;
    #pragma unroll
    for (int k = 0; k < BK / 8; ++k) {
        #pragma unroll
        for (int v = 0; v < 4; ++v) {
            const int off = sw128(r + 8 * (v % 2), 8 * k + lane % 4 + 4 * (v / 2));
            x[4 * k + v] = b ? a[off] - b[off] : a[off];
        }
    }
}

__device__ __forceinline__ void split_a(const float (&x)[AFRAG],
                                        float (&hi)[AFRAG],
                                        float (&lo)[AFRAG]) {
    #pragma unroll
    for (int i = 0; i < AFRAG; ++i) split1(x[i], hi[i], lo[i]);
}

// read_a, then split_a
__device__ __forceinline__ void load_a(const float* a, const float* b,
                                       float (&hi)[AFRAG],
                                       float (&lo)[AFRAG]) {
    float x[AFRAG];
    read_a(a, b, x);
    split_a(x, hi, lo);
}

// issue one stage's 3xTF32 wgmmas into the fresh accumulator tmp: for
// each k-step of 8, hi.lo, lo.hi, then hi.hi. b_*: the N rows, 1024-byte
// aligned.
template <int N>
__device__ __forceinline__ void issue_stage(float (&tmp)[N / 2],
                                            float (&a_hi)[AFRAG],
                                            float (&a_lo)[AFRAG],
                                            const void* b_hi,
                                            const void* b_lo) {
    #pragma unroll
    for (int i = 0; i < N / 2; ++i) tmp[i] = 0.f;
    fence_acc(tmp);
    fence_acc(a_hi);
    fence_acc(a_lo);
    wgmma_fence();
    const uint64_t bh = desc_sw128(b_hi), bl = desc_sw128(b_lo);
    #pragma unroll
    for (int k = 0; k < BK / 8; ++k) {      // 32 bytes = 2 units a k-step
        Wgmma<N>::mma(tmp, a_hi + 4 * k, bl + 2 * k);
        Wgmma<N>::mma(tmp, a_lo + 4 * k, bh + 2 * k);
        Wgmma<N>::mma(tmp, a_hi + 4 * k, bh + 2 * k);
    }
    wgmma_commit();
}

// retire this warpgroup's wgmmas (whose A registers stay untouched until
// here) and promote tmp into acc (f32, round to nearest)
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N / 2],
                                        float (&tmp)[N / 2],
                                        float (&a_hi)[AFRAG],
                                        float (&a_lo)[AFRAG]) {
    wgmma_wait<0>();
    fence_acc(tmp);
    fence_acc(a_hi);
    fence_acc(a_lo);
    #pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += tmp[i];
}

// the ring's barriers: `full` completes when a stage's TMA bytes landed,
// `empty` when both warpgroups released the stage
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 2);        // one arrival a warpgroup
        }
        fence_barrier_init();
    }
    __syncthreads();
}

// this warpgroup is done with iteration j's slot; thread 0 refills the
// slot with iteration j + stages (of `total`) once both warpgroups are
template <typename Load>
__device__ __forceinline__ void release(uint64_t* empty, int j, int stages,
                                        int total, Load& load) {
    const int s = j % stages;
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && j + stages < total) {
        mbar_wait(&empty[s], (j / stages) & 1);
        load(j + stages);
    }
    __syncwarp();
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
    const uint32_t a = smem_addr(p);
    return p + ((ALIGN - a % ALIGN) % ALIGN);
}

// -- the split-K partial product --------------------------------------------

// Shared memory of partial_product: the aligned ring of raw stages, two
// lo buffers of the N side, the full / empty barriers (+ ALIGN of slack).
__host__ __device__ constexpr int partial_stage_bytes(int n, bool diff) {
    return (diff ? 2 : 1) * A_BYTES + n * ROW_BYTES;
}

__host__ __device__ constexpr int partial_smem(int n, bool diff, int stages) {
    return ALIGN + stages * partial_stage_bytes(n, diff) + 2 * n * ROW_BYTES
        + 2 * stages * 8;
}

// The default epilogue of partial_product: the slice's partial sum to
// out[s * ss + m * sm + n * sn].
struct StorePartial {
    float* out;
    long long ss, sm, sn;
    __device__ __forceinline__ void operator()(int s, int m, int n,
                                               float v) const {
        out[s * ss + (long long)m * sm + (long long)n * sn] = v;
    }
};

// epi(s, m, n, sum over k in slice s of A[m, k] B[n, k]) with A = A1 - A2
// when DIFF (rows of one f32 subtraction, as z = xs - ys), for m < m_rows,
// n < n_rows: StorePartial by default, or another hook over the f32
// accumulator fragment (pairwise_dist's distance epilogue). Grid (M tiles
// x N tiles, slices), the M tile fastest (blockIdx.x % M tiles), so
// neither axis is held to the grid's y limit; the slices (kchunk columns
// each, a multiple of BK) are the slowest grid axis, so blocks in flight
// together read the same columns through L2. A reaches the wgmmas from
// registers (each warpgroup loads and splits its own 64 rows); B, shared
// by both warpgroups, is split in shared memory.
template <int N, bool DIFF, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
partial_product(const __grid_constant__ CUtensorMap a1,
                const __grid_constant__ CUtensorMap a2,
                const __grid_constant__ CUtensorMap b, const Epi epi,
                int m_rows, int n_rows, int k_len, int kchunk, int stages) {
    constexpr int B_BYTES = N * ROW_BYTES;
    constexpr int STAGE = partial_stage_bytes(N, DIFF);
    constexpr int B_AT = (DIFF ? 2 : 1) * A_BYTES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = align_smem(smem_raw);
    unsigned char* lo_base = base + stages * STAGE;
    uint64_t* full = reinterpret_cast<uint64_t*>(lo_base + 2 * B_BYTES);
    uint64_t* empty = full + stages;

    const int mtiles = (m_rows + BM - 1) / BM;
    const int m0 = (blockIdx.x % mtiles) * BM, n0 = (blockIdx.x / mtiles) * N;
    const int k0 = blockIdx.y * kchunk;
    const int steps = (min(k_len, k0 + kchunk) - k0 + BK - 1) / BK;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    init_ring(full, empty, stages);

    // thread 0: iteration j's slices into slot j % stages
    auto load = [&](int j) {
        const int s = j % stages;
        unsigned char* st = base + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        const int col = k0 + j * BK;
        tma_load(st, &a1, &full[s], col, m0);
        if (DIFF) tma_load(st + A_BYTES, &a2, &full[s], col, m0);
        tma_load(st + B_AT, &b, &full[s], col, n0);
    };
    const int tid = threadIdx.x, wg = warp / 4;
    if (tid == 0)
        for (int j = 0; j < min(stages, steps); ++j) load(j);

    float acc[N / 2], tmp[N / 2], a_hi[AFRAG], a_lo[AFRAG];
    #pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < steps; ++it) {
        const int s = it % stages;
        unsigned char* st = base + s * STAGE;
        unsigned char* lo = lo_base + (it & 1) * B_BYTES;
        mbar_wait(&full[s], (it / stages) & 1);
        // both warpgroups are past iteration it - 1, which retired their
        // wgmmas of it - 2, the last to read lo buffer it & 1
        named_sync(1, THREADS);
        split_tile(st + B_AT, lo, B_BYTES, tid, THREADS);
        // this warpgroup's 64 rows of A (z = xs - ys under DIFF), read
        // while the wgmmas of it - 1 run; split once they retired
        const float* a = reinterpret_cast<const float*>(st) + wg * 64 * BK;
        float x[AFRAG];
        read_a(a, DIFF ? a + BM * BK : nullptr, x);
        fence_proxy_async();
        named_sync(1, THREADS);
        if (it > 0) {
            promote<N>(acc, tmp, a_hi, a_lo);
            release(empty, it - 1, stages, steps, load);
        }
        split_a(x, a_hi, a_lo);
        issue_stage<N>(tmp, a_hi, a_lo, st + B_AT, lo);
    }
    promote<N>(acc, tmp, a_hi, a_lo);

    const int wl = warp % 4;
    #pragma unroll
    for (int i = 0; i < N / 8; ++i) {
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = m0 + wg * 64 + wl * 16 + lane / 4 + 8 * h;
            const int n = n0 + 8 * i + 2 * (lane % 4);
            if (m >= m_rows) continue;
            if (n < n_rows) epi(blockIdx.y, m, n, acc[4 * i + 2 * h]);
            if (n + 1 < n_rows) epi(blockIdx.y, m, n + 1, acc[4 * i + 2 * h + 1]);
        }
    }
}

// -- host ------------------------------------------------------------------------

// cuTensorMapEncodeTiled into *fn, looked up through the CUDA runtime's
// entry-point query (no -lcuda). Returns a cudaError_t.
inline int tensor_map_encoder(PFN_cuTensorMapEncodeTiled* fn) {
    static PFN_cuTensorMapEncodeTiled encode_fn = nullptr;
    if (encode_fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess) return (int)err;
        if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
            return (int)cudaErrorSymbolNotFound;
        encode_fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(ptr);
    }
    *fn = encode_fn;
    return 0;
}

// A row-major (rows, cols) f32 tensor as a TMA map of boxes BK x box_rows
// with the 128-byte swizzle and zero fill past its edges. cols * 4 must be
// a multiple of 16 and ptr 16-byte aligned. Returns a cudaError_t.
inline int encode(CUtensorMap* map, const float* ptr, long long cols,
                  long long rows, int box_rows) {
    PFN_cuTensorMapEncodeTiled encode_fn;
    if (int err = tensor_map_encoder(&encode_fn)) return err;
    if (cols < 1 || rows < 1 || (cols * 4) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
    cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
    cuuint32_t elem[2] = {1, 1};
    CUresult r = encode_fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                           const_cast<float*>(ptr), dims, strides, box, elem,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launch partial_product<N, DIFF, Epi> on `stream` (a2 unused unless
// DIFF). Returns the first non-zero cudaError_t, else 0.
template <int N, bool DIFF, class Epi>
int launch_partial_epi(const float* a1, const float* a2, const float* b,
                       const Epi& epi, int m_rows, int n_rows, int k_len,
                       int ksplit, int kchunk, int stages,
                       cudaStream_t stream) {
    const long long tiles =
        (long long)((m_rows + BM - 1) / BM) * ((n_rows + N - 1) / N);
    if (kchunk % BK != 0 || ksplit < 1 || ksplit > 65535 || stages < 2 ||
        tiles > 0x7fffffffLL || partial_smem(N, DIFF, stages) > SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    CUtensorMap ma1, ma2, mb;
    int err;
    if ((err = encode(&ma1, a1, k_len, m_rows, BM)) != 0) return err;
    if ((err = encode(&ma2, DIFF ? a2 : a1, k_len, m_rows, BM)) != 0)
        return err;
    if ((err = encode(&mb, b, k_len, n_rows, N)) != 0) return err;
    const int smem = partial_smem(N, DIFF, stages);
    cudaError_t e = cudaFuncSetAttribute(
        partial_product<N, DIFF, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    partial_product<N, DIFF, Epi><<<dim3((unsigned)tiles, ksplit), THREADS,
                                     smem, stream>>>(
        ma1, ma2, mb, epi, m_rows, n_rows, k_len, kchunk, stages);
    return (int)cudaGetLastError();
}

// partial_product with the StorePartial epilogue: slice s's partial sums
// to out[s * ss + m * sm + n * sn]
template <int N, bool DIFF>
int launch_partial(const float* a1, const float* a2, const float* b,
                   float* out, int m_rows, int n_rows, int k_len, int ksplit,
                   int kchunk, int stages, long long ss, long long sm,
                   long long sn, cudaStream_t stream) {
    return launch_partial_epi<N, DIFF>(a1, a2, b, StorePartial{out, ss, sm, sn},
                                       m_rows, n_rows, k_len, ksplit, kchunk,
                                       stages, stream);
}

}  // namespace tf32x3
