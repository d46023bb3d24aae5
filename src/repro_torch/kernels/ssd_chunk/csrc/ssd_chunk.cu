// Mamba2 SSD scan for Hopper (sm_90a): segment-parallel over T, every
// product on the tensor cores at f32 accuracy, bf16 or f32 inputs.
//
// Replaces the TPU kernel repro/kernels/ssd_chunk/kernel.py::_ssd_kernel
// (launched by ssd_scan, :80) and computes the same function for every
// pane (b, h), with p = head dim and n = state size:
//
//   h_t = exp(la_t) h_{t-1} + dt_t x_t B_t^T      (h: p x n, h_0 = 0)
//   y_t = h_t C_t
//
// returning y in x's dtype and the final h in f32, f32 arithmetic
// throughout. By chunks of Q = 64 steps, with W the inclusive prefix sum
// of la over the chunk:
//
//   y   = exp(W) o (C h^T) + (select(s <= t, C B^T o exp(W_t - W_s)) dt_s) x
//   h'  = exp(W_last) h + (x o dt exp(W_last - W))^T B
//
// What bounds it. At the zamba2-2.7b embedding service's shapes (B 4,
// T 8192, 80 heads, p = n = 64, bf16) a call needs, at Q = 64, 2 ((Q + 1)
// / 2 p + 2 p n) = 20,544 FLOP per (token, head) (the lower triangle of
// att . x, C h^T and the state update) and 2 (Q + 1) / 2 n = 4,160 per
// token for the lower triangle of C B^T, which all heads of a batch row
// share: 54.0 GFLOP. It moves 0.705 GB (x read and y written, 335 MB each
// in bf16; B and C 4.2 MB each; dt and la 10.5 MB each; h 5.2 MB): 0.210
// ms at 3.35 TB/s. In this kernel's bf16 arithmetic (below: three bf16
// wgmma passes a product, at 989 / 3 TFLOP/s, and C B^T in one, at 989)
// the products need 0.163 ms, so the memory bounds it, with the tensor
// cores close behind; f32 inputs at the 3xTF32 rate (165 TFLOP/s) need
// 0.327 ms and are bound by the tensor cores. (The segments below add a
// state pass: one more state update and one more read of x and B.)
//
// What the design does about it.
//  - Segments. The TPU kernel runs a (pane, chunk) grid with the chunk
//    axis sequential and the state in VMEM. One block a pane walking all
//    128 chunks leaves 320 blocks of one long chain each. Here T is cut
//    into S segments of whole chunks (kernel.py's segment_plan: at least
//    4 x 132 blocks where T allows; 4 segments of 32 chunks, 640 blocks,
//    at the service's shapes). A state pass (ssd_chunk_states, one block
//    per batch row, head pair and segment but the last, two blocks an SM
//    for bf16) runs the chunk loop doing only the state update from h = 0
//    and writes the segment's end state E_s (p x n, f32) and its total log
//    decay L_s = sum la. The scan pass (ssd_chunk_scan, one block per
//    batch row, head pair and segment) starts from h_start(s), combined
//    in its prologue from E_0 .. E_{s-1}: h_start(0) = 0, h_start(j + 1)
//    = exp(L_j) h_start(j) + E_j. That costs s reads of a 16 KB state a
//    head, from L2, where a combine launch would write and read every
//    start state once more and add a launch; S stays at 32 or less.
//    h_final is the last segment's end state after its scan. exp(L_j)
//    underflows to 0 over a long decay, which is right. Chunk-granular
//    state passing would move 2.7 GB of chunk states at these shapes;
//    segments cost one more read of x and B and one more state update.
//  - Tensor cores. A block is two warpgroups, one a head; both heads share
//    the batch row's B and C. Every product is a wgmma, computed
//    transposed so that the state never leaves the registers: with M = p
//    (64-row tiles),
//      y_inter^T = h C^T       (K = n)      y_intra^T = x^T att^T (K = s)
//      dS        = (x o src)^T B (K = s),   and G^T = B C^T (M = s, K = n),
//    each into a fresh accumulator; the carried state is promoted with f32
//    arithmetic, h = exp(W_last) h + dS (the tensor cores truncate as
//    they add). C B^T is computed once per head pair: each warpgroup
//    computes half of G^T's columns and writes att for both heads from
//    them. h C^T of a single state tile runs while att is written.
//  - bf16 inputs: bf16 wgmma (k16), f32-accurate. One side of every
//    product is exact in bf16 (C, x, B; both sides of C B^T); the f32
//    side (h, att, x o src) goes in as three bf16 pieces (split3 below),
//    whose products with the exact side are exact in f32: three passes
//    at the bf16 rate (989 / 3 TFLOP/s) lose less than 2xTF32 would
//    (tests/test_torch_bf16x3.py). B and C are used as TMA lands them:
//    K-major for C B^T and h C^T, MN-major (the transpose bit) for dS;
//    att is stored transposed, MN-major, in three bf16 tiles. The state's
//    accumulator fragment is the A fragment of h C^T as it stands, and
//    x's A fragments are read from the landed tile, exact. Nothing else
//    is copied.
//  - f32 inputs: TF32 wgmma (k8), 3xTF32 as in tf32x3_sm90.cuh (hi and lo
//    by split1_int, on the integer pipes). TF32 operands must be K-major
//    f32 in shared memory, so C (its columns permuted within each group
//    of 8 to the state fragment's order 0 2 4 6 1 3 5 7, so that the
//    fragment feeds h C^T in place), B^T and att are copied into operand
//    tiles, hi and lo each.
//  - Staging. Chunk c + 1's x (a box a head), B and C come in by TMA over
//    4-D tensor maps of the model layout while chunk c computes (bf16: two
//    stages; f32: one, its B and C landing in the att tiles), 128-byte
//    rows with the 128-byte swizzle, the layout wgmma reads and one that
//    keeps the A-fragment reads free of bank conflicts; dt and la by
//    4-byte cp.async. Strides that no tensor map describes (not multiples
//    of 16 bytes) land in the same layout by 4-byte cp.async (f32) or
//    plain loads (bf16), so any strided view runs. One warp per head
//    takes the prefix sum of la. y is staged in shared memory and leaves
//    in 16-byte rows.
// What holds it back now (PERF.md): every phase of a chunk (G^T and att,
// the three products, the write-out) waits at a block barrier, and with
// one block of 8 warps an SM each phase's latency shows; development
// builds without one phase each put att (32 decays, splits and 48 stores
// a thread) first. Next: att of chunk c + 1 while chunk c's products run
// (its bf16 pieces leave room for a second att buffer).
// Rows past T and columns past p and n are zero (TMA's or cp.async's
// zero fill, a zeroed stage, masked conversion), which is exact: zero x,
// B, C, dt and la add nothing and decay nothing. Scores above the
// diagonal are selected away, never multiplied by a mask: exp(W_t - W_s)
// is inf there, so the select is on the exponent (-inf above the
// diagonal, W_t - W_s below it for any sign of la). B and C are read
// through a head stride; when it is not 0 (each head its own B and C) a
// block takes one head and its second warpgroup idles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <utility>

#include "../../csrc/tf32x3_sm90.cuh"

namespace {

namespace sm90 = tf32x3;    // barriers, TMA, wgmma, swizzle, split, fences

constexpr int Q = 64;               // chunk length
constexpr int HG = 2;               // heads of a block: one a warpgroup
constexpr int THREADS = 256;
constexpr int MAX_SEGS = 32;
constexpr int OP = 64 * 64 * 4;     // a 64-row, 64-column f32 operand tile:
                                    // two 32-column panels of 8 KB

struct Params {
    int H, T, p, n;
    int cps, segs, groups, hpb;     // chunks a segment, segments, head
                                    // groups, heads a block (1 or 2)
    int tma;                        // x, B and C come in by TMA
    int y_lg;                       // log2 of the 16-byte copies of a y
                                    // row; -1: element copies
    long long x_b, x_h, x_t;        // element strides (last dim contiguous)
    long long b_b, b_h, b_t;
    long long c_b, c_h, c_t;
    long long dt_b, dt_h, dt_t;
    long long la_b, la_h, la_t;
    long long y_b, y_h, y_t;
};

// -- shared memory ------------------------------------------------------------

// Operand tiles first, then the landed chunk stages, then the stages'
// mbarriers; every tile 1024-byte aligned. A landed tile is what TMA
// writes: rows of 128 bytes (BW = 128 / sizeof(T) columns) with the
// 128-byte swizzle, wider rows in boxes of BW columns one after the
// other. x: one tile a head, row s; B, C: row s, 64 columns (n <= 64);
// then per head the vectors dt, W (over la), src = dt exp(W_last - W) and
// exp(W). The operand tiles: for f32 the TF32 tiles C (permuted), B^T and
// att, hi and lo each; for bf16 only att, as three bf16 pieces a head
// (B and C are read as landed).
template <typename T, int P, bool SCAN>
struct Smem {
    static constexpr bool F32 = sizeof(T) == 4;
    static constexpr int NST = (F32 && SCAN) ? 1 : 2;
    static constexpr int BW = 128 / (int)sizeof(T);
    static constexpr int NBX = P / BW, NBC = 64 / BW;   // boxes of a row
    static constexpr int X_HEAD = NBX * Q * 128;
    static constexpr int X_RAW = HG * X_HEAD;
    static constexpr int BC_RAW = NBC * Q * 128;
    static constexpr int V_RAW = 4 * HG * Q * 4;
    static constexpr int PIECE = Q * 64 * 2;                // a bf16 att piece
    static constexpr int CP = 0;                            // C, permuted
    static constexpr int BT = CP + (F32 && SCAN ? 2 * OP : 0);  // B^T
    static constexpr int ATT = BT + (F32 ? 2 * OP : 0);
    static constexpr int ATT_BYTES = !SCAN ? 0 : F32 ? 4 * OP : HG * 3 * PIECE;
    // bf16 scans: y of both heads, staged apart from the TMA tiles (a
    // generic write there would need a proxy fence before the next TMA)
    static constexpr int YB = ATT + ATT_BYTES;
    static constexpr int Y_BYTES = (SCAN && !F32) ? X_RAW : 0;
    static constexpr int STAGE0 = YB + Y_BYTES;
    // f32 scans land B and C in the att tiles (dead until G^T)
    static constexpr bool BC_IN_ATT = F32 && SCAN;
    static constexpr int BC_STAGE = BC_IN_ATT ? 0 : (SCAN ? 2 : 1) * BC_RAW;
    static constexpr int STAGE = X_RAW + BC_STAGE + V_RAW;
    static constexpr int BARS = STAGE0 + NST * STAGE;
    static constexpr int BYTES = BARS + 8 * NST;
    static constexpr int X_BYTES = X_RAW;                   // TMA bytes a
    static constexpr int BC_BYTES = (SCAN ? 2 : 1) * BC_RAW;  // stage
    static_assert(!BC_IN_ATT || 2 * BC_RAW <= 4 * OP, "B, C fit in att");
    static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned");
    static_assert(sm90::ALIGN + BYTES <= sm90::SMEM_LIMIT, "shared memory");

    __device__ static int x_raw(int s, int w) {
        return STAGE0 + s * STAGE + w * X_HEAD;
    }
    __device__ static int b_raw(int s) {
        return BC_IN_ATT ? ATT : STAGE0 + s * STAGE + X_RAW;
    }
    __device__ static int c_raw(int s) { return b_raw(s) + BC_RAW; }
    __device__ static int v_raw(int s) {
        return STAGE0 + s * STAGE + X_RAW + BC_STAGE;
    }
    // bf16: piece q of head w's att, rows s, columns t
    __device__ static int att(int w, int q) {
        return ATT + (w * 3 + q) * PIECE;
    }
};

// byte offset of element (row, col) in a landed tile of `rows` rows
template <typename T>
__device__ __forceinline__ int raw_at(int rows, int row, int col) {
    constexpr int BW = 128 / (int)sizeof(T);
    const int cb = (col % BW) * (int)sizeof(T);
    return (col / BW) * rows * 128 + row * 128
        + ((((cb >> 4) ^ row) & 7) << 4) + (cb & 15);
}

// element (r, c) of a 64-row operand tile (c < 64), in floats
__device__ __forceinline__ int op_at(int r, int c) {
    return (c >> 5) * (64 * sm90::BK) + sm90::sw128(r, c & 31);
}

// descriptor of k-step kk (8 columns) of an operand tile from row `row`
__device__ __forceinline__ uint64_t op_desc(const unsigned char* tile,
                                            int row, int kk) {
    return sm90::desc_sw128(tile + (kk >> 2) * (64 * sm90::ROW_BYTES)
                            + row * sm90::ROW_BYTES) + 2 * (kk & 3);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
    *dst = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float raw_f32(const unsigned char* tile, int rows,
                                         int row, int col) {
    return to_f32(*reinterpret_cast<const T*>(tile
                                              + raw_at<T>(rows, row, col)));
}

// 8 landed f32 elements (row, k0 .. k0 + 7) of a 64-row tile, k0 % 8 == 0
__device__ __forceinline__ void load8(const unsigned char* tile, int row,
                                      int k0, float (&x)[8]) {
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(
            tile + raw_at<float>(64, row, k0 + 4 * h));
        x[4 * h] = a.x; x[4 * h + 1] = a.y; x[4 * h + 2] = a.z;
        x[4 * h + 3] = a.w;
    }
}

// -- staging ------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(sm90::smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The landed-tile layout without TMA, for strides TMA cannot describe:
// `nrows` rows (row r from src + r * stride) of `len` elements into the
// tile at row r * rstep + roff; rows at or past `rows` are zero. f32 by
// 4-byte cp.async, bf16 by plain loads.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* tile, int tile_rows,
                                           int rstep, int roff, const T* src,
                                           long long stride, int len,
                                           int rows) {
    for (int i = threadIdx.x; i < Q * len; i += THREADS) {
        const int r = i / len, c = i - r * len;
        const bool ok = r < rows;
        T* dst = reinterpret_cast<T*>(
            tile + raw_at<T>(tile_rows, r * rstep + roff, c));
        const T* s = src + (long long)(ok ? r : 0) * stride + c;
        if constexpr (sizeof(T) == 4)
            cp_async4(dst, s, ok);
        else
            *dst = ok ? *s : T(0.f);
    }
}

// hi and lo of every value (the f32 split) on the integer pipes
template <int R>
__device__ __forceinline__ void split_all(const float (&x)[R], float (&hi)[R],
                                          float (&lo)[R]) {
    #pragma unroll
    for (int i = 0; i < R; ++i) sm90::split1_int(x[i], hi[i], lo[i]);
}

// acc += A B^T over k-steps [k0, k1) of a 64-column-K operand tile pair:
// A from registers (hi, and lo when A_SPLIT; k-step kk's 4 values at
// 4 (kk - k0)), B's hi tile at bh and lo tile at bl (when B_SPLIT); hi.lo,
// lo.hi, then hi.hi, as the header's 3xTF32, without the terms of an
// exact side. Issues and commits; the caller waits.
template <int N, bool A_SPLIT, bool B_SPLIT>
__device__ __forceinline__ void mma_k(float (&acc)[N / 2], const float* ahi,
                                      const float* alo,
                                      const unsigned char* bh,
                                      const unsigned char* bl, int row,
                                      int k0, int k1) {
    #pragma unroll
    for (int kk = k0; kk < k1; ++kk) {
        const uint64_t dh = op_desc(bh, row, kk);
        const int a = 4 * (kk - k0);
        if constexpr (B_SPLIT)
            sm90::Wgmma<N>::mma(acc, ahi + a, op_desc(bl, row, kk));
        if constexpr (A_SPLIT)
            sm90::Wgmma<N>::mma(acc, alo + a, dh);
        sm90::Wgmma<N>::mma(acc, ahi + a, dh);
    }
    sm90::wgmma_commit();
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R]) {
    #pragma unroll
    for (int i = 0; i < R; ++i) x[i] = 0.f;
}

// hi and lo of a state tile's fragment as the A operand of h C^T: the
// accumulator's columns 2 c0, 2 c0 + 1 of each 8 sit at positions c0,
// c0 + 4 of the A fragment (C's columns are stored in that order)
__device__ __forceinline__ void state_as_a(const float (&h)[32],
                                           float (&hi)[32], float (&lo)[32]) {
    #pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
        sm90::split1_int(h[4 * kk + 0], hi[4 * kk + 0], lo[4 * kk + 0]);
        sm90::split1_int(h[4 * kk + 2], hi[4 * kk + 1], lo[4 * kk + 1]);
        sm90::split1_int(h[4 * kk + 1], hi[4 * kk + 2], lo[4 * kk + 2]);
        sm90::split1_int(h[4 * kk + 3], hi[4 * kk + 3], lo[4 * kk + 3]);
    }
}


// -- bf16 pieces ----------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one MUFU.EX2 (about 2 ulp; __expf adds a denormal fix-up around
// it): att's decays, whose arguments are clamped at 0
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The bf16 products take each f32 operand as three bf16 pieces, x = p0 +
// p1 + p2: p0 is x rounded to bf16 (to nearest, ties away from zero: an
// add and an AND on the integer pipes), p1 and p2 the top 8 significant
// bits of what the pieces before them left (an AND); each remainder is
// exact in f32. What remains is below 2^-23 |x| (2xTF32 leaves 2^-22); a
// piece times an exact bf16 value is exact in the tensor cores' f32
// products. split3 packs the pieces of a pair (a, b) (columns c, c + 1 of
// an A fragment) into bf16x2 words.
__device__ __forceinline__ void split3(float a, float b, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
    uint32_t ua = (__float_as_uint(a) + 0x8000u) & 0xffff0000u;
    uint32_t ub = (__float_as_uint(b) + 0x8000u) & 0xffff0000u;
    p0 = __byte_perm(ua, ub, 0x7632);
    a -= __uint_as_float(ua);
    b -= __uint_as_float(ub);
    ua = __float_as_uint(a) & 0xffff0000u;
    ub = __float_as_uint(b) & 0xffff0000u;
    p1 = __byte_perm(ua, ub, 0x7632);
    a -= __uint_as_float(ua);
    b -= __uint_as_float(ub);
    p2 = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// A fragments (m64k16, bf16) of a 64 x 64 f32 accumulator fragment: the
// accumulator's columns 16 j + 2 c0 + {0, 1} and + 8 are k-step j's
// fragment columns as they stand, so a state tile feeds h C^T directly
__device__ __forceinline__ void acc_as_a3(const float (&d)[32],
                                          uint32_t (&a)[3][4][4]) {
    #pragma unroll
    for (int j = 0; j < 4; ++j)
        #pragma unroll
        for (int v = 0; v < 4; ++v)
            split3(d[8 * j + 2 * v], d[8 * j + 2 * v + 1], a[0][j][v],
                   a[1][j][v], a[2][j][v]);
}

// the bf16 pair (s, i), (s + 1, i) of a landed 64-row bf16 tile as one
// A-fragment word (row i, columns s, s + 1)
__device__ __forceinline__ uint32_t x_pair(const unsigned char* tile, int s,
                                           int i) {
    const uint32_t u0 = *reinterpret_cast<const uint16_t*>(
        tile + raw_at<__nv_bfloat16>(Q, s, i));
    const uint32_t u1 = *reinterpret_cast<const uint16_t*>(
        tile + raw_at<__nv_bfloat16>(Q, s + 1, i));
    return u0 | (u1 << 16);
}

template <int J>
__device__ __forceinline__ void fence_a3(uint32_t (&a)[3][J][4]) {
    #pragma unroll
    for (int q = 0; q < 3; ++q) sm90::fence_regs(a[q]);
}

// -- the chunk loop -----------------------------------------------------------

// One block: batch row b, heads g * hpb + w of its warpgroups w, segment
// seg. SCAN: the full scan from the combined start state, writing y (and
// h_final in the last segment); else the state pass, writing E and L.
template <typename T, int P, bool SCAN>
__device__ __forceinline__ void chunk_loop(
        const CUtensorMap* mx, const CUtensorMap* mb, const CUtensorMap* mc,
        const T* __restrict__ xs, const T* __restrict__ bm,
        const T* __restrict__ cm, const float* __restrict__ dt,
        const float* __restrict__ la, T* __restrict__ y,
        float* __restrict__ hout, float* __restrict__ es,
        float* __restrict__ lam, const Params& p) {
    using L = Smem<T, P, SCAN>;
    constexpr int PT = P / 64;              // 64-row tiles of the state
    constexpr bool F32 = L::F32;
    // bf16 with one state tile: h C^T in flight while att is written (a
    // wider state leaves no registers for it)
    constexpr bool EARLY = PT == 1;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = sm90::align_smem(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);

    const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
    const int wi = (tid / 32) % 4;          // warp of the warpgroup
    const int r0 = wi * 16 + lane / 4, c0 = lane % 4;
    int blk = blockIdx.x;
    const int g = blk % p.groups;
    blk /= p.groups;
    const int seg = SCAN ? blk % p.segs : blk % (p.segs - 1);
    const int b = SCAN ? blk / p.segs : blk / (p.segs - 1);
    const int h0 = g * p.hpb;
    int heads[HG];
    #pragma unroll
    for (int w = 0; w < HG; ++w)
        heads[w] = min(h0 + (w < p.hpb ? w : 0), p.H - 1);
    const int hd = heads[wg];
    const bool active = wg < p.hpb && h0 + wg < p.H;
    const int c_begin = seg * p.cps;
    const int c_end = min(c_begin + p.cps, (p.T + Q - 1) / Q);

    // zero every stage once (without TMA, columns past p and n stay zero)
    for (int i = tid; i < L::NST * L::STAGE / 16; i += THREADS)
        reinterpret_cast<float4*>(sm + L::STAGE0)[i] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid == 0) {
        for (int s = 0; s < L::NST; ++s) sm90::mbar_init(&full[s], 1);
        sm90::fence_barrier_init();
    }
    sm90::fence_proxy_async();
    __syncthreads();

    auto issue = [&](int c, int st) {
        const int t0 = c * Q, rows = min(Q, p.T - t0);
        if (p.tma) {
            if (tid == 0) {
                sm90::mbar_expect_tx(&full[st], L::X_BYTES + L::BC_BYTES);
                #pragma unroll
                for (int w = 0; w < HG; ++w)
                    #pragma unroll
                    for (int k = 0; k < L::NBX; ++k)
                        sm90::tma_load_4d(sm + L::x_raw(st, w) + k * Q * 128,
                                          mx, &full[st], k * L::BW, heads[w],
                                          t0, b);
                const int hb = p.b_h == 0 ? 0 : h0;
                #pragma unroll
                for (int k = 0; k < L::NBC; ++k) {
                    sm90::tma_load_4d(sm + L::b_raw(st) + k * Q * 128, mb,
                                      &full[st], k * L::BW, hb, t0, b);
                    if (SCAN)
                        sm90::tma_load_4d(sm + L::c_raw(st) + k * Q * 128, mc,
                                          &full[st], k * L::BW, hb, t0, b);
                }
            }
        } else {
            stage_rows(sm + L::b_raw(st), Q, 1, 0,
                       bm + b * p.b_b + h0 * p.b_h + (long long)t0 * p.b_t,
                       p.b_t, p.n, rows);
            if (SCAN)
                stage_rows(sm + L::c_raw(st), Q, 1, 0,
                           cm + b * p.c_b + h0 * p.c_h + (long long)t0 * p.c_t,
                           p.c_t, p.n, rows);
            #pragma unroll
            for (int w = 0; w < HG; ++w)
                stage_rows(sm + L::x_raw(st, w), Q, 1, 0,
                           xs + b * p.x_b + heads[w] * p.x_h
                               + (long long)t0 * p.x_t,
                           p.x_t, p.p, rows);
        }
        float* v = reinterpret_cast<float*>(sm + L::v_raw(st));
        {   // dt and la of both heads: one element a thread
            const int w = tid / (2 * Q), r = tid % Q;
            const bool is_la = (tid / Q) % 2;
            const bool ok = r < rows;
            const float* src = is_la
                ? la + b * p.la_b + heads[w] * p.la_h
                      + (long long)(t0 + (ok ? r : 0)) * p.la_t
                : dt + b * p.dt_b + heads[w] * p.dt_h
                      + (long long)(t0 + (ok ? r : 0)) * p.dt_t;
            cp_async4(v + ((is_la ? HG : 0) + w) * Q + r, src, ok);
        }
        cp_async_commit();
    };

    // W = inclusive prefix sum of la over stage st's chunk, in place, then
    // src and exp(W): the first warp of each warpgroup for its head, two
    // steps a lane, while the others convert C and B (f32)
    auto prefix = [&](int st) {
        float* v = reinterpret_cast<float*>(sm + L::v_raw(st));
        float* w_ = v + (HG + wg) * Q;
        const float* d_ = v + wg * Q;
        const float a0 = w_[2 * lane], a1 = w_[2 * lane + 1];
        float run = a0 + a1;
        #pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float up = __shfl_up_sync(0xffffffffu, run, off);
            if (lane >= off) run += up;
        }
        const float before = __shfl_up_sync(0xffffffffu, run, 1);
        const float w0 = (lane == 0 ? 0.f : before) + a0;
        const float w1 = w0 + a1;
        const float wl = __shfl_sync(0xffffffffu, w1, 31);
        w_[2 * lane] = w0;
        w_[2 * lane + 1] = w1;
        float* src = v + (2 * HG + wg) * Q;
        float* ew = v + (3 * HG + wg) * Q;
        src[2 * lane] = d_[2 * lane] * expf(wl - w0);
        src[2 * lane + 1] = d_[2 * lane + 1] * expf(wl - w1);
        ew[2 * lane] = expf(w0);
        ew[2 * lane + 1] = expf(w1);
    };
    // the state: PT tiles of the (p x n) accumulator fragment of wgmma
    // m64n64: h[pt][4 j + 2 hh + e] is row 64 pt + r0 + 8 hh, column
    // 8 j + 2 c0 + e
    float h[PT][32];
    #pragma unroll
    for (int pt = 0; pt < PT; ++pt) zero(h[pt]);
    const long long pane = (long long)b * p.H + hd;
    if (SCAN) {
        // h_start(seg) from the state pass's E and L of segments < seg
        for (int j = 0; j < seg; ++j) {
            const long long at = pane * (p.segs - 1) + j;
            const float dec = expf(lam[at]);
            const float* e = es + at * p.p * p.n;
            #pragma unroll
            for (int pt = 0; pt < PT; ++pt)
                #pragma unroll
                for (int q = 0; q < 32; ++q) {
                    const int i = 64 * pt + r0 + 8 * ((q >> 1) & 1);
                    const int k = 8 * (q >> 2) + 2 * c0 + (q & 1);
                    const float ev = i < p.p && k < p.n ? e[i * p.n + k] : 0.f;
                    h[pt][q] = dec * h[pt][q] + ev;
                }
        }
    }
    float lam_sum = 0.f;

    if (L::NST == 2 && c_begin < c_end) issue(c_begin, 0);
    for (int c = c_begin; c < c_end; ++c) {
        const int st = L::NST == 2 ? (c - c_begin) & 1 : 0;
        if (L::NST == 1) {
            __syncthreads();                // everyone is done with c - 1
            issue(c, 0);
        }
        if (p.tma)
            sm90::mbar_wait(&full[st], ((c - c_begin) / L::NST) & 1);
        cp_async_wait_all();
        __syncthreads();                    // chunk c landed; c - 1 done
        if (L::NST == 2 && c + 1 < c_end) issue(c + 1, st ^ 1);

        const unsigned char* braw = sm + L::b_raw(st);
        const unsigned char* craw = sm + L::c_raw(st);
        unsigned char* xw = sm + L::x_raw(st, wg);     // this head's x
        // where this head's y is staged: its x tile for f32 (once read),
        // a tile of its own for bf16
        unsigned char* yw = F32 ? xw : sm + L::YB + wg * L::X_HEAD;
        float* v = reinterpret_cast<float*>(sm + L::v_raw(st));
        float* vdt = v;                     // [HG][Q] each
        float* vw = v + HG * Q;
        float* vsrc = v + 2 * HG * Q;
        float* vew = v + 3 * HG * Q;

        if (wi == 0) prefix(st);
        if constexpr (F32) {
            // B^T into its operand tile: (k, s) = B[s][k], hi and lo
            float* bt = reinterpret_cast<float*>(sm + L::BT);
            for (int i = tid; i < 64 * 16; i += THREADS) {
                const int k = i % 64, s4 = 4 * (i / 64);
                float x4[4], hi[4], lo[4];
                #pragma unroll
                for (int e = 0; e < 4; ++e)
                    x4[e] = k < p.n ? raw_f32<T>(braw, Q, s4 + e, k) : 0.f;
                split_all(x4, hi, lo);
                *reinterpret_cast<float4*>(bt + op_at(k, s4)) =
                    make_float4(hi[0], hi[1], hi[2], hi[3]);
                *reinterpret_cast<float4*>(bt + OP / 4 + op_at(k, s4)) =
                    make_float4(lo[0], lo[1], lo[2], lo[3]);
            }
            if constexpr (SCAN) {
                // C into its operand tile with each group of 8 columns in
                // the order 0 2 4 6 1 3 5 7 (the state fragment's order)
                float* cp = reinterpret_cast<float*>(sm + L::CP);
                for (int i = tid; i < 64 * 8; i += THREADS) {
                    const int t = i / 8, k0 = 8 * (i % 8);
                    float x8[8], o8[8], hi[8], lo[8];
                    load8(craw, t, k0, x8);
                    #pragma unroll
                    for (int e = 0; e < 8; ++e)
                        o8[e] = k0 + 2 * (e & 3) + (e >> 2) < p.n
                            ? x8[2 * (e & 3) + (e >> 2)] : 0.f;
                    split_all(o8, hi, lo);
                    #pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int at = op_at(t, k0 + 4 * half);
                        *reinterpret_cast<float4*>(cp + at) = make_float4(
                            hi[4 * half], hi[4 * half + 1], hi[4 * half + 2],
                            hi[4 * half + 3]);
                        *reinterpret_cast<float4*>(cp + OP / 4 + at) =
                            make_float4(lo[4 * half], lo[4 * half + 1],
                                        lo[4 * half + 2], lo[4 * half + 3]);
                    }
                }
            }
            sm90::fence_proxy_async();
        }
        __syncthreads();                    // W, src, exp(W) (f32: B^T, C)

        const float* srcw = vsrc + wg * Q;
        const float ewl = vew[wg * Q + Q - 1];
        if constexpr (F32) {
            if constexpr (SCAN) {
                // G^T = B C^T, this warpgroup's 32 of the 64 t columns
                float gt[16], ah[32], al[32];   // A fragments of B
                #pragma unroll
                for (int kk = 0; kk < 8; ++kk)
                    #pragma unroll
                    for (int vv = 0; vv < 4; ++vv) {
                        // row s = r0 + 8 (vv % 2), column k = 8 kk + 2 c0
                        // + vv / 2 (C's column order)
                        const int s = r0 + 8 * (vv & 1);
                        const int k = 8 * kk + 2 * c0 + (vv >> 1);
                        const float* bt = reinterpret_cast<const float*>(
                            sm + L::BT);
                        ah[4 * kk + vv] = bt[op_at(k, s)];
                        al[4 * kk + vv] = bt[OP / 4 + op_at(k, s)];
                    }
                zero(gt);
                sm90::fence_acc(gt);
                sm90::fence_acc(ah);
                sm90::fence_acc(al);
                sm90::wgmma_fence();
                mma_k<32, true, true>(gt, ah, al, sm + L::CP, sm + L::CP + OP,
                                      32 * wg, 0, 8);
                sm90::wgmma_wait<0>();
                sm90::fence_acc(gt);
                sm90::fence_acc(ah);
                sm90::fence_acc(al);
                // att of both heads: att_w(t, s) = G(t, s) exp(W_t - W_s)
                // dt_s for s <= t, else 0, selected (exp overflows above
                // the diagonal, so its argument is clamped at 0 there).
                #pragma unroll
                for (int w = 0; w < HG; ++w) {
                    float* att_hi = reinterpret_cast<float*>(sm + L::ATT
                                                             + w * OP);
                    float* att_lo = reinterpret_cast<float*>(
                        sm + L::ATT + (HG + w) * OP);
                    const float* w_ = vw + w * Q;
                    const float* d_ = vdt + w * Q;
                    #pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int s = r0 + 8 * hh;
                        const float ws = w_[s], ds = d_[s];
                        #pragma unroll
                        for (int j = 0; j < 4; ++j)
                            #pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const int t = 32 * wg + 8 * j + 2 * c0 + e;
                                // select on the exponent: e^-inf = 0
                                // above the diagonal, any la below it
                                const float dec = __expf(
                                    s <= t ? w_[t] - ws : -INFINITY) * ds;
                                const float a = s <= t
                                    ? gt[4 * j + 2 * hh + e] * dec : 0.f;
                                float hi, lo;
                                sm90::split1_int(a, hi, lo);
                                att_hi[op_at(t, s)] = hi;
                                att_lo[op_at(t, s)] = lo;
                            }
                    }
                }
                sm90::fence_proxy_async();
                __syncthreads();            // att of both heads written
            }
            #pragma unroll
            for (int pt = 0; pt < PT; ++pt) {
                float yv[32], yacc[32], hhi[32], hlo[32], acc[32], ds[32],
                    shi[32], slo[32];
                if constexpr (SCAN) {
                    // y_inter^T = h C^T
                    state_as_a(h[pt], hhi, hlo);
                    zero(yacc);
                    sm90::fence_acc(yacc);
                    sm90::fence_acc(hhi);
                    sm90::fence_acc(hlo);
                    sm90::wgmma_fence();
                    mma_k<64, true, true>(yacc, hhi, hlo, sm + L::CP,
                                          sm + L::CP + OP, 0, 0, 8);
                    sm90::wgmma_wait<0>();
                    sm90::fence_acc(yacc);
                    sm90::fence_acc(hhi);
                    sm90::fence_acc(hlo);
                    #pragma unroll
                    for (int q = 0; q < 32; ++q) {
                        const int t = 8 * (q >> 2) + 2 * c0 + (q & 1);
                        yv[q] = yacc[q] * vew[wg * Q + t];
                    }
                    // y_intra^T = x^T att^T: x's A fragments (row i,
                    // column s) split
                    float xhi[32], xlo[32];
                    #pragma unroll
                    for (int kk = 0; kk < 8; ++kk)
                        #pragma unroll
                        for (int vv = 0; vv < 4; ++vv) {
                            const int s = 8 * kk + c0 + 4 * (vv >> 1);
                            const int i = 64 * pt + r0 + 8 * (vv & 1);
                            sm90::split1_int(raw_f32<T>(xw, Q, s, i),
                                             xhi[4 * kk + vv],
                                             xlo[4 * kk + vv]);
                        }
                    zero(acc);
                    sm90::fence_acc(acc);
                    sm90::fence_acc(xhi);
                    sm90::fence_acc(xlo);
                    sm90::wgmma_fence();
                    mma_k<64, true, true>(acc, xhi, xlo, sm + L::ATT + wg * OP,
                                          sm + L::ATT + (HG + wg) * OP, 0, 0,
                                          8);
                    sm90::wgmma_wait<0>();
                    sm90::fence_acc(acc);
                    sm90::fence_acc(xhi);
                    sm90::fence_acc(xlo);
                    #pragma unroll
                    for (int q = 0; q < 32; ++q) yv[q] += acc[q];
                }
                // dS = (x o src)^T B in two halves of K (the state pass:
                // half the A registers)
                zero(ds);
                #pragma unroll
                for (int half = 0; half < 2; ++half) {
                    #pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
                        #pragma unroll
                        for (int vv = 0; vv < 4; ++vv) {
                            const int s = 8 * (4 * half + kk) + c0
                                + 4 * (vv >> 1);
                            const int i = 64 * pt + r0 + 8 * (vv & 1);
                            sm90::split1_int(
                                raw_f32<T>(xw, Q, s, i) * srcw[s],
                                shi[4 * kk + vv], slo[4 * kk + vv]);
                        }
                    sm90::fence_acc(ds);
                    sm90::fence_acc(shi);
                    sm90::fence_acc(slo);
                    sm90::wgmma_fence();
                    mma_k<64, true, true>(ds, shi, slo, sm + L::BT,
                                          sm + L::BT + OP, 0, 4 * half,
                                          4 * half + 4);
                    sm90::wgmma_wait<0>();
                    sm90::fence_acc(ds);
                    sm90::fence_acc(shi);
                    sm90::fence_acc(slo);
                }
                // promote dS into the state with f32 arithmetic
                #pragma unroll
                for (int i = 0; i < 32; ++i) h[pt][i] = ewl * h[pt][i] + ds[i];
                if constexpr (SCAN) {
                    // y^T into this head's landed x rows, now read; written
                    // out after the tile loop
                    sm90::named_sync(1 + wg, 128);
                    #pragma unroll
                    for (int q = 0; q < 32; ++q) {
                        const int i = 64 * pt + r0 + 8 * ((q >> 1) & 1);
                        const int t = 8 * (q >> 2) + 2 * c0 + (q & 1);
                        store(reinterpret_cast<T*>(xw + raw_at<T>(Q, t, i)),
                              yv[q]);
                    }
                }
            }
        } else {
            // bf16: every product on bf16 wgmma (k16) with the f32 side
            // in three pieces; B and C straight from their landed tiles
            float yacc[32];
            uint32_t ha[3][4][4];           // pieces of a state tile
            if constexpr (SCAN) {
                // G^T = B C^T (both landed K-major), this warpgroup's 32
                // of the 64 t columns
                float gt[16];
                zero(gt);
                sm90::fence_acc(gt);
                sm90::wgmma_fence();
                #pragma unroll
                for (int j = 0; j < 4; ++j)
                    sm90::WgmmaSS<32>::mma(
                        gt, sm90::desc_sw128(braw) + 2 * j,
                        sm90::desc_sw128(craw + 32 * wg * 128) + 2 * j, 1);
                sm90::wgmma_commit();
                if constexpr (EARLY) {
                    // y_inter^T = h C^T of tile 0, run while att is written
                    acc_as_a3(h[0], ha);
                    zero(yacc);
                    sm90::fence_acc(yacc);
                    fence_a3(ha);
                    sm90::wgmma_fence();
                    #pragma unroll
                    for (int q = 0; q < 3; ++q)
                        #pragma unroll
                        for (int j = 0; j < 4; ++j)
                            sm90::WgmmaRSK64::mma(
                                yacc, ha[q][j],
                                sm90::desc_sw128(craw) + 2 * j);
                    sm90::wgmma_commit();
                }
                sm90::wgmma_wait<EARLY ? 1 : 0>();  // G^T is done
                sm90::fence_acc(gt);
                // att of both heads, stored transposed (rows s, columns t,
                // the MN-major B operand of x^T att^T) in three pieces;
                // select as above, no branch while y_inter^T is in flight
                #pragma unroll
                for (int w = 0; w < HG; ++w) {
                    const float* w_ = vw + w * Q;
                    const float* d_ = vdt + w * Q;
                    #pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int s = r0 + 8 * hh;
                        const float ws = w_[s], ds = d_[s];
                        #pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const int t = 32 * wg + 8 * j + 2 * c0;
                            float a[2];
                            #pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const float dec = ex2(
                                    (s <= t + e ? w_[t + e] - ws : -INFINITY)
                                    * LOG2E) * ds;
                                a[e] = s <= t + e
                                    ? gt[4 * j + 2 * hh + e] * dec : 0.f;
                            }
                            uint32_t pc[3];
                            split3(a[0], a[1], pc[0], pc[1], pc[2]);
                            const int at = raw_at<T>(Q, s, t);
                            #pragma unroll
                            for (int q = 0; q < 3; ++q)
                                *reinterpret_cast<uint32_t*>(
                                    sm + L::att(w, q) + at) = pc[q];
                        }
                    }
                }
                sm90::fence_proxy_async();
                __syncthreads();            // att of both heads written
            }
            #pragma unroll
            for (int pt = 0; pt < PT; ++pt) {
                float yv[32], acc[32], ds[32];
                uint32_t xa[4][4], sa[3][4][4];
                if constexpr (SCAN) {
                    if (!EARLY || pt > 0) {     // y_inter^T of tile pt
                        acc_as_a3(h[pt], ha);
                        zero(yacc);
                        sm90::fence_acc(yacc);
                        fence_a3(ha);
                        sm90::wgmma_fence();
                        #pragma unroll
                        for (int q = 0; q < 3; ++q)
                            #pragma unroll
                            for (int j = 0; j < 4; ++j)
                                sm90::WgmmaRSK64::mma(
                                    yacc, ha[q][j],
                                    sm90::desc_sw128(craw) + 2 * j);
                        sm90::wgmma_commit();
                    }
                    sm90::wgmma_wait<0>();
                    sm90::fence_acc(yacc);
                    fence_a3(ha);
                    #pragma unroll
                    for (int q = 0; q < 32; ++q) {
                        const int t = 8 * (q >> 2) + 2 * c0 + (q & 1);
                        yv[q] = yacc[q] * vew[wg * Q + t];
                    }
                }
                if constexpr (!SCAN) {
                    // the state pass: dS = (x o src)^T B in two halves of
                    // K (half the A registers: two blocks share an SM)
                    zero(ds);
                    #pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        uint32_t s2[3][2][4];
                        #pragma unroll
                        for (int jj = 0; jj < 2; ++jj)
                            #pragma unroll
                            for (int vv = 0; vv < 4; ++vv) {
                                const int s = 16 * (2 * half + jj) + 2 * c0
                                    + 8 * (vv >> 1);
                                const int i = 64 * pt + r0 + 8 * (vv & 1);
                                const uint32_t u = x_pair(xw, s, i);
                                split3(__uint_as_float(u << 16) * srcw[s],
                                       __uint_as_float(u & 0xffff0000u)
                                           * srcw[s + 1],
                                       s2[0][jj][vv], s2[1][jj][vv],
                                       s2[2][jj][vv]);
                            }
                        sm90::fence_acc(ds);
                        fence_a3(s2);
                        sm90::wgmma_fence();
                        #pragma unroll
                        for (int q = 0; q < 3; ++q)
                            #pragma unroll
                            for (int jj = 0; jj < 2; ++jj)
                                sm90::WgmmaRS<64>::mma(
                                    ds, s2[q][jj],
                                    sm90::desc_mn_sw128(
                                        braw + (2 * half + jj) * 16 * 128, Q));
                        sm90::wgmma_commit();
                        sm90::wgmma_wait<0>();
                        sm90::fence_acc(ds);
                        fence_a3(s2);
                    }
                    #pragma unroll
                    for (int i = 0; i < 32; ++i)
                        h[pt][i] = ewl * h[pt][i] + ds[i];
                } else {
                    // x's A fragments (row i, columns s, s + 1 of k-step j),
                    // exact
                    #pragma unroll
                    for (int j = 0; j < 4; ++j)
                        #pragma unroll
                        for (int vv = 0; vv < 4; ++vv) {
                            const int s = 16 * j + 2 * c0 + 8 * (vv >> 1);
                            const int i = 64 * pt + r0 + 8 * (vv & 1);
                            xa[j][vv] = x_pair(xw, s, i);
                        }
                    // y_intra^T = x^T att^T: att's pieces as MN-major B
                    zero(acc);
                    sm90::fence_acc(acc);
                    sm90::fence_regs(xa);
                    sm90::wgmma_fence();
                    #pragma unroll
                    for (int q = 0; q < 3; ++q)
                        #pragma unroll
                        for (int j = 0; j < 4; ++j)
                            sm90::WgmmaRS<64>::mma(
                                acc, xa[j],
                                sm90::desc_mn_sw128(
                                    sm + L::att(wg, q) + j * 16 * 128, Q));
                    sm90::wgmma_commit();
                    sm90::wgmma_wait<0>();
                    sm90::fence_acc(acc);
                    sm90::fence_regs(xa);
                    #pragma unroll
                    for (int q = 0; q < 32; ++q) yv[q] += acc[q];
                    // dS = (x o src)^T B: x o src in pieces, B as landed
                    // (MN-major)
                    #pragma unroll
                    for (int j = 0; j < 4; ++j)
                        #pragma unroll
                        for (int vv = 0; vv < 4; ++vv) {
                            const int s = 16 * j + 2 * c0 + 8 * (vv >> 1);
                            const uint32_t u = xa[j][vv];
                            split3(__uint_as_float(u << 16) * srcw[s],
                                   __uint_as_float(u & 0xffff0000u)
                                       * srcw[s + 1],
                                   sa[0][j][vv], sa[1][j][vv], sa[2][j][vv]);
                        }
                    zero(ds);
                    sm90::fence_acc(ds);
                    fence_a3(sa);
                    sm90::wgmma_fence();
                    #pragma unroll
                    for (int q = 0; q < 3; ++q)
                        #pragma unroll
                        for (int j = 0; j < 4; ++j)
                            sm90::WgmmaRS<64>::mma(
                                ds, sa[q][j],
                                sm90::desc_mn_sw128(braw + j * 16 * 128, Q));
                    sm90::wgmma_commit();
                    // y^T into this head's y tile while dS runs; written
                    // out after the tile loop
                    #pragma unroll
                    for (int q = 0; q < 32; ++q) {
                        const int i = 64 * pt + r0 + 8 * ((q >> 1) & 1);
                        const int t = 8 * (q >> 2) + 2 * c0 + (q & 1);
                        store(reinterpret_cast<T*>(yw + raw_at<T>(Q, t, i)),
                              yv[q]);
                    }
                    sm90::wgmma_wait<0>();
                    sm90::fence_acc(ds);
                    fence_a3(sa);
                    // promote dS into the state with f32 arithmetic
                    #pragma unroll
                    for (int i = 0; i < 32; ++i)
                        h[pt][i] = ewl * h[pt][i] + ds[i];
                }
            }
        }
        if constexpr (SCAN) {
            // this head's y rows of the chunk, 16 bytes a copy where they
            // are aligned
            sm90::named_sync(1 + wg, 128);
            const int rows = min(Q, p.T - c * Q);
            T* yg = y + b * p.y_b + hd * p.y_h + (long long)c * Q * p.y_t;
            if (active && p.y_lg >= 0) {
                constexpr int V = 16 / sizeof(T);
                for (int i = tid % 128; i < (rows << p.y_lg); i += 128) {
                    const int r = i >> p.y_lg;
                    const int col = (i & ((1 << p.y_lg) - 1)) * V;
                    *reinterpret_cast<uint4*>(yg + r * p.y_t + col) =
                        *reinterpret_cast<const uint4*>(
                            yw + raw_at<T>(Q, r, col));
                }
            } else if (active) {
                for (int i = tid % 128; i < rows * p.p; i += 128) {
                    const int r = i / p.p, col = i - r * p.p;
                    yg[r * p.y_t + col] = *reinterpret_cast<const T*>(
                        yw + raw_at<T>(Q, r, col));
                }
            }
        }
        lam_sum += vw[wg * Q + Q - 1];
        // f32: this thread's y stores into the stage before TMA refills it
        if constexpr (F32 && SCAN) sm90::fence_proxy_async();
    }

    if (!active) return;
    float* dst;
    if (SCAN) {
        if (seg != p.segs - 1) return;
        dst = hout + pane * p.p * p.n;
    } else {
        const long long at = pane * (p.segs - 1) + seg;
        dst = es + at * p.p * p.n;
        if (tid % 128 == 0) lam[at] = lam_sum;
    }
    #pragma unroll
    for (int pt = 0; pt < PT; ++pt)
        #pragma unroll
        for (int q = 0; q < 32; ++q) {
            const int i = 64 * pt + r0 + 8 * ((q >> 1) & 1);
            const int k = 8 * (q >> 2) + 2 * c0 + (q & 1);
            if (i < p.p && k < p.n) dst[i * p.n + k] = h[pt][q];
        }
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, (P == 64 && sizeof(T) == 2) ? 2 : 1)
ssd_chunk_states(const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mb,
                 const T* __restrict__ xs, const T* __restrict__ bm,
                 const float* __restrict__ dt, const float* __restrict__ la,
                 float* __restrict__ es, float* __restrict__ lam, Params p) {
    chunk_loop<T, P, false>(&mx, &mb, nullptr, xs, bm, nullptr, dt, la,
                            nullptr, nullptr, es, lam, p);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_scan(const __grid_constant__ CUtensorMap mx,
               const __grid_constant__ CUtensorMap mb,
               const __grid_constant__ CUtensorMap mc,
               const T* __restrict__ xs, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ la, T* __restrict__ y,
               float* __restrict__ hout, const float* __restrict__ es,
               const float* __restrict__ lam, Params p) {
    chunk_loop<T, P, true>(&mx, &mb, &mc, xs, bm, cm, dt, la, y, hout,
                           const_cast<float*>(es), const_cast<float*>(lam), p);
}

// -- host ---------------------------------------------------------------------

// true when every stride (in elements) of a dimension longer than 1 is a
// positive multiple of 16 bytes and the base is 16-byte aligned: what a
// TMA tensor map needs
bool tma_ok(const void* ptr, long long eb,
            std::initializer_list<std::pair<long long, long long>> dims) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
    for (auto d : dims)
        if (d.first > 1 && (d.second <= 0 || (d.second * eb) % 16 != 0))
            return false;
    return true;
}

// a (cols, d1, d2, d3) tensor with element strides s1, s2, s3 as a 4-D TMA
// map of boxes (128 bytes of columns, 1, Q, 1), 128-byte swizzle, zeros
// past every edge (a dimension of length 1 gets a 16-byte stride, never
// stepped). Returns a cudaError_t.
int encode4(CUtensorMap* map, const void* ptr, bool bf16, long long cols,
            long long d1, long long d2, long long d3, long long s1,
            long long s2, long long s3) {
    PFN_cuTensorMapEncodeTiled encode_fn;
    if (int err = sm90::tensor_map_encoder(&encode_fn)) return err;
    const long long eb = bf16 ? 2 : 4;
    cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)d1, (cuuint64_t)d2,
                          (cuuint64_t)d3};
    cuuint64_t strides[3] = {(cuuint64_t)(d1 > 1 ? s1 * eb : 16),
                             (cuuint64_t)(d2 > 1 ? s2 * eb : 16),
                             (cuuint64_t)(d3 > 1 ? s3 * eb : 16)};
    cuuint32_t box[4] = {(cuuint32_t)(128 / eb), 1, (cuuint32_t)Q, 1};
    cuuint32_t elem[4] = {1, 1, 1, 1};
    CUresult r = encode_fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           4, const_cast<void*>(ptr), dims, strides, box,
                           elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int P>
int launch_tile(const void* xs, const void* bm, const void* cm,
                const float* dt, const float* la, void* y, float* hout,
                float* es, float* lam, Params p, long long bsz,
                cudaStream_t stream) {
    const T* x = static_cast<const T*>(xs);
    const T* b = static_cast<const T*>(bm);
    const T* c = static_cast<const T*>(cm);
    constexpr bool bf16 = sizeof(T) == 2;
    constexpr long long eb = sizeof(T);
    CUtensorMap mx{}, mb{}, mc{};
    p.tma = tma_ok(xs, eb, {{p.H, p.x_h}, {p.T, p.x_t}, {bsz, p.x_b}}) &&
            tma_ok(bm, eb, {{p.b_h ? p.H : 1, p.b_h}, {p.T, p.b_t},
                            {bsz, p.b_b}}) &&
            tma_ok(cm, eb, {{p.c_h ? p.H : 1, p.c_h}, {p.T, p.c_t},
                            {bsz, p.c_b}});
    int err;
    if (p.tma &&
        ((err = encode4(&mx, x, bf16, p.p, p.H, p.T, bsz, p.x_h, p.x_t,
                        p.x_b)) != 0 ||
         (err = encode4(&mb, b, bf16, p.n, p.b_h ? p.H : 1, p.T, bsz, p.b_h,
                        p.b_t, p.b_b)) != 0 ||
         (err = encode4(&mc, c, bf16, p.n, p.c_h ? p.H : 1, p.T, bsz, p.c_h,
                        p.c_t, p.c_b)) != 0))
        return err;
    cudaError_t e;
    if (p.segs > 1) {
        const int smem = sm90::ALIGN + Smem<T, P, false>::BYTES;
        e = cudaFuncSetAttribute(ssd_chunk_states<T, P>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        if (e != cudaSuccess) return (int)e;
        const long long blocks = bsz * p.groups * (p.segs - 1);
        ssd_chunk_states<T, P><<<(unsigned)blocks, THREADS, smem, stream>>>(
            mx, mb, x, b, dt, la, es, lam, p);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    const int smem = sm90::ALIGN + Smem<T, P, true>::BYTES;
    e = cudaFuncSetAttribute(ssd_chunk_scan<T, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = bsz * p.groups * p.segs;
    ssd_chunk_scan<T, P><<<(unsigned)blocks, THREADS, smem, stream>>>(
        mx, mb, mc, x, b, c, dt, la, static_cast<T*>(y), hout, es, lam, p);
    return (int)cudaGetLastError();
}

// log2 of the 16-byte copies of a row of `len` elements when the base and
// every stride are 16-byte aligned and the count is a power of two, else -1
int copy_lg(const void* ptr, long long elem_bytes, long long len,
            std::initializer_list<long long> strides) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 ||
        (len * elem_bytes) % 16 != 0)
        return -1;
    for (long long s : strides)
        if ((s * elem_bytes) % 16 != 0) return -1;
    const long long n = len * elem_bytes / 16;
    if (n & (n - 1)) return -1;
    int lg = 0;
    while ((1ll << lg) < n) ++lg;
    return lg;
}

}  // namespace

extern "C" {

int ssd_chunk_length() { return Q; }
int ssd_chunk_max_p() { return 128; }
int ssd_chunk_max_n() { return 64; }
int ssd_chunk_heads_per_block() { return HG; }
int ssd_chunk_max_segments() { return MAX_SEGS; }

// y (in x's dtype) and hout (B*H, p, n) f32 of the SSD scan over B x H
// panes of T steps; x (b, h, t, :), B, C (b, h, t, :) and dt, la (b, h, t)
// are read and y written through the given element strides (the last
// axis of x, B, C and y is contiguous; a head stride of 0 shares B and C
// across heads). cps: chunks a segment; hpb: heads a block (2 needs B and
// C shared, head strides 0; else 1). es (B*H*(S-1), p, n) and lam
// (B*H*(S-1)) f32 are the state pass's scratch, S = ceil(ceil(T / 64) /
// cps) segments (unused when S = 1). bf16 != 0: x, B, C and y are bf16,
// else f32. Returns the first non-zero cudaError_t, else 0.
int ssd_scan_launch(const void* xs, const void* bm, const void* cm,
                    const float* dt, const float* la, void* y, float* hout,
                    float* es, float* lam,
                    int B, int H, int T, int p, int n, int cps, int hpb,
                    long long x_b, long long x_h, long long x_t,
                    long long b_b, long long b_h, long long b_t,
                    long long c_b, long long c_h, long long c_t,
                    long long dt_b, long long dt_h, long long dt_t,
                    long long la_b, long long la_h, long long la_t,
                    long long y_b, long long y_h, long long y_t, int bf16,
                    void* stream_ptr) {
    if (B < 1 || H < 1 || T < 1 || p < 1 || n < 1 || p > 128 || n > 64 ||
        cps < 1 || (hpb != 1 && hpb != HG) ||
        (hpb == HG && (b_h != 0 || c_h != 0)))
        return (int)cudaErrorInvalidValue;
    const int chunks = (T + Q - 1) / Q;
    const int segs = (chunks + cps - 1) / cps;
    const int groups = (H + hpb - 1) / hpb;
    if (segs > MAX_SEGS ||
        (long long)B * groups * segs > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const long long eb = bf16 ? 2 : 4;
    const int y_lg = copy_lg(y, eb, p, {y_b, y_h, y_t});
    const Params prm{H, T, p, n, cps, segs, groups, hpb, 0, y_lg,
                     x_b, x_h, x_t, b_b, b_h, b_t, c_b, c_h, c_t,
                     dt_b, dt_h, dt_t, la_b, la_h, la_t, y_b, y_h, y_t};
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (bf16)
        return p <= 64
            ? launch_tile<__nv_bfloat16, 64>(xs, bm, cm, dt, la, y, hout, es,
                                             lam, prm, B, stream)
            : launch_tile<__nv_bfloat16, 128>(xs, bm, cm, dt, la, y, hout, es,
                                              lam, prm, B, stream);
    return p <= 64
        ? launch_tile<float, 64>(xs, bm, cm, dt, la, y, hout, es, lam, prm, B,
                                 stream)
        : launch_tile<float, 128>(xs, bm, cm, dt, la, y, hout, es, lam, prm,
                                  B, stream);
}

}  // extern "C"
