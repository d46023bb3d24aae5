// Flash attention forward (GQA, causal / sliding window) for Hopper
// (sm_90a), bf16 on the tensor cores or full f32.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// _flash_kernel (launched by flash_attention, :80) and computes the same
// function on q (B, T, H, Dh) and k, v (B, S, K, Dh), H % K == 0, query
// head h reading kv head h / (H / K):
//
//   out[b, t, h] = sum_s softmax_s(q[b,t,h] . k[b,s,hk] / sqrt(Dh)) v[b,s,hk]
//
// over the keys s that row t may see, row t standing at position
// t + q_offset: s <= t + q_offset when causal, s > t + q_offset - window
// when window > 0 (q_offset > 0 is one rank's slice of a longer query
// sequence under context parallelism). Scores, softmax and the
// accumulator are f32; the output is in q's dtype.
//
// What bounds it. At the zamba2-2.7b embedding service's shapes (B 4,
// T = S = 8192, 32 heads of Dh 80, window 4096, bf16) a call has 25.2M
// allowed (t, s) entries a head, 4 Dh = 320 FLOP each: 1.03 TFLOP, 1.04 ms
// at the bf16 tensor-core rate (989 TFLOP/s), against 0.67 GB moved (q, k,
// v read and out written once: 0.20 ms at 3.35 TB/s). At gemma-7b's (B 1,
// T 8192, 16 heads of 256, causal) 0.55 TFLOP, 0.56 ms. So the tensor
// cores bound it.
//
// What the design does about it (bf16, flash_wgmma). The TPU kernel walks
// (B*H, q tile, kv tile) with the kv axis innermost and sequential,
// carrying m, l and the accumulator in VMEM, and visits every kv tile.
// Here one block owns one (b, h, 128-row q tile): two warpgroups of 64
// rows, 256 threads, each warpgroup carrying its rows' online-softmax
// state in registers while the block walks the kv tiles.
//  - Tiles come in by TMA with the 128-byte swizzle, in boxes of 64 bf16
//    columns (Dh 80 takes two, TMA zero-fills columns 80..127): q once,
//    k and v through rings of 2-4 slots (by what shared memory holds),
//    each slot with its own `full` mbarrier. k and v have separate rings:
//    a k tile is free as soon as its s = q k^T retired, a v tile only
//    after p v. A slot is refilled by whichever warpgroup releases it
//    second (a shared counter), so neither warpgroup ever waits for the
//    other, and no producer warp is needed: a 288- or 384-thread block
//    makes ptxas budget three warpgroups at 168 registers.
//  - s = q k^T is wgmma m64nBKk16 with both operands K-major in shared
//    memory, Dh / 16 k-steps (5 at Dh 80, none padded). o += p v is wgmma
//    m64nDNk16 with p as the bf16 A operand in registers, converted in
//    place from s's accumulator fragment, and v as the B operand read
//    MN-major through the transpose bit (N = Dh; Dh below 64 runs N 64
//    over v's zero columns).
//  - One warpgroup overlaps its softmax with its own tensor work: tile i's
//    s wgmma and tile i - 1's p v wgmma are issued back to back; the
//    exponentials of tile i (one ex2.approx each) run while p v of i - 1
//    is still in flight, and only the rescale of o waits for it. That
//    rescale (Dh / 2 multiplies a thread) runs only when a row's max has
//    grown by more than 2^8 since its m last moved: m may lag the true
//    max, p then stays below 2^8, and o / l is the same. The two
//    warpgroups are free to drift apart, so one's softmax can also hide
//    the other's wgmmas.
//  - A kv tile holding no allowed (t, s) pair is never visited (a causal
//    8192-token call with a 4096 window visits 25.2M of the 67.1M pairs,
//    plus the tile edges). A tile whose every pair is allowed runs no mask
//    arithmetic; only edge tiles (the causal diagonal, the window's lower
//    edge, ragged T and S) test each score. kernel.py's tile_plan mirrors
//    this classification for the CPU tests, and the card tests hold it
//    to the kernel's own (flash_attention_tile_plan).
//  - kv tiles are 128 keys at Dh <= 128 and 80 at Dh 256, where o alone is
//    128 f32 registers a thread (s 40, p 20 beside it): q 64 KB + 2 x
//    (k + v) 80 KB of shared memory. 80 keys rather than 64 make the
//    s wgmma wider and the walk shorter (FA3 takes the same tile).
//  - q tiles of a causal call are launched longest first (grid y
//    reversed), with the heads on the fastest grid axis, so the short
//    tiles fill the tail and blocks of one kv head run together through
//    L2.
//  - q, k and v are read in the model's (B, T, H, Dh) layout through 4-D
//    tensor maps over (Dh, H, T, B): no transposes; rows past T and keys
//    past S land as zeros and are masked.
// What holds it back now (timed against development builds without the
// softmax and with one L2-resident kv tile; see PERF.md): the softmax is
// only partly hidden behind the wgmmas (one block a SM leaves two warps a
// sub-partition to hide latency with), and at Dh 80 the kv stream from
// L2 (128 query rows per k and v byte, and 48 of the second box's 64
// columns are zero fill) is the next limit. Warpgroups taking turns at
// issuing (FA3's ping-pong), q fragments in registers, deeper rings and
// split reduction chains each moved the times by less than the spread of
// repeated runs. Next: k and v multicast to a cluster of two blocks, and
// a 16-column box for Dh 80's tail.
//
// f32 inputs stay full f32 (flash_f32): 256 threads each own a 4-row x
// 4-key score tile and 4 rows x Dh/16 output columns, all FFMA, 64-row q
// tiles and 64-key kv tiles staged synchronously in shared memory; at Dh
// 256 its q, k, v and p tiles take 214 KB of the 227 KB a block may have.
//
// NEG_INF is the finite -1e30 of the TPU kernel, not -inf: masked scores
// never make NaN. l is clamped at 1e-30 before the division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tf32x3_sm90.cuh"

namespace {

namespace sm90 = tf32x3;    // barriers, TMA, proxy fences, wgmma sync

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
    int T, S, H, group;             // group = H / K
    long long q_b, q_t, q_h;        // element strides (last dim contiguous)
    long long k_b, k_s, k_h;
    long long v_b, v_s, v_h;
    long long o_b, o_t, o_h;
    int causal, window;
    float scale;                    // 1 / sqrt(Dh)
    int q_offset;                   // the position of row 0
};

// row t (of q) against key s
__device__ __forceinline__ bool allowed(const Params& p, int t, int s) {
    const int pos = t + p.q_offset;
    return s < p.S && (!p.causal || s <= pos) &&
           (p.window == 0 || s > pos - p.window);
}

// ---- bf16: TMA + wgmma ----------------------------------------------------

constexpr int THREADS = 256;        // two consumer warpgroups
constexpr int ROW_BYTES = 128;      // a box row: 64 bf16, the swizzle span

template <int DH>
struct Cfg {
    static constexpr int BQ = 128;                  // query rows of a block
    static constexpr int BK = DH > 128 ? 80 : 128;  // keys of a kv tile
    static constexpr int NB = (DH + 63) / 64;       // 64-column boxes
    static constexpr int DN = DH < 64 ? 64 : DH;    // N of p v (o columns)
    static constexpr int Q_BYTES = NB * BQ * ROW_BYTES;
    static constexpr int TILE_BYTES = NB * BK * ROW_BYTES;  // a k or v tile
    static constexpr int BAR_BYTES = 128;   // full_q, full_k/v[], rel_k/v[]
    static constexpr int FIT = (sm90::SMEM_LIMIT - sm90::ALIGN - Q_BYTES -
                                BAR_BYTES) / (2 * TILE_BYTES);
    static constexpr int STAGES = FIT > 4 ? 4 : FIT;
    static constexpr int SMEM = sm90::ALIGN + Q_BYTES +
                                2 * STAGES * TILE_BYTES + BAR_BYTES;
    static_assert(STAGES >= 2, "two slots of k and v must fit");
};

// The kv tiles [j0, j1) of BK keys that a q tile of rows [q0, q0 + BQ)
// visits: every tile outside holds no allowed pair. The tile's positions
// start at q0 + q_offset. Host code too, for flash_attention_tile_plan.
__host__ __device__ __forceinline__ void kv_tiles(const Params& p, int q0,
                                                  int bq, int bk, int& j0,
                                                  int& j1) {
    const int p0 = q0 + p.q_offset;
    const int p_end = (q0 + bq < p.T ? q0 + bq : p.T) + p.q_offset;
    const int lo = p.window > 0 && p0 - p.window + 1 > 0
                       ? p0 - p.window + 1 : 0;
    const int hi = p.causal && p_end < p.S ? p_end : p.S;
    j0 = lo / bk;
    j1 = hi > lo ? (hi + bk - 1) / bk : j0;
}

// true when every (t, s) of rows [q0, min(q0 + bq, T)) and keys
// [s0, s0 + bk) is allowed: the tile runs no mask
__host__ __device__ __forceinline__ bool full_tile(const Params& p, int q0,
                                                   int bq, int s0, int bk) {
    const int p0 = q0 + p.q_offset;
    const int p_last = (q0 + bq < p.T ? q0 + bq : p.T) - 1 + p.q_offset;
    const int s_last = s0 + bk - 1;
    return s_last < p.S && (!p.causal || s_last <= p0) &&
           (p.window == 0 || s0 > p_last - p.window);
}

// 2^x in one MUFU.EX2 (exp2f adds a denormal fix-up around it); its error,
// about 2 ulp of f32, is far below the bf16 rounding of p before p v
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// One block: rows [q0, q0 + 128) of head h, batch b; warpgroup wg owns
// rows q0 + 64 wg .. + 63. Pipeline of a warpgroup over its n kv tiles:
//   s_0 = q k_0^T; p_0 = softmax
//   for i in 1 .. n-1: issue s_i = q k_i^T, issue o += p_{i-1} v_{i-1};
//     wait s_i; release k_i; mask (edge tiles), max, exp -> p_i in s;
//     wait p v; release v_{i-1}; rescale o; p_i -> bf16 A fragments
//   o += p_{n-1} v_{n-1}
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            __nv_bfloat16* __restrict__ out, const Params p) {
    using C = Cfg<DH>;
    constexpr int BQ = C::BQ, BK = C::BK, NB = C::NB, DN = C::DN;
    constexpr int ST = C::STAGES, TILE = C::TILE_BYTES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* Qs = sm90::align_smem(smem_raw);
    unsigned char* Ks = Qs + C::Q_BYTES;
    unsigned char* Vs = Ks + ST * TILE;
    uint64_t* full_q = reinterpret_cast<uint64_t*>(Vs + ST * TILE);
    uint64_t* full_k = full_q + 1;
    uint64_t* full_v = full_k + ST;
    int* rel_k = reinterpret_cast<int*>(full_v + ST);
    int* rel_v = rel_k + ST;

    const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    const int q0 = qt * BQ, h = blockIdx.x, b = blockIdx.z;
    const int hk = h / p.group;
    const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
    int j0, j1;
    kv_tiles(p, q0, BQ, BK, j0, j1);
    const int n = j1 - j0;

    if (tid == 0) {
        sm90::mbar_init(full_q, 1);
        for (int s = 0; s < ST; ++s) {
            sm90::mbar_init(&full_k[s], 1);
            sm90::mbar_init(&full_v[s], 1);
            rel_k[s] = rel_v[s] = 0;
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();

    // kv tile j0 + i into slot i % ST of a ring
    auto load_kv = [&](const CUtensorMap* map, unsigned char* ring,
                       uint64_t* full, int i) {
        const int s = i % ST;
        sm90::mbar_expect_tx(&full[s], TILE);
        #pragma unroll
        for (int c = 0; c < NB; ++c)
            sm90::tma_load_4d(ring + s * TILE + c * BK * ROW_BYTES, map, &full[s],
                        64 * c, hk, (j0 + i) * BK, b);
    };
    auto load_k = [&](int i) { load_kv(&kmap, Ks, full_k, i); };
    auto load_v = [&](int i) { load_kv(&vmap, Vs, full_v, i); };
    // this warpgroup is done with tile i of a ring; the second warpgroup
    // to say so refills the slot with tile i + ST
    auto release = [&](int* rel, int i, auto&& load) {
        if (tid % 128 == 0) {
            const int old = atomicAdd(&rel[i % ST], 1);
            if ((old & 1) && i + ST < n) load(i + ST);
        }
        __syncwarp();
    };
    if (tid == 0) {
        sm90::mbar_expect_tx(full_q, C::Q_BYTES);
        #pragma unroll
        for (int c = 0; c < NB; ++c)
            sm90::tma_load_4d(Qs + c * BQ * ROW_BYTES, &qmap, full_q, 64 * c, h, q0,
                        b);
        for (int i = 0; i < min(ST, n); ++i) {
            load_k(i);
            load_v(i);
        }
    }

    // s = q k_i^T into s (this warpgroup's 64 rows)
    const unsigned char* q_wg = Qs + wg * 64 * ROW_BYTES;
    float s[BK / 2];
    auto issue_s = [&](int i) {
        const unsigned char* kt = Ks + (i % ST) * TILE;
        #pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
            const int box = ks / 4, col = (ks % 4) * 32;
            sm90::WgmmaSS<BK>::mma(
                s, sm90::desc_sw128(q_wg + box * BQ * ROW_BYTES + col),
                sm90::desc_sw128(kt + box * BK * ROW_BYTES + col), ks > 0);
        }
        sm90::wgmma_commit();
    };
    // o += p v_i
    float o[DN / 2];
    #pragma unroll
    for (int i = 0; i < DN / 2; ++i) o[i] = 0.f;
    uint32_t pf[BK / 16][4];
    auto issue_pv = [&](int i) {
        const unsigned char* vt = Vs + (i % ST) * TILE;
        #pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            sm90::WgmmaRS<DN>::mma(o, pf[kk],
                             sm90::desc_mn_sw128(vt + kk * 16 * ROW_BYTES, BK));
        sm90::wgmma_commit();
    };

    // rows r_lo and r_lo + 8 of this thread; m in the raw score domain
    const int r_lo = q0 + wg * 64 + (tid / 32) % 4 * 16 + lane / 4;
    const float sl2 = p.scale * LOG2E;
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    float c_lo = 1.f, c_hi = 1.f;       // o's correction for this tile
    // mask (edge tiles), row maxima, p = exp2((s - m) sl2) in place
    auto softmax = [&](int i) {
        const int s0 = (j0 + i) * BK;
        if (!full_tile(p, q0, BQ, s0, BK)) {
            #pragma unroll
            for (int x = 0; x < BK / 2; ++x) {
                const int t = r_lo + 8 * ((x / 2) % 2);
                const int key = s0 + 8 * (x / 4) + 2 * (lane % 4) + x % 2;
                if (!allowed(p, t, key)) s[x] = NEG_INF;
            }
        }
        float mx_lo = m_lo, mx_hi = m_hi;
        #pragma unroll
        for (int x = 0; x < BK / 2; x += 4) {
            mx_lo = fmaxf(mx_lo, fmaxf(s[x], s[x + 1]));
            mx_hi = fmaxf(mx_hi, fmaxf(s[x + 2], s[x + 3]));
        }
        #pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
            mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        // a row's m moves only when its max grew by more than 8 in the
        // exponent: p stays below 2^8, o and l keep sharing one m, and
        // out = o / l is unchanged (the rescale of o is mostly skipped)
        c_lo = c_hi = 1.f;
        if ((mx_lo - m_lo) * sl2 > 8.f) {
            c_lo = ex2((m_lo - mx_lo) * sl2);
            m_lo = mx_lo;
        }
        if ((mx_hi - m_hi) * sl2 > 8.f) {
            c_hi = ex2((m_hi - mx_hi) * sl2);
            m_hi = mx_hi;
        }
        // a row with no allowed key yet keeps p = 0 (never NaN)
        const float mc_lo = m_lo == NEG_INF ? 0.f : m_lo * sl2;
        const float mc_hi = m_hi == NEG_INF ? 0.f : m_hi * sl2;
        float sum_lo = 0.f, sum_hi = 0.f;
        #pragma unroll
        for (int x = 0; x < BK / 2; x += 4) {
            s[x] = ex2(fmaf(s[x], sl2, -mc_lo));
            s[x + 1] = ex2(fmaf(s[x + 1], sl2, -mc_lo));
            s[x + 2] = ex2(fmaf(s[x + 2], sl2, -mc_hi));
            s[x + 3] = ex2(fmaf(s[x + 3], sl2, -mc_hi));
            sum_lo += s[x] + s[x + 1];
            sum_hi += s[x + 2] + s[x + 3];
        }
        l_lo = l_lo * c_lo + sum_lo;    // this thread's columns; summed
        l_hi = l_hi * c_hi + sum_hi;    // over the quad at the end
    };
    // o *= c where a row of the warp moved its m; p (f32, in s) -> bf16
    // A fragments: score blocks 2 kk and 2 kk + 1 are k-step kk of p v
    auto rescale_pack = [&]() {
        if (__any_sync(0xffffffffu, c_lo != 1.f || c_hi != 1.f)) {
            #pragma unroll
            for (int x = 0; x < DN / 2; x += 4) {
                o[x] *= c_lo;
                o[x + 1] *= c_lo;
                o[x + 2] *= c_hi;
                o[x + 3] *= c_hi;
            }
        }
        #pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            pf[kk][0] = sm90::pack_bf16(s[8 * kk], s[8 * kk + 1]);
            pf[kk][1] = sm90::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pf[kk][2] = sm90::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pf[kk][3] = sm90::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
    };

    sm90::mbar_wait(full_q, 0);
    if (n > 0) {
        sm90::mbar_wait(&full_k[0], 0);
        sm90::wgmma_fence();
        issue_s(0);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(s);
        release(rel_k, 0, load_k);
        softmax(0);
        rescale_pack();
    }
    for (int i = 1; i < n; ++i) {
        sm90::mbar_wait(&full_k[i % ST], (i / ST) & 1);
        sm90::fence_acc(s);
        sm90::fence_acc(o);
        sm90::fence_regs(pf);
        sm90::mbar_wait(&full_v[(i - 1) % ST], ((i - 1) / ST) & 1);
        sm90::wgmma_fence();
        issue_s(i);
        issue_pv(i - 1);
        sm90::wgmma_wait<1>();          // s_i landed; p v of i - 1 runs on
        sm90::fence_acc(s);
        release(rel_k, i, load_k);
        softmax(i);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(o);
        sm90::fence_regs(pf);
        release(rel_v, i - 1, load_v);
        rescale_pack();
    }
    if (n > 0) {
        sm90::mbar_wait(&full_v[(n - 1) % ST], ((n - 1) / ST) & 1);
        sm90::fence_acc(o);
        sm90::fence_regs(pf);
        sm90::wgmma_fence();
        issue_pv(n - 1);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(o);
        sm90::fence_regs(pf);
    }

    #pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
    const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* o_lo = out + b * p.o_b + (long long)r_lo * p.o_t + h * p.o_h;
    __nv_bfloat16* o_hi = o_lo + 8 * p.o_t;
    #pragma unroll
    for (int x = 0; x < DN / 2; x += 4) {
        const int col = 2 * x + 2 * (lane % 4);     // 8 (x / 4) + 2 (t % 4)
        if (col >= DH) continue;
        if (r_lo < p.T)
            *reinterpret_cast<__nv_bfloat162*>(o_lo + col) =
                __floats2bfloat162_rn(o[x] * inv_lo, o[x + 1] * inv_lo);
        if (r_lo + 8 < p.T)
            *reinterpret_cast<__nv_bfloat162*>(o_hi + col) =
                __floats2bfloat162_rn(o[x + 2] * inv_hi, o[x + 3] * inv_hi);
    }
}

// (Dh, heads, positions, batch) of a (B, L, heads, Dh) bf16 tensor as a
// 4-D TMA map of boxes 64 columns x box_rows positions, 128-byte swizzle,
// zeros past every edge; strides in elements (multiples of 8), ptr 16-byte
// aligned. Returns a cudaError_t.
int encode_bf16(CUtensorMap* map, const void* ptr, int dh, int heads,
                int len, int batch, long long s_h, long long s_t,
                long long s_b, int box_rows) {
    PFN_cuTensorMapEncodeTiled encode_fn;
    if (int err = sm90::tensor_map_encoder(&encode_fn)) return err;
    cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                          (cuuint64_t)len, (cuuint64_t)batch};
    cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_t * 2,
                             (cuuint64_t)s_b * 2};
    cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
    cuuint32_t elem[4] = {1, 1, 1, 1};
    CUresult r = encode_fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                           const_cast<void*>(ptr), dims, strides, box, elem,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 const Params& p, int B, int K, cudaStream_t stream) {
    using C = Cfg<DH>;
    const int q_tiles = (p.T + C::BQ - 1) / C::BQ;
    if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
    CUtensorMap qm, km, vm;
    int err;
    if ((err = encode_bf16(&qm, q, DH, p.H, p.T, B, p.q_h, p.q_t, p.q_b,
                           C::BQ)) != 0 ||
        (err = encode_bf16(&km, k, DH, K, p.S, B, p.k_h, p.k_s, p.k_b,
                           C::BK)) != 0 ||
        (err = encode_bf16(&vm, v, DH, K, p.S, B, p.v_h, p.v_s, p.v_b,
                           C::BK)) != 0)
        return err;
    cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    flash_wgmma<DH><<<dim3(p.H, q_tiles, B), THREADS, C::SMEM, stream>>>(
        qm, km, vm, static_cast<__nv_bfloat16*>(out), p);
    return (int)cudaGetLastError();
}

// ---- f32: FFMA, no tensor cores ------------------------------------------

constexpr int BQ = 64;              // query rows of a flash_f32 block
constexpr int BK = 64;              // keys of its kv tile

// first (tile-aligned) and one-past-last key a query tile can see
__device__ __forceinline__ void kv_range(const Params& p, int q0,
                                         int& k_begin, int& k_end) {
    const int p0 = q0 + p.q_offset;
    const int p_last = min(q0 + BQ, p.T) - 1 + p.q_offset;
    k_begin = p.window > 0 ? max(0, p0 - p.window + 1) : 0;
    k_begin -= k_begin % BK;
    k_end = p.causal ? min(p.S, p_last + 1) : p.S;
}

// thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty + 3,
// scores of keys tx + 16 j and output columns tx + 16 j; a row's 16
// threads are one half-warp, so row reductions are shuffles
template <int DH>
__global__ void __launch_bounds__(256)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, Params p) {
    constexpr int LDK = DH + 1;     // odd: a half-warp's K rows hit 16 banks
    constexpr int LDP = BK + 1;
    constexpr int CJ = DH / 16;
    extern __shared__ float sm[];
    float* Qs = sm;                  // [BQ][LDK]
    float* Ks = Qs + BQ * LDK;       // [BK][LDK]
    float* Vs = Ks + BK * LDK;       // [BK][DH]
    float* Ps = Vs + BK * DH;        // [BQ][LDP]

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / p.group;
    const float* qp = q + b * p.q_b + h * p.q_h;
    const float* kp = k + b * p.k_b + hk * p.k_h;
    const float* vp = v + b * p.v_b + hk * p.v_h;

    for (int c = tid; c < BQ * DH; c += 256) {
        const int r = c / DH, col = c % DH;
        Qs[r * LDK + col] = q0 + r < p.T
            ? qp[(long long)(q0 + r) * p.q_t + col] : 0.f;
    }
    float o[4][CJ], m[4], l[4];
    #pragma unroll
    for (int r = 0; r < 4; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
        #pragma unroll
        for (int jj = 0; jj < CJ; ++jj) o[r][jj] = 0.f;
    }

    int k_begin, k_end;
    kv_range(p, q0, k_begin, k_end);
    for (int s0 = k_begin; s0 < k_end; s0 += BK) {
        __syncthreads();
        for (int c = tid; c < BK * DH; c += 256) {
            const int r = c / DH, col = c % DH;
            const bool in = s0 + r < p.S;
            Ks[r * LDK + col] = in ? kp[(long long)(s0 + r) * p.k_s + col] : 0.f;
            Vs[r * DH + col] = in ? vp[(long long)(s0 + r) * p.v_s + col] : 0.f;
        }
        __syncthreads();

        float sc[4][4];
        #pragma unroll
        for (int r = 0; r < 4; ++r)
            sc[r][0] = sc[r][1] = sc[r][2] = sc[r][3] = 0.f;
        #pragma unroll 4
        for (int d = 0; d < DH; ++d) {
            float qv[4], kv[4];
            #pragma unroll
            for (int r = 0; r < 4; ++r) qv[r] = Qs[(4 * ty + r) * LDK + d];
            #pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDK + d];
            #pragma unroll
            for (int r = 0; r < 4; ++r)
                #pragma unroll
                for (int j = 0; j < 4; ++j)
                    sc[r][j] = fmaf(qv[r], kv[j], sc[r][j]);
        }
        #pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int t = q0 + 4 * ty + r;
            float mx = NEG_INF;
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                sc[r][j] = allowed(p, t, s0 + tx + 16 * j)
                    ? sc[r][j] * p.scale : NEG_INF;
                mx = fmaxf(mx, sc[r][j]);
            }
            #pragma unroll
            for (int off = 1; off <= 8; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float mn = fmaxf(m[r], mx), corr = expf(m[r] - mn);
            m[r] = mn;
            float sum = 0.f;
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float pv = expf(sc[r][j] - mn);
                Ps[(4 * ty + r) * LDP + tx + 16 * j] = pv;
                sum += pv;
            }
            l[r] = l[r] * corr + sum;
            #pragma unroll
            for (int jj = 0; jj < CJ; ++jj) o[r][jj] *= corr;
        }
        __syncwarp();               // a row's p comes from its own half-warp
        #pragma unroll 4
        for (int s = 0; s < BK; ++s) {
            float pv[4], vv[CJ];
            #pragma unroll
            for (int r = 0; r < 4; ++r) pv[r] = Ps[(4 * ty + r) * LDP + s];
            #pragma unroll
            for (int jj = 0; jj < CJ; ++jj) vv[jj] = Vs[s * DH + tx + 16 * jj];
            #pragma unroll
            for (int r = 0; r < 4; ++r)
                #pragma unroll
                for (int jj = 0; jj < CJ; ++jj)
                    o[r][jj] = fmaf(pv[r], vv[jj], o[r][jj]);
        }
    }
    #pragma unroll
    for (int r = 0; r < 4; ++r) {
        float lt = l[r];
        #pragma unroll
        for (int off = 1; off <= 8; off <<= 1)
            lt += __shfl_xor_sync(0xffffffffu, lt, off);
        lt = fmaxf(lt, 1e-30f);
        const int t = q0 + 4 * ty + r;
        if (t < p.T) {
            float* orow = out + b * p.o_b + (long long)t * p.o_t + h * p.o_h;
            #pragma unroll
            for (int jj = 0; jj < CJ; ++jj) orow[tx + 16 * jj] = o[r][jj] / lt;
        }
    }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               const Params& p, int B, cudaStream_t stream) {
    const dim3 grid((p.T + BQ - 1) / BQ, p.H, B);
    const size_t smem = (size_t)((BQ + BK) * (DH + 1) + BK * DH +
                                 BQ * (BK + 1)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32<DH><<<grid, 256, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), p);
    return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(const void* q, const void* k, const void* v, void* out,
              const Params& p, int B, int K, int bf16, cudaStream_t stream) {
    return bf16 ? launch_wgmma<DH>(q, k, v, out, p, B, K, stream)
                : launch_f32<DH>(q, k, v, out, p, B, stream);
}

}  // namespace

extern "C" {

// The bf16 kernel's plan of a (T, S, causal, window, q_offset) call at head
// dim dh, computed on the host by the kernel's own kv_tiles and full_tile: plan
// (nq, nk) row-major gets, for q tile qt and kv tile j, 0 when the kernel
// never visits the tile, 2 when it runs no mask there and 1 when it masks
// score by score. Returns cudaErrorInvalidValue, writing nothing, when dh
// is not built or (nq, nk) is not the kernel's tiling of T and S.
int flash_attention_tile_plan(int T, int S, int causal, int window,
                              int q_offset, int dh, int nq, int nk,
                              signed char* plan) {
    const int dims[] = {16, 32, 48, 64, 80, 96, 112, 128, 256};
    bool built = false;
    for (int d : dims) built |= d == dh;
    const int bq = Cfg<64>::BQ;
    const int bk = dh > 128 ? Cfg<256>::BK : Cfg<128>::BK;
    if (!built || T < 1 || S < 1 || window < 0 || q_offset < 0 ||
        nq != (T + bq - 1) / bq || nk != (S + bk - 1) / bk)
        return (int)cudaErrorInvalidValue;
    Params p{};
    p.T = T;
    p.S = S;
    p.causal = causal != 0;
    p.window = window;
    p.q_offset = q_offset;
    for (int qt = 0; qt < nq; ++qt) {
        int j0, j1;
        kv_tiles(p, qt * bq, bq, bk, j0, j1);
        for (int j = 0; j < nk; ++j)
            plan[qt * nk + j] =
                j < j0 || j >= j1 ? 0
                : full_tile(p, qt * bq, bq, j * bk, bk) ? 2 : 1;
    }
    return 0;
}

// out (B, T, H, dh) = attention of q (B, T, H, dh) at positions q_offset ..
// q_offset + T - 1 over k, v (B, S, K, dh), element strides given for the
// batch, position and head axes (the last axis is contiguous), on `stream`. bf16 != 0: all four tensors are bf16
// (strides multiples of 8, 16-byte aligned), else f32. Returns the first
// non-zero cudaError_t, else 0.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int T, int S, int H, int K,
                           int dh, long long q_b, long long q_t,
                           long long q_h, long long k_b, long long k_s,
                           long long k_h, long long v_b, long long v_s,
                           long long v_h, long long o_b, long long o_t,
                           long long o_h, int causal, int window,
                           int q_offset, float scale, int bf16,
                           void* stream_ptr) {
    if (B < 1 || T < 1 || S < 1 || K < 1 || H % K != 0 || window < 0 ||
        q_offset < 0 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    const Params p{T, S, H, H / K, q_b, q_t, q_h, k_b, k_s, k_h, v_b, v_s,
                   v_h, o_b, o_t, o_h, causal != 0, window, scale, q_offset};
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    switch (dh) {
        case 16: return launch_dh<16>(q, k, v, out, p, B, K, bf16, stream);
        case 32: return launch_dh<32>(q, k, v, out, p, B, K, bf16, stream);
        case 48: return launch_dh<48>(q, k, v, out, p, B, K, bf16, stream);
        case 64: return launch_dh<64>(q, k, v, out, p, B, K, bf16, stream);
        case 80: return launch_dh<80>(q, k, v, out, p, B, K, bf16, stream);
        case 96: return launch_dh<96>(q, k, v, out, p, B, K, bf16, stream);
        case 112: return launch_dh<112>(q, k, v, out, p, B, K, bf16, stream);
        case 128: return launch_dh<128>(q, k, v, out, p, B, K, bf16, stream);
        case 256: return launch_dh<256>(q, k, v, out, p, B, K, bf16, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
