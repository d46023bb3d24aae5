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
// over the keys s that row t may see: s <= t when causal, s > t - window
// when window > 0. Scores, softmax and the accumulator are f32; the
// output is in q's dtype.
//
// What bounds it. At the zamba2-2.7b embedding service's shapes (B 4,
// T = S = 8192, 32 heads of Dh 80, window 4096, bf16) a call has 25.2M
// allowed (t, s) entries a head, 4 Dh = 320 FLOP each: 1.03 TFLOP, 1.04 ms
// at the bf16 tensor-core rate (989 TFLOP/s), against 0.67 GB moved (q, k,
// v read and out written once: 0.20 ms at 3.35 TB/s). So the tensor
// cores bound it.
//
// What the design does about it. The TPU kernel walks (B*H, q tile, kv
// tile) with the kv axis innermost and sequential, carrying m, l and the
// accumulator in VMEM, and visits every kv tile. Here one block owns one
// (b, h, 64-row q tile) and loops over kv tiles itself, keeping the
// online-softmax state in registers, and visits only the kv tiles that
// hold an allowed key: a causal 8192-token call with a 4096 window does
// 25.2M of the 67.1M (t, s) pairs. bf16 inputs: four warps of 16 query
// rows each run mma.sync m16n8k16 (bf16 in, f32 accumulate): q's
// fragments stay in registers, each kv tile is staged in shared memory
// with rows padded by 8 elements (conflict-free fragment loads), s = q k^T
// stays in registers, is turned into p in place and fed back as the A
// operand of p v (FlashAttention-2's register reuse), with v's B
// fragments read by ldmatrix.trans. At Dh 256 (gemma-7b) o alone takes
// 128 registers a thread, so q's fragments are read from the q tile in
// shared memory at every kv tile instead of being held (they would take
// 64 more and spill); the tiles are 101 KB. f32 inputs stay full f32:
// 256 threads each own a 4-row x 4-key score tile and 4 rows x Dh/16
// output columns, all FFMA; at Dh 256 its q, k, v and p tiles take 214 KB
// of the 227 KB a block may have. q, k, v are read in the model's (B, T,
// H, Dh) layout through strides: no transposes. Rows past T and keys past S are masked (zero
// tiles, NEG_INF scores), so any T and S work.
//
// NEG_INF is the finite -1e30 of the TPU kernel, not -inf: a row whose keys
// in one tile are all masked gets exp(NEG_INF - NEG_INF) = 1 (a later tile
// with an allowed key scales that away by exp(NEG_INF - m) = 0), never
// NaN. l is clamped at 1e-30 before the division. Later work: TMA and
// wgmma with a producer warp, a cp.async ring instead of the synchronous
// tile loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;              // query rows of a block
constexpr int BK = 64;              // keys of a kv tile
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
    int T, S, H, group;             // group = H / K
    long long q_b, q_t, q_h;        // element strides (last dim contiguous)
    long long k_b, k_s, k_h;
    long long v_b, v_s, v_h;
    long long o_b, o_t, o_h;
    int causal, window;
    float scale;                    // 1 / sqrt(Dh)
};

// first (tile-aligned) and one-past-last key a query tile can see
__device__ __forceinline__ void kv_range(const Params& p, int q0,
                                         int& k_begin, int& k_end) {
    const int q_last = min(q0 + BQ, p.T) - 1;
    k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
    k_begin -= k_begin % BK;
    k_end = p.causal ? min(p.S, q_last + 1) : p.S;
}

__device__ __forceinline__ bool allowed(const Params& p, int t, int s) {
    return s < p.S && (!p.causal || s <= t) &&
           (p.window == 0 || s > t - p.window);
}

// ---- bf16: mma.sync on the tensor cores ----------------------------------

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
    return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* ptr) {
    unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// rows [row0, row0 + rows) of a (rows, DH) bf16 tile into shared memory,
// 16 bytes a copy; rows at or past `limit` are zero
template <int DH, int THREADS>
__device__ __forceinline__ void load_tile_bf16(
        __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
        long long row_stride, int row0, int limit, int rows) {
    constexpr int LD = DH + 8, VEC = DH / 8;
    for (int c = threadIdx.x; c < rows * VEC; c += THREADS) {
        const int r = c / VEC, col = (c % VEC) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < limit)
            val = *reinterpret_cast<const uint4*>(
                src + (long long)(row0 + r) * row_stride + col);
        *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
    }
}

// mma.sync fragments (PTX ISA, m16n8k16): lane = 4 g + tq; A holds rows
// g, g + 8 and columns 2 tq (+1), 2 tq + 8 (+1); B columns n = g, rows
// 2 tq (+1), 2 tq + 8 (+1); C rows g, g + 8 and columns 2 tq (+1).
template <int DH>
__global__ void __launch_bounds__(128)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ out, Params p) {
    constexpr int LD = DH + 8;      // padded rows: conflict-free fragments
    constexpr int KS = DH / 16;     // k steps of q . k
    constexpr int NT = DH / 8;      // 8-column tiles of the output
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Ks = Qs + BQ * LD;
    __nv_bfloat16* Vs = Ks + BK * LD;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / p.group;
    const __nv_bfloat16* qp = q + b * p.q_b + h * p.q_h;
    const __nv_bfloat16* kp = k + b * p.k_b + hk * p.k_h;
    const __nv_bfloat16* vp = v + b * p.v_b + hk * p.v_h;
    const float scale_log2 = p.scale * LOG2E;

    load_tile_bf16<DH, 128>(Qs, qp, p.q_t, q0, p.T, BQ);
    __syncthreads();
    const int r0 = warp * 16;
    // q's A fragments of k step ks: held in registers up to Dh 128; above
    // it read from the (never overwritten) q tile at every kv tile, since
    // the 64 registers they take would spill beside the 128 of o
    constexpr bool Q_REGS = DH <= 128;
    auto q_frag = [&](int ks, uint32_t (&f)[4]) {
        const __nv_bfloat16* lo = Qs + (r0 + g) * LD + ks * 16 + 2 * tq;
        const __nv_bfloat16* hi = lo + 8 * LD;
        f[0] = ld_u32(lo);
        f[1] = ld_u32(hi);
        f[2] = ld_u32(lo + 8);
        f[3] = ld_u32(hi + 8);
    };
    uint32_t qa[Q_REGS ? KS : 1][4];
    if (Q_REGS) {
        #pragma unroll
        for (int ks = 0; ks < KS; ++ks) q_frag(ks, qa[Q_REGS ? ks : 0]);
    }

    float o[NT][4];
    #pragma unroll
    for (int nt = 0; nt < NT; ++nt)
        o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    float mA = NEG_INF, mB = NEG_INF, lA = 0.f, lB = 0.f;   // rows g, g + 8
    const int tA = q0 + r0 + g, tB = tA + 8;

    int k_begin, k_end;
    kv_range(p, q0, k_begin, k_end);
    for (int s0 = k_begin; s0 < k_end; s0 += BK) {
        __syncthreads();            // every warp is done with the last tile
        load_tile_bf16<DH, 128>(Ks, kp, p.k_s, s0, p.S, BK);
        load_tile_bf16<DH, 128>(Vs, vp, p.v_s, s0, p.S, BK);
        __syncthreads();

        float s[BK / 8][4];
        #pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        #pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            uint32_t qs[4];
            if (!Q_REGS) q_frag(ks, qs);
            const uint32_t (&qf)[4] = Q_REGS ? qa[Q_REGS ? ks : 0] : qs;
            #pragma unroll
            for (int nt = 0; nt < BK / 8; ++nt) {
                const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + ks * 16
                                          + 2 * tq;
                mma_bf16(s[nt], qf, ld_u32(kr), ld_u32(kr + 8));
            }
        }
        // scale into the exp2 domain, mask, row maxima over the quad
        float mxA = NEG_INF, mxB = NEG_INF;
        #pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
            #pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int sk = s0 + nt * 8 + 2 * tq + (e & 1);
                const bool ok = allowed(p, e < 2 ? tA : tB, sk);
                s[nt][e] = ok ? s[nt][e] * scale_log2 : NEG_INF;
            }
            mxA = fmaxf(mxA, fmaxf(s[nt][0], s[nt][1]));
            mxB = fmaxf(mxB, fmaxf(s[nt][2], s[nt][3]));
        }
        #pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            mxA = fmaxf(mxA, __shfl_xor_sync(0xffffffffu, mxA, off));
            mxB = fmaxf(mxB, __shfl_xor_sync(0xffffffffu, mxB, off));
        }
        const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
        const float cA = exp2f(mA - mnA), cB = exp2f(mB - mnB);
        mA = mnA;
        mB = mnB;
        float sumA = 0.f, sumB = 0.f;
        #pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
            s[nt][0] = exp2f(s[nt][0] - mnA);
            s[nt][1] = exp2f(s[nt][1] - mnA);
            s[nt][2] = exp2f(s[nt][2] - mnB);
            s[nt][3] = exp2f(s[nt][3] - mnB);
            sumA += s[nt][0] + s[nt][1];
            sumB += s[nt][2] + s[nt][3];
        }
        lA = lA * cA + sumA;        // this thread's columns; summed at the end
        lB = lB * cB + sumB;
        #pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            o[nt][0] *= cA;
            o[nt][1] *= cA;
            o[nt][2] *= cB;
            o[nt][3] *= cB;
        }
        // o += p v: the C fragments of two score tiles are the A fragment
        // of one 16-key step
        #pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
            const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                   pack_bf16(s[2 * j][2], s[2 * j][3]),
                                   pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                   pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
            const int row = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            #pragma unroll
            for (int dn = 0; dn < DH / 16; ++dn) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, Vs + row * LD + dn * 16 + (lane >> 4) * 8);
                mma_bf16(o[2 * dn], a, bv[0], bv[1]);
                mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
            }
        }
    }
    #pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        lA += __shfl_xor_sync(0xffffffffu, lA, off);
        lB += __shfl_xor_sync(0xffffffffu, lB, off);
    }
    lA = fmaxf(lA, 1e-30f);
    lB = fmaxf(lB, 1e-30f);
    #pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * tq;
        if (tA < p.T)
            *reinterpret_cast<__nv_bfloat162*>(
                out + b * p.o_b + (long long)tA * p.o_t + h * p.o_h + col) =
                __floats2bfloat162_rn(o[nt][0] / lA, o[nt][1] / lA);
        if (tB < p.T)
            *reinterpret_cast<__nv_bfloat162*>(
                out + b * p.o_b + (long long)tB * p.o_t + h * p.o_h + col) =
                __floats2bfloat162_rn(o[nt][2] / lB, o[nt][3] / lB);
    }
}

// ---- f32: FFMA, no tensor cores ------------------------------------------

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
int launch_dh(const void* q, const void* k, const void* v, void* out,
              const Params& p, int B, int bf16, cudaStream_t stream) {
    const dim3 grid((p.T + BQ - 1) / BQ, p.H, B);
    cudaError_t err;
    if (bf16) {
        const size_t smem = (size_t)(BQ + 2 * BK) * (DH + 8) *
                            sizeof(__nv_bfloat16);
        err = cudaFuncSetAttribute(flash_bf16<DH>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        flash_bf16<DH><<<grid, 128, smem, stream>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<__nv_bfloat16*>(out), p);
    } else {
        const size_t smem = (size_t)((BQ + BK) * (DH + 1) + BK * DH +
                                     BQ * (BK + 1)) * sizeof(float);
        err = cudaFuncSetAttribute(flash_f32<DH>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        flash_f32<DH><<<grid, 256, smem, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(out), p);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_block_q() { return BQ; }
int flash_attention_block_k() { return BK; }

// out (B, T, H, dh) = attention of q (B, T, H, dh) over k, v (B, S, K, dh),
// element strides given for the batch, position and head axes (the last
// axis is contiguous), on `stream`. bf16 != 0: all four tensors are bf16,
// else f32. Returns the first non-zero cudaError_t, else 0.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int T, int S, int H, int K,
                           int dh, long long q_b, long long q_t,
                           long long q_h, long long k_b, long long k_s,
                           long long k_h, long long v_b, long long v_s,
                           long long v_h, long long o_b, long long o_t,
                           long long o_h, int causal, int window, float scale,
                           int bf16, void* stream_ptr) {
    if (B < 1 || T < 1 || S < 1 || K < 1 || H % K != 0 || window < 0 ||
        B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    const Params p{T, S, H, H / K, q_b, q_t, q_h, k_b, k_s, k_h, v_b, v_s,
                   v_h, o_b, o_t, o_h, causal != 0, window, scale};
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    switch (dh) {
        case 16: return launch_dh<16>(q, k, v, out, p, B, bf16, stream);
        case 32: return launch_dh<32>(q, k, v, out, p, B, bf16, stream);
        case 48: return launch_dh<48>(q, k, v, out, p, B, bf16, stream);
        case 64: return launch_dh<64>(q, k, v, out, p, B, bf16, stream);
        case 80: return launch_dh<80>(q, k, v, out, p, B, bf16, stream);
        case 96: return launch_dh<96>(q, k, v, out, p, B, bf16, stream);
        case 112: return launch_dh<112>(q, k, v, out, p, B, bf16, stream);
        case 128: return launch_dh<128>(q, k, v, out, p, B, bf16, stream);
        case 256: return launch_dh<256>(q, k, v, out, p, B, bf16, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
