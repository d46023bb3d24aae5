// Fused metric-space top-k retrieval for Hopper (sm_90a), f32 throughout.
//
// Replaces the TPU kernel repro/kernels/metric_topk/kernel.py::
// metric_topk_fused (Pallas) and computes the same function:
//
//   qp      = q L^T                                  (Nq, d_out)
//   d[i,j]  = max(||qp_i||^2 + gn_j - 2 qp_i . gp_j, 0)
//   out     = per query the k_top smallest d, ascending, equal distances
//             to the smaller gallery index; (Nq, k_top) f32 + int32.
//
// The (Nq, M) distance matrix never reaches device memory.
//
// What bounds it. At the serving shapes (Nq = 64, M = 1M, d_out = 1000,
// d_in = 21504) the work is 2*Nq*M*d_out + 2*Nq*d_in*d_out ~ 131 GFLOP
// of f32 FMA against ~4.1 GB read once (gp 4.0 GB + L 86 MB). Plain f32
// runs outside the tensor cores (67 TFLOP/s): ~1.95 ms compute against
// ~1.22 ms of memory at 3.35 TB/s, so the scan is compute-bound from
// Nq ~ 40 up and memory-bound below.
//
// What the design does about it. The TPU kernel holds all of L in VMEM
// and walks the gallery as a sequential grid axis carrying its running
// top-k in scratch; here L (86 MB at this width) cannot sit in shared
// memory and blocks run in parallel in no order. So:
//
//   1. project_partial: q L^T tiled over d_in (split-K), every block a
//      BQ x 128 output tile of one d_in slice, partial sums to scratch;
//   2. project_reduce: sums the d_in slices in a fixed order (so the
//      result is deterministic), writes qp and qn = ||qp||^2;
//   3. scan: grid (query tile x gallery split). The query tile BQ is the
//      smallest of 8/16/32/64 rows that holds the batch, so a small batch
//      does not pay 64 rows of FMA (below Nq ~ 40 the scan is bound by
//      reading gp once). Each block streams its split's gp rows through
//      shared memory in 128-row tiles, 32-wide slices double-buffered
//      with cp.async so the next slice loads while this one multiplies,
//      and forms the BQ x 128 distance tile in registers with f32 FFMA
//      (a thread owns BQ/8 queries x 4 rows). The warp that owns BQ/8
//      queries keeps their running top-k_top as sorted
//      (d, id) lists in shared memory; a candidate that beats a list's
//      current k-th entry is inserted by the whole warp (count, shift,
//      write). Each split writes its k_top candidates per query;
//   4. merge: one block per query merges the sorted split lists by
//      (d, id), k_top rounds of a block-wide argmin over list heads.
//
// Ragged edges are masked in the kernel (no 128-lane padding as on the
// TPU). No TF32, no bf16: every product is an f32 FFMA. wgmma, TMA and
// 3xTF32 are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // gallery (or L) rows of a tile
constexpr int BK = 32;          // contraction slice staged per step
constexpr int THREADS = 256;    // 8 warps: warp w owns queries TQ*w..
constexpr int TM = 4;           // rows per thread (lane, lane+32, ...)
constexpr int QPAD = BK + 4;    // 16-byte aligned rows, float4 reads
constexpr int MPAD = BM + 1;    // conflict-free transposed stores
constexpr int MAX_K = 256;
constexpr int KR = MAX_K / 32;  // list entries a lane holds in an insert
constexpr int MERGE_THREADS = 256;
constexpr int NO_ID = 0x7fffffff;

// TQ queries per thread, BQ = 8 * TQ query rows per tile: the launcher
// picks the smallest tile that holds the batch (8, 16, 32 or 64 rows).
template <int TQ>
struct Tiles {
    float a[8 * TQ][QPAD];      // A rows (queries), k contiguous
    float b[BK][MPAD];          // B rows (gallery / L), transposed
};

__device__ __forceinline__ bool lex_less(float ad, int ai, float bd, int bi) {
    return ad < bd || (ad == bd && ai < bi);
}

// 4-byte global -> shared copy that bypasses registers; pred false fills
// the destination with zero (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <int TQ>
__device__ __forceinline__ void load_slice(
        Tiles<TQ>& t, const float* __restrict__ A, long long lda, int a0,
        int na, const float* __restrict__ B, long long ldb, int b0, int nb,
        int kb, int k1) {
    const int tid = threadIdx.x;
    #pragma unroll
    for (int r = 0; r < 8 * TQ * BK / THREADS; ++r) {
        int idx = tid + r * THREADS, row = idx / BK, k = idx % BK;
        int gr = a0 + row, gk = kb + k;
        bool ok = gr < na && gk < k1;
        cp_async4(&t.a[row][k], ok ? A + gr * lda + gk : A, ok);
    }
    #pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
        int idx = tid + r * THREADS, row = idx / BK, k = idx % BK;
        int gr = b0 + row, gk = kb + k;
        bool ok = gr < nb && gk < k1;
        cp_async4(&t.b[k][row], ok ? B + gr * ldb + gk : B, ok);
    }
    cp_async_commit();
}

// acc[i][j] += sum_k A[a0 + ty*TQ + i, k] * B[b0 + lane + 32 j, k] over
// k in [k0, k1); rows past na / nb and k past k1 read as zero. Slices are
// double-buffered: slice s+1 streams in while slice s is multiplied.
// Summation is sequential in k for every output.
template <int TQ>
__device__ __forceinline__ void dot_tile(
        Tiles<TQ>* t, const float* __restrict__ A, long long lda, int a0,
        int na, const float* __restrict__ B, long long ldb, int b0, int nb,
        int k0, int k1, float (&acc)[TQ][TM]) {
    const int lane = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int nsteps = (k1 - k0 + BK - 1) / BK;
    // a warp whose query rows are all past na only helps load: at a batch
    // smaller than the tile this spares the shared-memory reads of zeros.
    // The 64-row tile keeps the branch-free loop (measured faster there).
    const bool busy = TQ == 8 || a0 + ty * TQ < na;
    load_slice<TQ>(t[0], A, lda, a0, na, B, ldb, b0, nb, k0, k1);
    for (int st = 0; st < nsteps; ++st) {
        if (st + 1 < nsteps) {
            load_slice<TQ>(t[(st + 1) & 1], A, lda, a0, na, B, ldb, b0, nb,
                           k0 + (st + 1) * BK, k1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const Tiles<TQ>& c_t = t[st & 1];
        if (busy) {
            #pragma unroll
            for (int kk = 0; kk < BK; kk += 4) {
                float4 a[TQ];
                #pragma unroll
                for (int i = 0; i < TQ; ++i)
                    a[i] = *reinterpret_cast<const float4*>(&c_t.a[ty * TQ + i][kk]);
                #pragma unroll
                for (int c = 0; c < 4; ++c) {
                    float b[TM];
                    #pragma unroll
                    for (int j = 0; j < TM; ++j) b[j] = c_t.b[kk + c][lane + 32 * j];
                    #pragma unroll
                    for (int i = 0; i < TQ; ++i) {
                        float av = c == 0 ? a[i].x : c == 1 ? a[i].y
                                 : c == 2 ? a[i].z : a[i].w;
                        #pragma unroll
                        for (int j = 0; j < TM; ++j)
                            acc[i][j] = fmaf(av, b[j], acc[i][j]);
                    }
                }
            }
        }
        __syncthreads();        // the next load overwrites this buffer
    }
}

// part[s, q, c] = sum_{k in slice s} q[q, k] * L[c, k]
template <int TQ>
__global__ void __launch_bounds__(THREADS)
project_partial(const float* __restrict__ q, const float* __restrict__ L,
                float* __restrict__ part, int nq, int d_in, int d_out,
                int kchunk) {
    extern __shared__ __align__(16) unsigned char smem[];
    Tiles<TQ>* t = reinterpret_cast<Tiles<TQ>*>(smem);
    const int q0 = blockIdx.x * 8 * TQ, c0 = blockIdx.y * BM, s = blockIdx.z;
    const int k0 = s * kchunk, k1 = min(d_in, k0 + kchunk);
    float acc[TQ][TM] = {};
    dot_tile<TQ>(t, q, d_in, q0, nq, L, d_in, c0, d_out, k0, k1, acc);
    const int lane = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float* out = part + (long long)s * nq * d_out;
    #pragma unroll
    for (int i = 0; i < TQ; ++i) {
        int qi = q0 + ty * TQ + i;
        if (qi >= nq) continue;
        #pragma unroll
        for (int j = 0; j < TM; ++j) {
            int c = c0 + lane + 32 * j;
            if (c < d_out) out[(long long)qi * d_out + c] = acc[i][j];
        }
    }
}

// qp[q, c] = sum_s part[s, q, c] (s ascending); qn[q] = sum_c qp[q, c]^2
__global__ void __launch_bounds__(THREADS)
project_reduce(const float* __restrict__ part, float* __restrict__ qp,
               float* __restrict__ qn, int nq, int d_out, int nsplit) {
    __shared__ float warp_sums[THREADS / 32];
    const int qi = blockIdx.x;
    float sq = 0.f;
    for (int c = threadIdx.x; c < d_out; c += THREADS) {
        float v = 0.f;
        for (int s = 0; s < nsplit; ++s)
            v += part[((long long)s * nq + qi) * d_out + c];
        qp[(long long)qi * d_out + c] = v;
        sq = fmaf(v, v, sq);
    }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
    __syncthreads();
    if (threadIdx.x == 0) {
        float tot = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) tot += warp_sums[w];
        qn[qi] = tot;
    }
}

// Insert (d, id) into the ascending (d, id) list ld/li of length k; the
// whole warp takes part. A candidate that ranks k-th or later is dropped.
// Inserts are rare once a list fills, so it stays out of line.
__device__ __noinline__ void warp_insert(float* ld, int* li, int k,
                                            float d, int id, int lane) {
    float od[KR];
    int oi[KR];
    int cnt = 0;
    #pragma unroll
    for (int r = 0; r < KR; ++r) {
        int p = lane + 32 * r;
        od[r] = CUDART_INF_F;
        oi[r] = NO_ID;
        if (p < k) {
            od[r] = ld[p];
            oi[r] = li[p];
            cnt += lex_less(od[r], oi[r], d, id);
        }
    }
    const int pos = __reduce_add_sync(0xffffffffu, cnt);
    __syncwarp();
    if (pos >= k) return;                 // uniform across the warp
    #pragma unroll
    for (int r = 0; r < KR; ++r) {
        int p = lane + 32 * r;
        if (p >= pos && p < k - 1) {
            ld[p + 1] = od[r];
            li[p + 1] = oi[r];
        }
    }
    if (lane == 0) {
        ld[pos] = d;
        li[pos] = id;
    }
    __syncwarp();
}

template <int TQ>
__global__ void __launch_bounds__(THREADS)
scan(const float* __restrict__ qp, const float* __restrict__ qn,
     const float* __restrict__ gp, const float* __restrict__ gn,
     float* __restrict__ cand_d, int* __restrict__ cand_i,
     int nq, int d_out, int m, int k_top, int rows_per_split, int nsplit) {
    constexpr int BQ = 8 * TQ;
    extern __shared__ __align__(16) unsigned char smem[];
    Tiles<TQ>* t = reinterpret_cast<Tiles<TQ>*>(smem);
    float* list_d = reinterpret_cast<float*>(t + 2);
    int* list_i = reinterpret_cast<int*>(list_d + BQ * k_top);

    const int lane = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int q0 = blockIdx.x * BQ, s = blockIdx.y;
    const int r0 = s * rows_per_split, r1 = min(m, r0 + rows_per_split);

    for (int p = threadIdx.x; p < BQ * k_top; p += THREADS) {
        list_d[p] = CUDART_INF_F;
        list_i[p] = NO_ID;
    }
    float qn_r[TQ], thr_d[TQ];
    int thr_i[TQ];
    #pragma unroll
    for (int i = 0; i < TQ; ++i) {
        int qi = q0 + ty * TQ + i;
        qn_r[i] = qi < nq ? qn[qi] : 0.f;
        thr_d[i] = CUDART_INF_F;
        thr_i[i] = NO_ID;
    }
    __syncthreads();

    for (int m0 = r0; m0 < r1; m0 += BM) {
        float acc[TQ][TM] = {};
        dot_tile<TQ>(t, qp, d_out, q0, nq, gp, d_out, m0, r1, 0, d_out, acc);
        float gn_r[TM];
        #pragma unroll
        for (int j = 0; j < TM; ++j) {
            int row = m0 + lane + 32 * j;
            gn_r[j] = row < r1 ? gn[row] : 0.f;
        }
        #pragma unroll
        for (int i = 0; i < TQ; ++i) {
            if (q0 + ty * TQ + i >= nq) continue;     // uniform in the warp
            float* ld = list_d + (ty * TQ + i) * k_top;
            int* li = list_i + (ty * TQ + i) * k_top;
            #pragma unroll
            for (int j = 0; j < TM; ++j) {
                int row = m0 + lane + 32 * j;
                // (qn + gn) - 2 * cross, rounded as the plain version
                float d = __fsub_rn(__fadd_rn(qn_r[i], gn_r[j]),
                                    __fmul_rn(2.f, acc[i][j]));
                d = fmaxf(d, 0.f);
                bool pass = row < r1 && lex_less(d, row, thr_d[i], thr_i[i]);
                unsigned mask = __ballot_sync(0xffffffffu, pass);
                while (mask) {
                    int src = __ffs(mask) - 1;
                    mask &= mask - 1;
                    float cd = __shfl_sync(0xffffffffu, d, src);
                    int ci = __shfl_sync(0xffffffffu, row, src);
                    warp_insert(ld, li, k_top, cd, ci, lane);
                }
            }
            thr_d[i] = ld[k_top - 1];
            thr_i[i] = li[k_top - 1];
        }
    }
    __syncwarp();
    #pragma unroll
    for (int i = 0; i < TQ; ++i) {
        int qi = q0 + ty * TQ + i;
        if (qi >= nq) continue;
        const float* ld = list_d + (ty * TQ + i) * k_top;
        const int* li = list_i + (ty * TQ + i) * k_top;
        long long base = ((long long)qi * nsplit + s) * k_top;
        for (int p = lane; p < k_top; p += 32) {
            cand_d[base + p] = ld[p];
            cand_i[base + p] = li[p];
        }
    }
}

// out[q, r] = r-th smallest (d, id) over the nsplit sorted candidate lists
__global__ void __launch_bounds__(MERGE_THREADS)
merge(const float* __restrict__ cand_d, const int* __restrict__ cand_i,
      float* __restrict__ out_d, int* __restrict__ out_i,
      int nsplit, int k_top) {
    extern __shared__ int head[];                 // nsplit list heads
    __shared__ float wd[MERGE_THREADS / 32];
    __shared__ int wi[MERGE_THREADS / 32], ws[MERGE_THREADS / 32];
    const int qi = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const float* cd = cand_d + (long long)qi * nsplit * k_top;
    const int* ci = cand_i + (long long)qi * nsplit * k_top;
    for (int s = threadIdx.x; s < nsplit; s += MERGE_THREADS) head[s] = 0;
    __syncthreads();
    for (int r = 0; r < k_top; ++r) {
        float bd = CUDART_INF_F;
        int bi = NO_ID, bs = -1;
        for (int s = threadIdx.x; s < nsplit; s += MERGE_THREADS) {
            int h = head[s];
            if (h < k_top) {
                float d = cd[s * k_top + h];
                int id = ci[s * k_top + h];
                if (bs < 0 || lex_less(d, id, bd, bi)) { bd = d; bi = id; bs = s; }
            }
        }
        for (int o = 16; o > 0; o >>= 1) {
            float od = __shfl_xor_sync(0xffffffffu, bd, o);
            int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            int os = __shfl_xor_sync(0xffffffffu, bs, o);
            if (os >= 0 && (bs < 0 || lex_less(od, oi, bd, bi))) {
                bd = od; bi = oi; bs = os;
            }
        }
        if (lane == 0) { wd[w] = bd; wi[w] = bi; ws[w] = bs; }
        __syncthreads();
        if (threadIdx.x == 0) {
            float fd = wd[0];
            int fi = wi[0], fs = ws[0];
            for (int v = 1; v < MERGE_THREADS / 32; ++v)
                if (ws[v] >= 0 && (fs < 0 || lex_less(wd[v], wi[v], fd, fi))) {
                    fd = wd[v]; fi = wi[v]; fs = ws[v];
                }
            out_d[(long long)qi * k_top + r] = fd;
            out_i[(long long)qi * k_top + r] = fi;
            if (fs >= 0) head[fs] += 1;
        }
        __syncthreads();
    }
}

template <int TQ>
int launch_all(const float* q, const float* L, const float* gp,
               const float* gn, float* part, float* qp, float* qn,
               float* cand_d, int* cand_i, float* out_d, int* out_i,
               int nq, int d_in, int d_out, int m, int k_top, int ksplit,
               int kchunk, int nsplit, int rows_per_split,
               cudaStream_t stream) {
    constexpr int BQ = 8 * TQ;
    const int qtiles = (nq + BQ - 1) / BQ;
    const size_t tile_bytes = 2 * sizeof(Tiles<TQ>);
    cudaError_t err = cudaFuncSetAttribute(
        project_partial<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tile_bytes);
    if (err != cudaSuccess) return (int)err;
    project_partial<TQ><<<dim3(qtiles, (d_out + BM - 1) / BM, ksplit),
                          THREADS, tile_bytes, stream>>>(
        q, L, part, nq, d_in, d_out, kchunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    project_reduce<<<nq, THREADS, 0, stream>>>(part, qp, qn, nq, d_out, ksplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    const size_t scan_bytes =
        tile_bytes + (size_t)BQ * k_top * (sizeof(float) + sizeof(int));
    err = cudaFuncSetAttribute(scan<TQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)scan_bytes);
    if (err != cudaSuccess) return (int)err;
    scan<TQ><<<dim3(qtiles, nsplit), THREADS, scan_bytes, stream>>>(
        qp, qn, gp, gn, cand_d, cand_i, nq, d_out, m, k_top,
        rows_per_split, nsplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    merge<<<nq, MERGE_THREADS, (size_t)nsplit * sizeof(int), stream>>>(
        cand_d, cand_i, out_d, out_i, nsplit, k_top);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metric_topk_block_m() { return BM; }
int metric_topk_block_k() { return BK; }
int metric_topk_max_k() { return MAX_K; }

// One call runs the four kernels on `stream` with 8 * tq query rows per
// tile (tq in 1, 2, 4, 8). Scratch is the caller's: part (ksplit, nq,
// d_out), qp (nq, d_out), qn (nq), cand_d / cand_i (nq, nsplit, k_top).
// Returns the first non-zero cudaError_t, else 0.
int metric_topk_launch(const float* q, const float* L, const float* gp,
                       const float* gn, float* part, float* qp, float* qn,
                       float* cand_d, int* cand_i, float* out_d, int* out_i,
                       int nq, int d_in, int d_out, int m, int k_top, int tq,
                       int ksplit, int kchunk, int nsplit,
                       int rows_per_split, void* stream_ptr) {
    if (k_top < 1 || k_top > MAX_K || nq < 1 || m < 1 || d_out < 1 ||
        d_in < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define METRIC_TOPK_ARGS q, L, gp, gn, part, qp, qn, cand_d, cand_i, out_d, \
        out_i, nq, d_in, d_out, m, k_top, ksplit, kchunk, nsplit,          \
        rows_per_split, stream
    switch (tq) {
        case 1: return launch_all<1>(METRIC_TOPK_ARGS);
        case 2: return launch_all<2>(METRIC_TOPK_ARGS);
        case 4: return launch_all<4>(METRIC_TOPK_ARGS);
        case 8: return launch_all<8>(METRIC_TOPK_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef METRIC_TOPK_ARGS
}

}  // extern "C"
