// Fused metric-space top-k retrieval for Hopper (sm_90a), f32-accurate on
// the tensor cores.
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
// d_in = 21504) the work is 2*Nq*M*d_out + 2*Nq*d_in*d_out ~ 131 GFLOP,
// which 3xTF32 (kernels/csrc/tf32x3_sm90.cuh) does as 3 x 131 GFLOP at
// 495 TFLOP/s, 0.80 ms, against ~4.1 GB read once (gp 4.0 GB + L 86 MB),
// 1.22 ms at 3.35 TB/s. So the kernel is bound by reading the gallery,
// at every Nq from 1 to 64.
//
// What the design does about it. The TPU kernel holds all of L in VMEM
// and walks the gallery as a sequential grid axis carrying its running
// top-k in scratch; here L (86 MB at this width) cannot sit in shared
// memory and blocks run in parallel in no order. So:
//
//   1. tf32x3::partial_product<N, false>: q L^T split over d_in, L rows
//      on the wgmma M side and the query tile (N = 8 .. 128 rows, the
//      smallest that holds the batch) on the N side, partial sums to
//      scratch;
//   2. project_reduce: sums the d_in slices in a fixed order (so the
//      result is deterministic), writes qn = ||qp||^2 from the f32 qp and
//      the 3xTF32 split of qp (qhi, qlo) once for the call;
//   3. scan: grid (query tile x gallery split), one block an SM. Each
//      block streams its split's gallery through the TMA ring once:
//      128-row x 32-column gp stages with the query tile's qhi / qlo
//      slices beside them (they stay in L2). Gallery rows are the wgmma M
//      side (two warpgroups of 64), queries the N side, so Nq = 1 costs a
//      64 x 8 wgmma and the scan stays bound by the gallery read. Each
//      warpgroup loads its own 64 rows of a landed stage into registers
//      and splits them there (the wgmma's A from registers); qhi / qlo
//      are read from shared memory as they landed. Per 128-row
//      tile the accumulators go to a shared-memory tile; the warp that
//      owns a query forms d = (qn + gn) - 2 cross (rounded as the plain
//      version) for 32 rows at a time, and only rows that beat the
//      query's current k-th (d, id) reach its sorted list (count, shift,
//      write by the whole warp). Each split writes its k_top candidates;
//   4. merge: one block per query merges the sorted split lists by
//      (d, id), k_top rounds of a block-wide argmin over list heads.
//
// Lists stop at MAX_K = 256 entries (an insert costs MAX_K / 32 entries a
// lane, and a block keeps N lists in shared memory). A wider k_top (up to
// M) takes the wide path: steps 1-3 as above, but the scan writes every
// distance to dump (Nq, M) instead of keeping lists, and
// topk_list::select_wide (kernels/csrc/topk_list.cuh), one block per
// query, radix-selects the k_top smallest (d, id) and writes them
// unordered; the wrapper's final (d, id) sort orders them. The gallery is
// still read once: a wider list in shared memory would shrink the query
// tile, and each query tile reads the whole gallery.
//
// Ragged edges are zero rows and columns of the TMA boxes, masked in the
// epilogues; the wrapper zero-pads q, L or gp to rows of a multiple of 4
// floats where they are not (the tensor map's 16-byte row stride). No
// plain TF32 and no bf16: every product is 3xTF32.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "../../csrc/tf32x3_sm90.cuh"
#include "../../csrc/topk_list.cuh"

namespace {

using tf32x3::A_BYTES;
using tf32x3::BK;
using tf32x3::BM;
using tf32x3::ROW_BYTES;
using tf32x3::THREADS;

using topk_list::lex_less;
using topk_list::MAX_K;         // the widest list (topk_list.cuh)
using topk_list::warp_insert;
constexpr int PROJ_STAGES = 4;
constexpr int REDUCE_THREADS = 256;
constexpr int MERGE_THREADS = 256;
constexpr int NO_ID = 0x7fffffff;
constexpr int DPAD = BM + 4;    // cross tile rows: conflict-free stores
// the scan keeps a producer warp beside its two warpgroups: the TMA ring
// runs ahead through the tile epilogues (the 288-thread block gets 168
// registers a thread, which its one register set fits)
constexpr int SCAN_THREADS = THREADS + 32;

__host__ __device__ constexpr int scan_stage_bytes(int n) {
    return A_BYTES + 2 * n * ROW_BYTES;         // gp, qhi, qlo slices
}

// the aligned ring, the cross tile, gn / qn, the lists and the barriers
// (+ ALIGN of slack)
__host__ __device__ constexpr int scan_smem(int n, int k_top, int stages) {
    return tf32x3::ALIGN + stages * scan_stage_bytes(n) + n * DPAD * 4
        + BM * 4 + n * 4 + n * k_top * 8 + 2 * stages * 8;
}

// qp[q, c] = sum_s part[s, q, c] (s ascending); qn[q] = sum_c qp[q, c]^2;
// qhi / qlo (nq, dp): the 3xTF32 split of qp, zero in columns d_out..dp
__global__ void __launch_bounds__(REDUCE_THREADS)
project_reduce(const float* __restrict__ part, float* __restrict__ qhi,
               float* __restrict__ qlo, float* __restrict__ qn, int nq,
               int d_out, int dp, int nsplit) {
    __shared__ float warp_sums[REDUCE_THREADS / 32];
    const int qi = blockIdx.x;
    float sq = 0.f;
    for (int c = threadIdx.x; c < dp; c += REDUCE_THREADS) {
        float v = 0.f;
        if (c < d_out)
            for (int s = 0; s < nsplit; ++s)
                v += part[((long long)s * nq + qi) * d_out + c];
        float hi, lo;
        tf32x3::split1(v, hi, lo);
        qhi[(long long)qi * dp + c] = hi;
        qlo[(long long)qi * dp + c] = lo;
        sq = fmaf(v, v, sq);
    }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
    __syncthreads();
    if (threadIdx.x == 0) {
        float tot = 0.f;
        for (int w = 0; w < REDUCE_THREADS / 32; ++w) tot += warp_sums[w];
        qn[qi] = tot;
    }
}

// cand[q, s] = the k_top smallest (d, id) of query q over gallery split s
// (rows [s * rows_per_split, ...)), ascending; when WIDE (the wide path,
// k_top 0) every distance to dump[q, row] instead, a separate instance so
// the list path's code is unchanged. Grid (query tiles of N, nsplit);
// ksteps = the BK-column slices of a gp row.
template <int N, bool WIDE>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
scan(const __grid_constant__ CUtensorMap gpm,
     const __grid_constant__ CUtensorMap qhm,
     const __grid_constant__ CUtensorMap qlm, const float* __restrict__ qn,
     const float* __restrict__ gn, float* __restrict__ cand_d,
     int* __restrict__ cand_i, float* __restrict__ dump, int nq, int m,
     int k_top, int ksteps, int rows_per_split, int nsplit, int stages) {
    using namespace tf32x3;
    constexpr int Q_BYTES = N * ROW_BYTES;
    constexpr int STAGE = scan_stage_bytes(N);
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = align_smem(smem_raw);
    float* cross = reinterpret_cast<float*>(base + stages * STAGE);
    float* sgn = cross + N * DPAD;
    float* sqn = sgn + BM;
    float* list_d = sqn + N;
    int* list_i = reinterpret_cast<int*>(list_d + N * k_top);
    uint64_t* full = reinterpret_cast<uint64_t*>(list_i + N * k_top);
    uint64_t* empty = full + stages;

    const int q0 = blockIdx.x * N, split = blockIdx.y;
    const int r0 = split * rows_per_split;
    const int r1 = min(m, r0 + rows_per_split);
    const int tiles = (r1 - r0 + BM - 1) / BM;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    init_ring(full, empty, stages);

    // iteration j: tile j / ksteps, slice j % ksteps, into slot j % stages
    const int total = tiles * ksteps;
    auto load = [&](int j) {    // the producer: iteration j into its slot
        const int s = j % stages;
        unsigned char* st = base + s * STAGE;
        const int col = (j % ksteps) * BK;
        mbar_expect_tx(&full[s], STAGE);
        tma_load(st, &gpm, &full[s], col, r0 + (j / ksteps) * BM);
        tma_load(st + A_BYTES, &qhm, &full[s], col, q0);
        tma_load(st + A_BYTES + Q_BYTES, &qlm, &full[s], col, q0);
    };
    if (warp == THREADS / 32) {             // the producer warp
        if (lane == 0)
            for (int j = 0; j < total; ++j) {
                if (j >= stages)
                    mbar_wait(&empty[j % stages], (j / stages - 1) & 1);
                load(j);
            }
        return;
    }
    const int tid = threadIdx.x, wg = warp / 4, wl = warp % 4;
    for (int p = tid; p < N * k_top; p += THREADS) {
        list_d[p] = CUDART_INF_F;
        list_i[p] = NO_ID;
    }
    for (int p = tid; p < N; p += THREADS)
        sqn[p] = q0 + p < nq ? qn[q0 + p] : 0.f;
    named_sync(1, THREADS);

    float acc[N / 2], tmp[N / 2], a_hi[AFRAG], a_lo[AFRAG];
    int it = 0;
    for (int t = 0; t < tiles; ++t) {
        #pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
        for (int kk = 0; kk < ksteps; ++kk, ++it) {
            const int s = it % stages;
            unsigned char* st = base + s * STAGE;
            mbar_wait(&full[s], (it / stages) & 1);
            if (kk > 0) {
                promote<N>(acc, tmp, a_hi, a_lo);
                if (tid % 128 == 0) mbar_arrive(&empty[(it - 1) % stages]);
            }
            // this warpgroup's 64 gallery rows, split in registers
            load_a(reinterpret_cast<const float*>(st) + wg * 64 * BK,
                   nullptr, a_hi, a_lo);
            issue_stage<N>(tmp, a_hi, a_lo, st + A_BYTES,
                           st + A_BYTES + Q_BYTES);
        }
        promote<N>(acc, tmp, a_hi, a_lo);
        if (tid % 128 == 0) mbar_arrive(&empty[(it - 1) % stages]);

        const int m0 = r0 + t * BM;
        named_sync(1, THREADS);             // the last tile's lists are done
        #pragma unroll
        for (int i = 0; i < N / 8; ++i) {
            #pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = wg * 64 + wl * 16 + lane / 4 + 8 * h;
                const int col = 8 * i + 2 * (lane % 4);
                cross[col * DPAD + row] = acc[4 * i + 2 * h];
                cross[(col + 1) * DPAD + row] = acc[4 * i + 2 * h + 1];
            }
        }
        if (tid < BM) sgn[tid] = m0 + tid < r1 ? gn[m0 + tid] : 0.f;
        named_sync(1, THREADS);
        // warp w keeps queries w, w + 8, ...; lanes walk the tile's rows
        for (int qi = warp; qi < N && q0 + qi < nq; qi += THREADS / 32) {
            const float qn_r = sqn[qi];
            if (WIDE) {
                float* dq = dump + (long long)(q0 + qi) * m;
                #pragma unroll
                for (int j = 0; j < BM / 32; ++j) {
                    const int rl = lane + 32 * j, row = m0 + rl;
                    const float d = __fsub_rn(
                        __fadd_rn(qn_r, sgn[rl]),
                        __fmul_rn(2.f, cross[qi * DPAD + rl]));
                    if (row < r1) dq[row] = fmaxf(d, 0.f);
                }
                continue;
            }
            float* ld = list_d + qi * k_top;
            int* li = list_i + qi * k_top;
            float thr_d = ld[k_top - 1];
            int thr_i = li[k_top - 1];
            #pragma unroll
            for (int j = 0; j < BM / 32; ++j) {
                const int rl = lane + 32 * j, row = m0 + rl;
                // (qn + gn) - 2 * cross, rounded as the plain version
                float d = __fsub_rn(__fadd_rn(qn_r, sgn[rl]),
                                    __fmul_rn(2.f, cross[qi * DPAD + rl]));
                d = fmaxf(d, 0.f);
                const bool pass = row < r1 && lex_less(d, row, thr_d, thr_i);
                unsigned mask = __ballot_sync(0xffffffffu, pass);
                if (mask == 0) continue;
                while (mask) {
                    const int src = __ffs(mask) - 1;
                    mask &= mask - 1;
                    const float cd = __shfl_sync(0xffffffffu, d, src);
                    const int ci = __shfl_sync(0xffffffffu, row, src);
                    warp_insert(ld, li, k_top, cd, ci, lane);
                }
                thr_d = ld[k_top - 1];
                thr_i = li[k_top - 1];
            }
        }
    }
    for (int qi = warp; qi < N && q0 + qi < nq; qi += THREADS / 32) {
        const float* ld = list_d + qi * k_top;
        const int* li = list_i + qi * k_top;
        const long long out = ((long long)(q0 + qi) * nsplit + split) * k_top;
        for (int p = lane; p < k_top; p += 32) {
            cand_d[out + p] = ld[p];
            cand_i[out + p] = li[p];
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

template <int N>
int launch_all(const float* q, const float* L, const float* gp,
               const float* gn, float* part, float* qhi, float* qlo,
               float* qn, float* cand_d, int* cand_i, float* dump,
               float* out_d, int* out_i, int nq, int d_in, int d_out, int dp,
               int m, int k_top, int stages, int ksplit, int kchunk,
               int nsplit, int rows_per_split, cudaStream_t stream) {
    // part[s, q, c]: L rows on the M side, queries on the N side
    int err = tf32x3::launch_partial<N, false>(
        L, nullptr, q, part, d_out, nq, d_in, ksplit, kchunk, PROJ_STAGES,
        (long long)nq * d_out, 1, d_out, stream);
    if (err != 0) return err;
    project_reduce<<<nq, REDUCE_THREADS, 0, stream>>>(part, qhi, qlo, qn, nq,
                                                      d_out, dp, ksplit);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const bool wide = k_top > MAX_K;
    const int lists = wide ? 0 : k_top;
    const int smem = scan_smem(N, lists, stages);
    if (stages < 2 || smem > tf32x3::SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    CUtensorMap gpm, qhm, qlm;
    if ((err = tf32x3::encode(&gpm, gp, dp, m, BM)) != 0) return err;
    if ((err = tf32x3::encode(&qhm, qhi, dp, nq, N)) != 0) return err;
    if ((err = tf32x3::encode(&qlm, qlo, dp, nq, N)) != 0) return err;
    auto kernel = wide ? scan<N, true> : scan<N, false>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((nq + N - 1) / N, nsplit), SCAN_THREADS, smem, stream>>>(
        gpm, qhm, qlm, qn, gn, cand_d, cand_i, dump, nq, m, lists,
        (dp + BK - 1) / BK, rows_per_split, nsplit, stages);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (wide) {
        topk_list::select_wide<<<nq, topk_list::SELECT_THREADS, 0, stream>>>(
            dump, m, k_top, nullptr, nullptr, 0, 1, 1, out_d, out_i);
        return (int)cudaGetLastError();
    }

    merge<<<nq, MERGE_THREADS, (size_t)nsplit * sizeof(int), stream>>>(
        cand_d, cand_i, out_d, out_i, nsplit, k_top);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metric_topk_block_m() { return BM; }
int metric_topk_block_k() { return BK; }
int metric_topk_max_k() { return MAX_K; }
int metric_topk_proj_stages() { return PROJ_STAGES; }
int metric_topk_scan_smem(int n, int k_top, int stages) {
    return scan_smem(n, k_top, stages);
}
int metric_topk_proj_smem(int n) {
    return tf32x3::partial_smem(n, false, PROJ_STAGES);
}

// One call runs the four kernels on `stream` with query tiles of n_tile
// rows (8, 16, 32, 64 or 128); for k_top > MAX_K the last is select_wide,
// whose out_d / out_i rows are unordered. q (nq, d_in) and L (d_out,
// d_in) have d_in a multiple of 4, gp (m, dp) has dp = d_out rounded up
// to a multiple of 4, all with 16-byte aligned bases. Scratch is the
// caller's: part (ksplit, nq, d_out), qhi / qlo (nq, dp), qn (nq), and
// cand_d / cand_i (nq, nsplit, k_top) for k_top <= MAX_K, else dump (nq,
// m). Returns the first non-zero cudaError_t, else 0.
int metric_topk_launch(const float* q, const float* L, const float* gp,
                       const float* gn, float* part, float* qhi, float* qlo,
                       float* qn, float* cand_d, int* cand_i, float* dump,
                       float* out_d, int* out_i, int nq, int d_in, int d_out,
                       int dp, int m, int k_top, int n_tile, int stages,
                       int ksplit, int kchunk, int nsplit,
                       int rows_per_split, void* stream_ptr) {
    if (k_top < 1 || k_top > m || nq < 1 || m < 1 || d_out < 1 ||
        d_in < 1 || d_in % 4 != 0 || dp % 4 != 0 || dp < d_out ||
        dp >= d_out + 4 || rows_per_split % BM != 0 ||
        (long long)nsplit * rows_per_split < m)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define METRIC_TOPK_ARGS q, L, gp, gn, part, qhi, qlo, qn, cand_d, cand_i, \
        dump, out_d, out_i, nq, d_in, d_out, dp, m, k_top, stages, ksplit, \
        kchunk, nsplit, rows_per_split, stream
    switch (n_tile) {
        case 8: return launch_all<8>(METRIC_TOPK_ARGS);
        case 16: return launch_all<16>(METRIC_TOPK_ARGS);
        case 32: return launch_all<32>(METRIC_TOPK_ARGS);
        case 64: return launch_all<64>(METRIC_TOPK_ARGS);
        case 128: return launch_all<128>(METRIC_TOPK_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef METRIC_TOPK_ARGS
}

}  // extern "C"
