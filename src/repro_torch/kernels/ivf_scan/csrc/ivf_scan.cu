// Fused IVF probed-segment scan + top-kk for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel repro/kernels/ivf_scan/kernel.py::
// ivf_scan_topk_fused (Pallas) and computes the same function: for each
// query q and each of its nprobe probed clusters c = probes[q, p], score
// the cap rows of segment c,
//
//   d = max((||qp_q||^2 + gn[row]) - 2 <qp_q, g[row]>, 0),
//
// and keep the kk smallest (d, position) pairs, position = p * cap +
// slot (the reference's probe-major / slot-minor candidate order).
// Output: (Nq, kk) distances and row ids in (d, position) order; the
// wrapper masks d >= BIG to id -1 and applies the final (d, id) sort.
//
// What bounds it. Each probed row is read once per probing query:
// 4k + 4 bytes of g and gn (the ids are read only for the kk winners).
// At the serving shapes (k = 1000, cap = 1224, nprobe = 16) a query
// reads 78.5 MB and does 39 MFLOP: about 2 FLOP a byte, far below the
// card's f32 ratio (67 TFLOP/s over 3.35 TB/s = 20), so the scan is
// bound by device memory. Queries that share a probed cluster read its
// segment again (through L2 when their blocks run together).
//
// What the design does about it. The TPU kernel walks one query's
// probe/tile stream as a sequential grid axis with its running top-kk
// in VMEM scratch; Hopper blocks run in parallel in no order. So:
//
//   1. ivf_scan: one block per (query, probe, row chunk); a probe's
//      segment is cut into chunks only when Nq * nprobe blocks would not
//      fill about 4 blocks per SM. Each block reads its own probe id,
//      stages the query row in shared memory, and streams its rows in
//      32-row tiles, 128-float slices of k double-buffered with cp.async
//      (16-byte copies when k is a multiple of 4, 4-byte otherwise), so
//      the next slice loads while this one is multiplied. A warp owns 4
//      rows of a tile: each lane multiplies one float4 of every slice,
//      and a fixed shuffle tree sums the lanes. Each warp keeps a sorted
//      (d, position) list of up to kk entries in shared memory and
//      inserts only a candidate that beats its kk-th entry; warp 0 then
//      merges the 8 warp lists into the block's list;
//   2. merge_lists (topk_list.cuh): one block per query merges its
//      blocks' lists by (d, position) and maps positions to row ids.
//
// Wide lists (kk > topk_list::MAX_K): the blocks write every candidate's
// distance to dump[q, position] instead of keeping lists, and
// topk_list::select_wide picks the kk smallest (d, position) per query.
//
// Ragged edges (rows past the segment's chunk, k not a multiple of the
// slice) are masked in the kernel; there is no 128-lane padding. The
// distance is rounded as the plain version rounds it: (qn + gn) - 2 x.
// No TF32: every product is an f32 FFMA.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "../../csrc/topk_list.cuh"

namespace {

using namespace topk_list;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 4;                  // rows a warp scores per tile
constexpr int TR = WARPS * RPW;         // rows per tile
constexpr int KS = 128;                 // k floats per slice (a float4 a lane)

struct Slice {
    float v[TR][KS];
};

__host__ __device__ inline int kpad_of(int k) { return (k + KS - 1) / KS * KS; }

__host__ __device__ inline size_t smem_bytes(int k, int kk) {
    return 2 * sizeof(Slice) + (size_t)kpad_of(k) * sizeof(float) +
           (size_t)(WARPS + 1) * kk * (sizeof(float) + sizeof(int));
}

// Rows [row0, row0 + nrows) of g (nrows <= TR), columns [k0, k0 + KS),
// into slice s; rows past nrows and columns past k read as zero.
template <bool VEC4>
__device__ __forceinline__ void load_slice(Slice& s, const float* __restrict__ g,
                                           long long row0, int nrows, int k,
                                           int k0) {
    if (VEC4) {
        #pragma unroll
        for (int r = 0; r < TR * KS / 4 / THREADS; ++r) {
            int idx = threadIdx.x + r * THREADS;
            int row = idx / (KS / 4), c = 4 * (idx % (KS / 4));
            bool ok = row < nrows && k0 + c < k;     // k % 4 == 0: all 4 in
            const float* src = ok ? g + (row0 + row) * k + k0 + c : g;
            cp_async16(&s.v[row][c], src, ok ? 16 : 0);
        }
    } else {
        #pragma unroll 4
        for (int r = 0; r < TR * KS / THREADS; ++r) {
            int idx = threadIdx.x + r * THREADS;
            int row = idx / KS, c = idx % KS;
            bool ok = row < nrows && k0 + c < k;
            cp_async4(&s.v[row][c], ok ? g + (row0 + row) * k + k0 + c : g, ok);
        }
    }
    cp_async_commit();
}

// kk > 0: sorted per-warp lists of kk (d, position), merged into the
// block's list; kk == 0: every distance to dump[q, position] (the wide
// path)
template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
ivf_scan(const int* __restrict__ probes, const float* __restrict__ qp,
         const float* __restrict__ g, const float* __restrict__ gn,
         float* __restrict__ cand_d, int* __restrict__ cand_p,
         float* __restrict__ dump, int nprobe, int n_clusters, int cap,
         int k, int kk, int rows_per_chunk, int nchunk) {
    extern __shared__ __align__(16) unsigned char smem[];
    Slice* tiles = reinterpret_cast<Slice*>(smem);
    const int kpad = kpad_of(k);
    float* q_s = reinterpret_cast<float*>(tiles + 2);
    float* list_d = q_s + kpad;                       // WARPS lists of kk
    int* list_p = reinterpret_cast<int*>(list_d + WARPS * kk);
    float* blk_d = reinterpret_cast<float*>(list_p + WARPS * kk);
    int* blk_p = reinterpret_cast<int*>(blk_d + kk);
    __shared__ float qn_s;

    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long blk = blockIdx.x;
    const int c = (int)(blk % nchunk);
    const long long qp_pair = blk / nchunk;           // q * nprobe + p
    const int q = (int)(qp_pair / nprobe), p = (int)(qp_pair % nprobe);
    int seg = probes[qp_pair];
    seg = min(max(seg, 0), n_clusters - 1);           // mode="clip"
    const int r0 = c * rows_per_chunk, r1 = min(cap, r0 + rows_per_chunk);
    const long long seg_row0 = (long long)seg * cap;

    for (int i = threadIdx.x; i < kpad; i += THREADS)
        q_s[i] = i < k ? qp[(long long)q * k + i] : 0.f;
    for (int i = threadIdx.x; i < WARPS * kk; i += THREADS) {
        list_d[i] = CUDART_INF_F;
        list_p[i] = NO_POS;
    }
    __syncthreads();
    if (w == 0) {
        float s = 0.f;
        for (int i = lane; i < k; i += 32) s = fmaf(q_s[i], q_s[i], s);
        #pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) qn_s = s;
    }
    __syncthreads();
    const float qn = qn_s;

    float* ld = list_d + w * kk;
    int* lp = list_p + w * kk;
    float thr_d = CUDART_INF_F;
    int thr_p = NO_POS;
    const int nslices = kpad / KS;
    const int nsteps = (r1 > r0 ? (r1 - r0 + TR - 1) / TR : 0) * nslices;
    float acc[RPW];

    if (nsteps > 0)
        load_slice<VEC4>(tiles[0], g, seg_row0 + r0, min(TR, r1 - r0), k, 0);
    for (int st = 0; st < nsteps; ++st) {
        const int t = st / nslices, sl = st % nslices;
        if (sl == 0) {
            #pragma unroll
            for (int j = 0; j < RPW; ++j) acc[j] = 0.f;
        }
        if (st + 1 < nsteps) {
            const int rr = r0 + ((st + 1) / nslices) * TR;
            load_slice<VEC4>(tiles[(st + 1) & 1], g, seg_row0 + rr,
                             min(TR, r1 - rr), k, ((st + 1) % nslices) * KS);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const Slice& s = tiles[st & 1];
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[sl * KS + 4 * lane]);
        #pragma unroll
        for (int j = 0; j < RPW; ++j) {
            const float4 gv =
                *reinterpret_cast<const float4*>(&s.v[w * RPW + j][4 * lane]);
            acc[j] = fmaf(qv.x, gv.x, acc[j]);
            acc[j] = fmaf(qv.y, gv.y, acc[j]);
            acc[j] = fmaf(qv.z, gv.z, acc[j]);
            acc[j] = fmaf(qv.w, gv.w, acc[j]);
        }
        __syncthreads();            // the load after next overwrites s
        if (sl == nslices - 1) {
            #pragma unroll
            for (int j = 0; j < RPW; ++j) {
                float v = acc[j];
                #pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    v += __shfl_xor_sync(0xffffffffu, v, o);  // same in every lane
                const int r = r0 + t * TR + w * RPW + j;
                if (r >= r1) continue;                        // uniform in the warp
                float d = __fsub_rn(__fadd_rn(qn, gn[seg_row0 + r]),
                                    __fmul_rn(2.f, v));
                d = fmaxf(d, 0.f);
                const int pos = p * cap + r;
                if (kk == 0) {
                    if (lane == 0) dump[(long long)q * nprobe * cap + pos] = d;
                } else if (lex_less(d, pos, thr_d, thr_p)) {
                    warp_insert(ld, lp, kk, d, pos, lane);
                    thr_d = ld[kk - 1];
                    thr_p = lp[kk - 1];
                }
            }
        }
    }
    if (kk == 0) return;
    __syncthreads();
    if (w == 0) {
        warp_merge(list_d, list_p, WARPS, kk, blk_d, blk_p, lane);
        __syncwarp();
        for (int i = lane; i < kk; i += 32) {
            cand_d[blk * kk + i] = blk_d[i];
            cand_p[blk * kk + i] = blk_p[i];
        }
    }
}

template <bool VEC4>
int launch_scan(const int* probes, const float* qp, const float* g,
                const float* gn, float* cand_d, int* cand_p, float* dump,
                long long nblocks, int nprobe, int n_clusters, int cap, int k,
                int kk, int rows_per_chunk, int nchunk, cudaStream_t stream) {
    const size_t bytes = smem_bytes(k, kk);
    cudaError_t err = cudaFuncSetAttribute(
        ivf_scan<VEC4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ivf_scan<VEC4><<<(unsigned)nblocks, THREADS, bytes, stream>>>(
        probes, qp, g, gn, cand_d, cand_p, dump, nprobe, n_clusters, cap, k,
        kk, rows_per_chunk, nchunk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ivf_scan_max_k() { return topk_list::MAX_K; }
int ivf_scan_tile_rows() { return TR; }
long long ivf_scan_smem_bytes(int k, int kk) { return (long long)smem_bytes(k, kk); }

// One call runs ivf_scan and merge_lists (kk <= MAX_K), or ivf_scan and
// select_wide (kk > MAX_K), on `stream`. Scratch is the caller's: cand_d /
// cand_p (nq, nprobe * nchunk, kk) for lists, dump (nq, nprobe * cap) for
// the wide path. vec4 != 0 takes 16-byte copies (k % 4 == 0 and g
// 16-byte aligned). Returns the first non-zero cudaError_t, else 0.
int ivf_scan_launch(const int* probes, const float* qp, const float* g,
                    const float* gn, const int* ids, float* cand_d,
                    int* cand_p, float* dump, float* out_d, int* out_i,
                    int nq, int nprobe, int n_clusters, int cap, int k,
                    int kk, int rows_per_chunk, int nchunk, int vec4,
                    void* stream_ptr) {
    if (kk < 1 || (long long)kk > (long long)nprobe * cap || nq < 1 ||
        nprobe < 1 || cap < 1 || k < 1 || n_clusters < 1 || nchunk < 1 ||
        rows_per_chunk < 1)
        return (int)cudaErrorInvalidValue;
    const bool wide = kk > topk_list::MAX_K;
    const int lists = wide ? 0 : kk;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const long long nblocks = (long long)nq * nprobe * nchunk;
    int err = vec4
        ? launch_scan<true>(probes, qp, g, gn, cand_d, cand_p, dump, nblocks,
                            nprobe, n_clusters, cap, k, lists, rows_per_chunk,
                            nchunk, stream)
        : launch_scan<false>(probes, qp, g, gn, cand_d, cand_p, dump, nblocks,
                             nprobe, n_clusters, cap, k, lists,
                             rows_per_chunk, nchunk, stream);
    if (err != 0) return err;
    if (wide) {
        topk_list::select_wide<<<nq, topk_list::SELECT_THREADS, 0, stream>>>(
            dump, nprobe * cap, kk, probes, ids, nprobe, n_clusters, cap,
            out_d, out_i);
        return (int)cudaGetLastError();
    }
    const int nlists = nprobe * nchunk;
    topk_list::merge_lists<<<nq, topk_list::MERGE_THREADS, (size_t)nlists * sizeof(int), stream>>>(
        cand_d, cand_p, probes, ids, out_d, out_i, nlists, kk, nprobe,
        n_clusters, cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
