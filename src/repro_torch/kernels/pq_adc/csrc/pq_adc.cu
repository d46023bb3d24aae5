// Fused PQ ADC segment scan + top-kk for Hopper (sm_90a), f32 over
// uint8 codes.
//
// Replaces the TPU kernel repro/kernels/pq_adc/kernel.py::
// pq_adc_topk_fused (Pallas) and computes the same function, bit for
// bit: for each query q and each of its nprobe probed clusters
// c = probes[q, p], score the cap code rows of segment c,
//
//   ip = LUT[0, code_0] + LUT[1, code_1] + ... + LUT[S-1, code_{S-1}]
//        (summed left to right, in subspace order)
//   d  = max((dc[q, p] + t[row]) - 2 ip, 0),
//
// and keep the kk smallest (d, position) pairs, position = p * cap +
// slot. Output: (Nq, kk) distances and row ids in (d, position) order;
// the wrapper masks d >= BIG to id -1 and applies the final (d, id) sort.
//
// What bounds it. A scanned row moves S + 4 bytes (codes and t; the ids
// are read only for the kk winners) and costs S shared-memory lookups
// and adds. At the serving shapes (S = 100, K = 256, cap = 1224,
// nprobe = 16) a query reads 2.0 MB of codes plus its 102 KB table, so
// at small batches the launch, the table load and the merge dominate;
// at large batches device memory (codes of the distinct probed
// segments) and the table lookups do.
//
// What the design does about it. The TPU kernel streams one query's
// probe/tile stream through a sequential grid axis, with the table
// lookups done as S one-hot matmuls on the MXU. Hopper blocks run in
// parallel in no order and have no use for the one-hot trick: a table in
// shared memory is a gather. So:
//
//   1. pq_adc: one block per (query, probe, row chunk). The query's
//      table (S * K f32: 102,400 bytes at S = 100, K = 256) is copied into
//      dynamic shared memory once per block. Code rows stream through
//      shared memory in 256-row tiles, double-buffered with 16-byte
//      cp.async copies of the tile's contiguous byte range (a row is S
//      bytes, not 16-byte aligned: the copy starts at the aligned address
//      below the tile and the zero-filled tail stops at the array's end).
//      One thread scores one row, adding LUT[s * K + code_s] for s = 0 ..
//      S-1 in order, exactly as the plain version's sequential sum; 2 ip
//      is exact and the intrinsics below keep every operation rounded on
//      its own, so the distance is bit-identical. Each warp keeps a
//      sorted (d, position) list in shared memory; a candidate that beats
//      the kk-th entry is inserted by the whole warp; warp 0 merges the 8
//      warp lists into the block's list;
//   2. merge_lists (topk_list.cuh): one block per query merges its
//      blocks' lists by (d, position) and maps positions to row ids.
//
// Ties: ordering by position at equal distance selects the same kk
// candidates as the reference's stable top-kk over the probe-major /
// slot-minor stream, so ids are bit-identical too after the final sort.
//
// Tables larger than shared memory. From about S = 146 at K = 256 the
// table, two whole-row code tiles and the lists pass a block's 227 KB
// (S = 200 needs 310,832 bytes at kk 50). Then the block walks each
// 256-row tile in chunks of sc subspaces (sc from the wrapper's plan,
// the most that fit): the chunk's sc x K table slice and the tile's sc
// code bytes of each row are staged in shared memory, and each thread
// carries its row's partial sum in a register from chunk to chunk,
// adding in ascending subspace order, so the sum is the same sequential
// one and the result stays bit-identical. The table is then read again
// for every tile (from L2).
//
// Wide lists (kk > topk_list::MAX_K): the block writes every candidate's
// distance to dump[q, position] instead of keeping lists, and
// topk_list::select_wide picks the kk smallest (d, position) per query.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "../../csrc/topk_list.cuh"

namespace {

using namespace topk_list;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TR = THREADS;             // code rows per tile: one a thread

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline size_t tile_bytes(int S) {
    return round16((size_t)TR * S + 16);            // + room for the misalignment
}

__host__ __device__ inline size_t lut_bytes(int S, int K) {
    return round16((size_t)S * K * sizeof(float));  // tiles 16-aligned
}

// the block's table (or table chunk), code tiles and lists: whole rows
// double-buffered when sc == S, else one tile of sc code bytes a row
__host__ __device__ inline size_t smem_bytes(int S, int K, int kk, int sc) {
    const size_t lists = (size_t)(WARPS + 1) * kk * (sizeof(float) + sizeof(int));
    if (sc >= S) return lut_bytes(S, K) + 2 * tile_bytes(S) + lists;
    return lut_bytes(sc, K) + round16((size_t)TR * sc) + lists;
}

// The code bytes of rows [row0, row0 + nrows) into `tile`, from the
// 16-byte aligned address at or below their start; returns the offset of
// the first row's first byte in the tile. Bytes past `total` (the end of
// the codes array) are not read.
__device__ __forceinline__ int load_codes(unsigned char* tile,
                                          const uint8_t* __restrict__ codes,
                                          long long total, long long row0,
                                          int nrows, int S) {
    const long long start = row0 * S;
    const long long a = start & ~15LL;
    const int off = (int)(start - a);
    const int nchunks = (off + nrows * S + 15) / 16;
    for (int i = threadIdx.x; i < nchunks; i += THREADS) {
        const long long at = a + 16LL * i;
        const long long left = total - at;
        const int n = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
        cp_async16(tile + 16 * i, n > 0 ? codes + at : codes, n);
    }
    cp_async_commit();
    return off;
}

// kk > 0: sorted per-warp lists of kk (d, position), merged into the
// block's list; kk == 0: every distance to dump[q, position] (the wide
// path). CHUNKED: the table in chunks of sc subspaces (above).
template <bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
pq_adc(const int* __restrict__ probes, const float* __restrict__ tables,
       const float* __restrict__ dc, const uint8_t* __restrict__ codes,
       const float* __restrict__ t, float* __restrict__ cand_d,
       int* __restrict__ cand_p, float* __restrict__ dump, int nprobe,
       int n_clusters, int cap, int S, int K, int kk, int sc,
       int rows_per_chunk, int nchunk) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* lut = reinterpret_cast<float*>(smem);
    unsigned char* tiles = smem + lut_bytes(CHUNKED ? sc : S, K);
    const size_t tb = CHUNKED ? round16((size_t)TR * sc) : tile_bytes(S);
    float* list_d = reinterpret_cast<float*>(tiles + (CHUNKED ? 1 : 2) * tb);
    int* list_p = reinterpret_cast<int*>(list_d + WARPS * kk);
    float* blk_d = reinterpret_cast<float*>(list_p + WARPS * kk);
    int* blk_p = reinterpret_cast<int*>(blk_d + kk);

    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long blk = blockIdx.x;
    const int c = (int)(blk % nchunk);
    const long long qp_pair = blk / nchunk;           // q * nprobe + p
    const int q = (int)(qp_pair / nprobe), p = (int)(qp_pair % nprobe);
    int seg = probes[qp_pair];
    seg = min(max(seg, 0), n_clusters - 1);
    const int r0 = c * rows_per_chunk, r1 = min(cap, r0 + rows_per_chunk);
    const long long seg_row0 = (long long)seg * cap;
    const long long total = (long long)n_clusters * cap * S;
    const int ntiles = r1 > r0 ? (r1 - r0 + TR - 1) / TR : 0;

    // the first code tile streams in while the table is copied
    int off[2] = {0, 0};
    if (!CHUNKED && ntiles > 0)
        off[0] = load_codes(tiles, codes, total, seg_row0 + r0,
                            min(TR, r1 - r0), S);
    const float* tab = tables + (long long)q * S * K;
    if (!CHUNKED)
        for (int i = threadIdx.x; i < S * K; i += THREADS) lut[i] = tab[i];
    for (int i = threadIdx.x; i < WARPS * kk; i += THREADS) {
        list_d[i] = CUDART_INF_F;
        list_p[i] = NO_POS;
    }
    const float dcv = dc[qp_pair];
    float* ld = list_d + w * kk;
    int* lp = list_p + w * kk;
    float thr_d = CUDART_INF_F;
    int thr_p = NO_POS;

    for (int ti = 0; ti < ntiles; ++ti) {
        const int rr = r0 + ti * TR;
        const int r = rr + threadIdx.x;
        const bool valid = r < r1;
        float ip = 0.f;
        if (CHUNKED) {
            const int nrows = min(TR, r1 - rr);
            for (int s0 = 0; s0 < S; s0 += sc) {
                const int wd = min(sc, S - s0);
                __syncthreads();    // the last chunk's reads are done
                for (int i = threadIdx.x; i < wd * K; i += THREADS)
                    lut[i] = tab[(long long)s0 * K + i];
                for (int i = threadIdx.x; i < nrows * wd; i += THREADS)
                    tiles[i] = codes[(seg_row0 + rr + i / wd) * S + s0 + i % wd];
                __syncthreads();
                if (valid) {
                    // the partial sum carries over in ascending subspace order
                    const unsigned char* cr = tiles + threadIdx.x * wd;
                    int j = 0;
                    if (s0 == 0) ip = lut[cr[j++]];
                    for (; j < wd; ++j) ip = __fadd_rn(ip, lut[j * K + cr[j]]);
                }
            }
        } else {
            if (ti + 1 < ntiles) {
                const int rn = rr + TR;
                off[(ti + 1) & 1] = load_codes(tiles + ((ti + 1) & 1) * tb,
                                               codes, total, seg_row0 + rn,
                                               min(TR, r1 - rn), S);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();        // the tile (and, at ti = 0, the table)
            if (valid) {
                const unsigned char* cr =
                    tiles + (ti & 1) * tb + off[ti & 1] + threadIdx.x * S;
                ip = lut[cr[0]];
                for (int s = 1; s < S; ++s) ip = __fadd_rn(ip, lut[s * K + cr[s]]);
            }
        }
        float d = CUDART_INF_F;
        if (valid) {
            d = __fsub_rn(__fadd_rn(dcv, t[seg_row0 + r]), __fmul_rn(2.f, ip));
            d = fmaxf(d, 0.f);
        }
        const int pos = p * cap + r;
        if (kk == 0) {
            if (valid) dump[(long long)q * nprobe * cap + pos] = d;
        } else {
            unsigned mask = __ballot_sync(
                0xffffffffu, valid && lex_less(d, pos, thr_d, thr_p));
            while (mask) {
                const int src = __ffs(mask) - 1;
                mask &= mask - 1;
                const float cd = __shfl_sync(0xffffffffu, d, src);
                const int cp = __shfl_sync(0xffffffffu, pos, src);
                warp_insert(ld, lp, kk, cd, cp, lane);
            }
            thr_d = ld[kk - 1];
            thr_p = lp[kk - 1];
        }
        if (!CHUNKED) __syncthreads();  // the load after next overwrites this tile
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

template <bool CHUNKED>
int launch_scan(const int* probes, const float* tables, const float* dc,
                const uint8_t* codes, const float* t, float* cand_d,
                int* cand_p, float* dump, long long nblocks, int nprobe,
                int n_clusters, int cap, int S, int K, int kk, int sc,
                int rows_per_chunk, int nchunk, cudaStream_t stream) {
    const size_t bytes = smem_bytes(S, K, kk, sc);
    cudaError_t err = cudaFuncSetAttribute(
        pq_adc<CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    pq_adc<CHUNKED><<<(unsigned)nblocks, THREADS, bytes, stream>>>(
        probes, tables, dc, codes, t, cand_d, cand_p, dump, nprobe,
        n_clusters, cap, S, K, kk, sc, rows_per_chunk, nchunk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pq_adc_max_k() { return topk_list::MAX_K; }
int pq_adc_tile_rows() { return TR; }
long long pq_adc_smem_bytes(int S, int K, int kk, int sc) {
    return (long long)smem_bytes(S, K, kk, sc);
}

// One call runs pq_adc and merge_lists (kk <= MAX_K), or pq_adc and
// select_wide (kk > MAX_K), on `stream`, the table in chunks of sc
// subspaces when sc < S. Scratch is the caller's: cand_d / cand_p (nq,
// nprobe * nchunk, kk) for lists, dump (nq, nprobe * cap) for the wide
// path. codes must be 16-byte aligned. Returns the first non-zero
// cudaError_t, else 0.
int pq_adc_launch(const int* probes, const float* tables, const float* dc,
                  const uint8_t* codes, const float* t, const int* ids,
                  float* cand_d, int* cand_p, float* dump, float* out_d,
                  int* out_i, int nq, int nprobe, int n_clusters, int cap,
                  int S, int K, int kk, int sc, int rows_per_chunk,
                  int nchunk, void* stream_ptr) {
    if (kk < 1 || (long long)kk > (long long)nprobe * cap || nq < 1 ||
        nprobe < 1 || cap < 1 || S < 1 || K < 1 || sc < 1 || sc > S ||
        n_clusters < 1 || nchunk < 1 || rows_per_chunk < 1)
        return (int)cudaErrorInvalidValue;
    const bool wide = kk > topk_list::MAX_K;
    const int lists = wide ? 0 : kk;
    if (smem_bytes(S, K, lists, sc) > 232448) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const long long nblocks = (long long)nq * nprobe * nchunk;
    int err = sc < S
        ? launch_scan<true>(probes, tables, dc, codes, t, cand_d, cand_p,
                            dump, nblocks, nprobe, n_clusters, cap, S, K,
                            lists, sc, rows_per_chunk, nchunk, stream)
        : launch_scan<false>(probes, tables, dc, codes, t, cand_d, cand_p,
                             dump, nblocks, nprobe, n_clusters, cap, S, K,
                             lists, sc, rows_per_chunk, nchunk, stream);
    if (err != 0) return err;
    if (wide) {
        topk_list::select_wide<<<nq, topk_list::SELECT_THREADS, 0, stream>>>(
            dump, nprobe * cap, kk, probes, ids, nprobe, n_clusters, cap,
            out_d, out_i);
        return (int)cudaGetLastError();
    }
    const int nlists = nprobe * nchunk;
    topk_list::merge_lists<<<nq, topk_list::MERGE_THREADS,
                             (size_t)nlists * sizeof(int), stream>>>(
        cand_d, cand_p, probes, ids, out_d, out_i, nlists, kk, nprobe,
        n_clusters, cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
