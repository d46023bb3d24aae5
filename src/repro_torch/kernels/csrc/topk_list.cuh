// Top-k selection shared by the scan kernels: sorted lists in shared
// memory and their merges (ivf_scan, pq_adc), and the wide selection
// (ivf_scan, pq_adc, metric_topk).
//
// A list holds up to kk (distance, position) entries in ascending
// lexicographic order; unused entries are (+inf, NO_POS). Ordering by
// candidate *position* at equal distance is what reproduces the
// reference's tie rule: a stable top-kk over the probe-major /
// slot-minor candidate stream, re-sorted by (distance, id) afterwards.
//
//   warp_insert   one candidate into a warp's list (the whole warp);
//   warp_merge    warp 0 merges a block's per-warp lists into one;
//   merge_lists   one block per query merges the blocks' lists and maps
//                 each position back to its row id through the probe
//                 table (position = probe index * cap + slot).
//
// Lists stop at MAX_K entries: an insert costs KR = MAX_K / 32 entries a
// lane, and a scan block keeps several lists in shared memory. Wider
// selections (kk > MAX_K, up to every candidate) take the wide path: the
// scan writes every candidate's distance to global memory, and
// select_wide, one block per query, finds the kk smallest (distance,
// position) keys by a radix select over their bits and writes them out
// unordered; the wrapper's final (distance, id) sort orders them.
//
// The cp.async helpers copy global -> shared without registers; the
// src-size operand zero-fills what lies past the valid bytes.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace topk_list {

constexpr int MAX_K = 256;
constexpr int KR = MAX_K / 32;      // list entries a lane holds in an insert
constexpr int NO_POS = 0x7fffffff;
constexpr int MERGE_THREADS = 256;

__device__ __forceinline__ bool lex_less(float ad, int ai, float bd, int bi) {
    return ad < bd || (ad == bd && ai < bi);
}

// (d, pos, src) total order: src breaks ties between filler entries, so
// every lane of a reduction agrees on one winner
__device__ __forceinline__ bool lex_less3(float ad, int ap, int as, float bd,
                                          int bp, int bs) {
    return ad < bd || (ad == bd && (ap < bp || (ap == bp && as < bs)));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(pred ? 4 : 0));
}

// 16-byte copy of which the first src_bytes (0..16) are read; the rest
// of the destination is zero. src must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Insert (d, p) into the ascending list ld/lp of length k; the whole
// warp takes part with the same (d, p). A candidate that ranks k-th or
// later is dropped. Inserts are rare once a list fills: out of line.
__device__ __noinline__ void warp_insert(float* ld, int* lp, int k, float d,
                                         int p, int lane) {
    float od[KR];
    int op[KR];
    int cnt = 0;
    #pragma unroll
    for (int r = 0; r < KR; ++r) {
        int i = lane + 32 * r;
        od[r] = CUDART_INF_F;
        op[r] = NO_POS;
        if (i < k) {
            od[r] = ld[i];
            op[r] = lp[i];
            cnt += lex_less(od[r], op[r], d, p);
        }
    }
    const int at = __reduce_add_sync(0xffffffffu, cnt);
    __syncwarp();
    if (at >= k) return;                  // uniform across the warp
    #pragma unroll
    for (int r = 0; r < KR; ++r) {
        int i = lane + 32 * r;
        if (i >= at && i < k - 1) {
            ld[i + 1] = od[r];
            lp[i + 1] = op[r];
        }
    }
    if (lane == 0) {
        ld[at] = d;
        lp[at] = p;
    }
    __syncwarp();
}

// The kk smallest entries of nlists (<= 32) sorted lists of kk entries
// each (list l at ld + l * kk), written ascending to out_d / out_p. One
// warp: lane l holds list l's head; kk rounds of a warp argmin.
__device__ void warp_merge(const float* ld, const int* lp, int nlists,
                           int kk, float* out_d, int* out_p, int lane) {
    int h = 0;
    for (int r = 0; r < kk; ++r) {
        const bool live = lane < nlists && h < kk;
        float bd = live ? ld[lane * kk + h] : CUDART_INF_F;
        int bp = live ? lp[lane * kk + h] : NO_POS;
        int bs = live ? lane : 32;
        #pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            float od = __shfl_xor_sync(0xffffffffu, bd, o);
            int op = __shfl_xor_sync(0xffffffffu, bp, o);
            int os = __shfl_xor_sync(0xffffffffu, bs, o);
            if (lex_less3(od, op, os, bd, bp, bs)) { bd = od; bp = op; bs = os; }
        }
        if (lane == 0) {
            out_d[r] = bd;
            out_p[r] = bp;
        }
        if (lane == bs) ++h;
    }
}

// the row id of query qi's candidate position pos (probe index * cap +
// slot): ids[probes[qi, pos / cap] * cap + pos % cap], probe ids clipped
// to [0, n_clusters) as the reference's mode="clip" gather
__device__ __forceinline__ int pos_to_id(const int* __restrict__ probes,
                                         const int* __restrict__ ids, int qi,
                                         int pos, int nprobe, int n_clusters,
                                         int cap) {
    int seg = probes[(long long)qi * nprobe + pos / cap];
    seg = min(max(seg, 0), n_clusters - 1);
    return ids[(long long)seg * cap + pos % cap];
}

// out[q, r] = the r-th smallest (d, pos) over query q's nlists sorted
// candidate lists (each kk long), with pos mapped to its row id:
// ids[probes[q, pos / cap] * cap + pos % cap] (probe ids clipped to
// [0, n_clusters), as the reference's mode="clip" gather).
__global__ void __launch_bounds__(MERGE_THREADS)
merge_lists(const float* __restrict__ cand_d, const int* __restrict__ cand_p,
            const int* __restrict__ probes, const int* __restrict__ ids,
            float* __restrict__ out_d, int* __restrict__ out_i, int nlists,
            int kk, int nprobe, int n_clusters, int cap) {
    extern __shared__ int head[];                 // nlists list heads
    __shared__ float wd[MERGE_THREADS / 32];
    __shared__ int wp[MERGE_THREADS / 32], ws[MERGE_THREADS / 32];
    const int qi = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const float* cd = cand_d + (long long)qi * nlists * kk;
    const int* cp = cand_p + (long long)qi * nlists * kk;
    for (int s = threadIdx.x; s < nlists; s += MERGE_THREADS) head[s] = 0;
    __syncthreads();
    for (int r = 0; r < kk; ++r) {
        float bd = CUDART_INF_F;
        int bp = NO_POS, bs = 0x7fffffff;
        for (int s = threadIdx.x; s < nlists; s += MERGE_THREADS) {
            int h = head[s];
            if (h < kk) {
                float d = cd[(long long)s * kk + h];
                int p = cp[(long long)s * kk + h];
                if (lex_less3(d, p, s, bd, bp, bs)) { bd = d; bp = p; bs = s; }
            }
        }
        #pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            float od = __shfl_xor_sync(0xffffffffu, bd, o);
            int op = __shfl_xor_sync(0xffffffffu, bp, o);
            int os = __shfl_xor_sync(0xffffffffu, bs, o);
            if (lex_less3(od, op, os, bd, bp, bs)) { bd = od; bp = op; bs = os; }
        }
        if (lane == 0) { wd[w] = bd; wp[w] = bp; ws[w] = bs; }
        __syncthreads();
        if (threadIdx.x == 0) {
            float fd = wd[0];
            int fp = wp[0], fs = ws[0];
            for (int v = 1; v < MERGE_THREADS / 32; ++v)
                if (lex_less3(wd[v], wp[v], ws[v], fd, fp, fs)) {
                    fd = wd[v]; fp = wp[v]; fs = ws[v];
                }
            const int id = fp == NO_POS ? -1
                : pos_to_id(probes, ids, qi, fp, nprobe, n_clusters, cap);
            out_d[(long long)qi * kk + r] = fd;
            out_i[(long long)qi * kk + r] = id;
            if (fs < nlists) head[fs] += 1;
        }
        __syncthreads();
    }
}

// -- the wide path ------------------------------------------------------------

constexpr int SELECT_THREADS = 1024;

// (d, pos) as one 64-bit key in the same order: a distance is >= 0 (the
// scans clamp it), so its f32 bits order as the values do (-0 as 0)
__device__ __forceinline__ unsigned long long select_key(float d, int pos) {
    uint32_t u = __float_as_uint(d);
    if (u == 0x80000000u) u = 0u;
    return (static_cast<unsigned long long>(u) << 32) | static_cast<uint32_t>(pos);
}

// out_d / out_i[q, 0..kk) = the kk smallest (d, pos) keys of dist[q,
// 0..pool) (pos = the column), in no order; ids through pos_to_id when
// probes is given, else the position itself. One block per query: a
// radix select, 8 bits a pass from the top, histograms of the keys that
// share the prefix found so far (warp-aggregated shared atomics); it
// stops at the first pass whose digit holds exactly the keys still
// wanted. Then every key at or below the prefix is written out.
__global__ void __launch_bounds__(SELECT_THREADS)
select_wide(const float* __restrict__ dist, int pool, int kk,
            const int* __restrict__ probes, const int* __restrict__ ids,
            int nprobe, int n_clusters, int cap, float* __restrict__ out_d,
            int* __restrict__ out_i) {
    __shared__ unsigned int hist[256];
    __shared__ unsigned long long s_prefix, s_mask;
    __shared__ int s_rem, s_done;
    __shared__ unsigned int s_count;
    const int qi = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
    const float* dq = dist + (long long)qi * pool;
    unsigned long long prefix = 0, mask = 0;
    int rem = kk;
    for (int shift = 56; shift >= 0; shift -= 8) {
        for (int b = tid; b < 256; b += SELECT_THREADS) hist[b] = 0u;
        __syncthreads();
        for (int i = tid; i < pool; i += SELECT_THREADS) {
            const unsigned long long key = select_key(dq[i], i);
            if ((key & mask) == prefix) {
                const unsigned digit = (unsigned)(key >> shift) & 255u;
                const unsigned peers = __match_any_sync(__activemask(), digit);
                if (lane == __ffs(peers) - 1)
                    atomicAdd(&hist[digit], (unsigned)__popc(peers));
            }
        }
        __syncthreads();
        if (tid == 0) {
            int below = 0, b = 0;
            while (below + (int)hist[b] < rem) below += hist[b++];
            s_rem = rem - below;
            s_done = (int)hist[b] == rem - below;
            s_prefix = prefix | ((unsigned long long)b << shift);
            s_mask = mask | (255ull << shift);
        }
        __syncthreads();
        prefix = s_prefix;
        mask = s_mask;
        rem = s_rem;
        if (s_done) break;          // uniform: read after the barrier
    }
    if (tid == 0) s_count = 0u;
    __syncthreads();
    for (int i = tid; i < pool; i += SELECT_THREADS) {
        const float d = dq[i];
        if ((select_key(d, i) & mask) <= prefix) {
            const long long o = (long long)qi * kk + atomicAdd(&s_count, 1u);
            out_d[o] = d;
            out_i[o] = probes ? pos_to_id(probes, ids, qi, i, nprobe,
                                          n_clusters, cap)
                              : i;
        }
    }
}

}  // namespace topk_list
