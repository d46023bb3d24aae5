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
//   warp_fill     an empty list from the warp's candidates, sorted at
//                 once (warp_sort: a bitonic network over shuffles);
//   block_merge_runs  a block merges sorted lists pairwise, in levels;
//   merge_tree    one block per query merges the scan blocks' lists (in
//                 batches when they do not fit shared memory at once) and
//                 maps each position back to its row id through the probe
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
// src-size operand zero-fills what lies past the valid bytes. bulk_copy
// moves a contiguous range with one instruction (the bulk-copy engine,
// completion counted on an mbarrier).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace topk_list {

constexpr int MAX_K = 256;
constexpr int KR = MAX_K / 32;      // list entries a lane holds in an insert
constexpr int NO_POS = 0x7fffffff;
constexpr int TREE_THREADS = 1024;

__device__ __forceinline__ bool lex_less(float ad, int ai, float bd, int bi) {
    return ad < bd || (ad == bd && ai < bi);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier for one arrival; visible to the bulk-copy engine
__device__ __forceinline__ void mbar_init1(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 "fence.mbarrier_init.release.cluster;\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// `bytes` (a multiple of 16; src and dst 16-byte aligned) from global to
// shared memory, completing on bar's current phase, which this call
// arms; one thread issues it
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%2], [%3], %1, [%0];\n"
        :: "r"(smem_u32(bar)), "r"(bytes), "r"(smem_u32(dst)), "l"(src)
        : "memory");
}

// wait for the phase of parity `parity` of bar; a wait that never ends
// traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const long long t0 = clock64();
    uint32_t done = 0;
    while (!done) {
        if (clock64() - t0 > (1ll << 35)) __trap();     // ~20 s
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    }
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

// (d, pos) as one 64-bit key in the same order: a distance is >= 0 (the
// scans clamp it), so its f32 bits order as the values do (-0 as 0)
__device__ __forceinline__ unsigned long long select_key(float d, int pos) {
    uint32_t u = __float_as_uint(d);
    if (u == 0x80000000u) u = 0u;
    return (static_cast<unsigned long long>(u) << 32) | static_cast<uint32_t>(pos);
}

// The warp's 32 * R keys (key[r] of lane l is element R * l + r) sorted
// ascending across the warp: a bitonic network, partners in other lanes
// reached by shuffles. Sorts a tile's candidates at once where a list is
// still empty, in place of one warp_insert each.
template <int R>
__device__ __forceinline__ void warp_sort(unsigned long long (&key)[R],
                                          int lane) {
    #pragma unroll
    for (int size = 2; size <= 32 * R; size <<= 1) {
        #pragma unroll
        for (int j = size >> 1; j > 0; j >>= 1) {
            if (j < R) {                    // both elements in this lane
                #pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int e = R * lane + r;
                    if ((e & j) == 0) {
                        const bool up = (e & size) == 0;
                        if ((key[r] > key[r + j]) == up) {
                            const unsigned long long x = key[r];
                            key[r] = key[r + j];
                            key[r + j] = x;
                        }
                    }
                }
                continue;
            }
            #pragma unroll
            for (int r = 0; r < R; ++r) {
                const int e = R * lane + r;
                const unsigned long long o =
                    __shfl_xor_sync(0xffffffffu, key[r], j / R);
                const bool up = (e & size) == 0, lower = (e & j) == 0;
                key[r] = (lower == up) ? (o < key[r] ? o : key[r])
                                       : (o > key[r] ? o : key[r]);
            }
        }
    }
}

// A sorted list of kk entries started from the warp's 32 * R candidate
// keys (select_key; ~0 for none): the first kk of them, sorted; entries
// past them keep their fillers. The list must hold only fillers before.
template <int R>
__device__ __forceinline__ void warp_fill(float* ld, int* lp, int kk,
                                          unsigned long long (&key)[R],
                                          int lane) {
    warp_sort<R>(key, lane);
    #pragma unroll
    for (int r = 0; r < R; ++r) {
        const int e = R * lane + r;
        if (e < kk && key[r] != ~0ull) {
            ld[e] = __uint_as_float((uint32_t)(key[r] >> 32));
            lp[e] = (int)(uint32_t)key[r];
        }
    }
    __syncwarp();
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

// Merges n sorted runs of kk (d, pos) entries, run j at d / p + j * kk,
// pairwise in ceil(log2 n) levels, each pair's first kk by merge path:
// output i of a pair finds by binary search how many of its first i
// entries come from the first run (which wins ties: equal entries are
// fillers). Levels ping-pong between d / p and sd / sp (room for
// ceil(n / 2) runs), one block barrier each; an odd last run is copied.
// Returns the buffer that holds the merged run at its start: 0 for d / p,
// 1 for sd / sp. Every thread of the block calls it; the runs must be in
// place (a barrier) before.
__device__ int block_merge_runs(float* d, int* p, float* sd, int* sp, int n,
                                int kk) {
    int cur = 0;
    while (n > 1) {
        const int half = (n + 1) / 2;
        const float* id = cur ? sd : d;
        const int* ip = cur ? sp : p;
        float* od = cur ? d : sd;
        int* op = cur ? p : sp;
        for (int o = threadIdx.x; o < half * kk; o += blockDim.x) {
            const int j = o / kk, i = o % kk;
            const float* ad = id + 2 * j * kk;
            const int* ap = ip + 2 * j * kk;
            if (2 * j + 1 >= n) {
                od[o] = ad[i];
                op[o] = ap[i];
                continue;
            }
            const float* bd = ad + kk;
            const int* bp = ap + kk;
            int lo = max(0, i - kk), hi = min(i, kk);
            while (lo < hi) {               // entries of A among the first i
                const int mid = (lo + hi) >> 1;
                if (!lex_less(bd[i - mid - 1], bp[i - mid - 1], ad[mid], ap[mid]))
                    lo = mid + 1;
                else
                    hi = mid;
            }
            const int b = i - lo;
            const bool from_a = lo < kk &&
                (b >= kk || !lex_less(bd[b], bp[b], ad[lo], ap[lo]));
            od[o] = from_a ? ad[lo] : bd[b];
            op[o] = from_a ? ap[lo] : bp[b];
        }
        __syncthreads();
        cur ^= 1;
        n = half;
    }
    return cur;
}

// out[q, r] = the r-th smallest (d, pos) over query q's nlists sorted
// candidate lists (each kk long), with pos mapped to its row id through
// pos_to_id. One block per query. The lists pass through shared memory
// in batches of up to nb runs (merge_batch: as many as MERGE_STAGE_BYTES
// holds, 64 at kk 256), each copied in one coalesced pass and merged
// pairwise in levels (block_merge_runs); from the second batch on, run 0
// is the result so far and nb - 1 new lists come in. A query's positions
// are distinct (only fillers repeat, and they are equal), so the grouping
// of the merges does not change the result.
__global__ void __launch_bounds__(TREE_THREADS)
merge_tree(const float* __restrict__ cand_d, const int* __restrict__ cand_p,
           const int* __restrict__ probes, const int* __restrict__ ids,
           float* __restrict__ out_d, int* __restrict__ out_i, int nlists,
           int kk, int nb, int nprobe, int n_clusters, int cap) {
    extern __shared__ __align__(16) int merge_smem[];
    const int n = nb * kk, nh = (nb + 1) / 2 * kk;
    float* d = reinterpret_cast<float*>(merge_smem);
    int* p = reinterpret_cast<int*>(d + n);
    float* sd = reinterpret_cast<float*>(p + n);
    int* sp = reinterpret_cast<int*>(sd + nh);
    const int qi = blockIdx.x;
    const float* cd = cand_d + (long long)qi * nlists * kk;
    const int* cp = cand_p + (long long)qi * nlists * kk;
    int cur = 0, held = 0;              // held: 1 once run 0 is the result
    for (int done = 0; done < nlists;) {
        const int take = min(nb - held, nlists - done);
        const long long src = (long long)(done - held) * kk;
        for (int i = threadIdx.x; i < (held + take) * kk; i += TREE_THREADS) {
            if (i >= held * kk) {
                d[i] = cd[src + i];
                p[i] = cp[src + i];
            } else if (cur) {           // the result so far, back to run 0
                d[i] = sd[i];
                p[i] = sp[i];
            }
        }
        __syncthreads();
        cur = block_merge_runs(d, p, sd, sp, held + take, kk);
        done += take;
        held = 1;
    }
    const float* rd = cur ? sd : d;
    const int* rp = cur ? sp : p;
    for (int r = threadIdx.x; r < kk; r += TREE_THREADS) {
        const int pos = rp[r];
        out_d[(long long)qi * kk + r] = rd[r];
        out_i[(long long)qi * kk + r] = pos == NO_POS ? -1
            : pos_to_id(probes, ids, qi, pos, nprobe, n_clusters, cap);
    }
}

// records event i of `marks` (cudaEvent_t handles; none when null) on
// `stream`: the host's way to time a call's launches apart
inline void mark(void* const* marks, int i, cudaStream_t stream) {
    if (marks) cudaEventRecord(static_cast<cudaEvent_t>(marks[i]), stream);
}

// merge_tree's shared memory for a batch of nb runs of kk: the runs and
// room for the first level's output
constexpr int MERGE_STAGE_BYTES = 192 * 1024;

__host__ __device__ inline size_t merge_tree_bytes(int nb, int kk) {
    return ((size_t)nb + (nb + 1) / 2) * kk * 8;
}

// runs a merge_tree batch holds for nlists lists of kk (kk <= MAX_K): all
// of them when they fit, else the most that fit (at least 64)
inline int merge_batch(int nlists, int kk) {
    int nb = nlists;
    while (nb > 2 && merge_tree_bytes(nb, kk) > (size_t)MERGE_STAGE_BYTES)
        --nb;
    return nb;
}

// merge_tree over nq queries' nlists lists of kk on `stream`. Returns a
// cudaError_t.
inline int launch_merge(const float* cand_d, const int* cand_p,
                        const int* probes, const int* ids, float* out_d,
                        int* out_i, int nq, int nlists, int kk, int nprobe,
                        int n_clusters, int cap, cudaStream_t stream) {
    const int nb = merge_batch(nlists, kk);
    const size_t staged = merge_tree_bytes(nb, kk);
    cudaError_t err = cudaFuncSetAttribute(
        merge_tree, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)staged);
    if (err != cudaSuccess) return (int)err;
    merge_tree<<<nq, TREE_THREADS, staged, stream>>>(
        cand_d, cand_p, probes, ids, out_d, out_i, nlists, kk, nb, nprobe,
        n_clusters, cap);
    return (int)cudaGetLastError();
}

// -- the wide path ------------------------------------------------------------

constexpr int SELECT_THREADS = 1024;

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
