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
// What bounds it. A probed segment is cap rows of 4k + 4 bytes (g, gn;
// the ids are read only for the kk winners). At the serving shapes (k
// 1000, cap 1224, nprobe 16, Nq 64) the 1024 (query, probe) pairs probe
// about 359 distinct segments of 4.9 MB: 1.76 GB when each is read once,
// and at most nprobe * Nq / 359 ~ 3 FLOP a byte, far below the card's
// f32 ratio (67 TFLOP/s over 3.35 TB/s = 20). So the scan is bound by
// device memory, and by how often it reads a segment.
//
// What the design does about it. The TPU kernel walks one query's
// probe/tile stream as a sequential grid axis; a grid of one block per
// (query, probe) on Hopper reads a segment once for every query that
// probes it (about 5 GB through L2 at the serving shapes). This kernel
// is cluster-major instead: it reads each probed segment once per group
// of up to QB = 8 pairs that probe it.
//
//   1. ivf_plan (one block, no host synchronisation): sorts the call's
//      pairs by (segment, pair index), a bitonic sort of 64-bit keys in
//      shared memory, and cuts each segment's run into groups of at most
//      QB pairs: group g is order[gfirst[g] .. gfirst[g] + gcount[g]) of
//      segment gseg[g], and the group count lands in ngroups on the
//      device. Calls with
//      more than PLAN_MAX pairs plan and scan PLAN_MAX pairs at a time.
//   2. ivf_scan: one block per (group, row chunk); the grid is sized from
//      an upper bound of the group count (max_groups) and blocks past
//      ngroups return at once, so the launch never waits for the plan on
//      the host and replays from a CUDA graph. A segment is cut into
//      chunks of whole tiles only when too few blocks would fill the card
//      (small Nq). The block streams its chunk's rows in 32-row tiles of
//      128-float k-slices, NSTAGE deep with cp.async (16-byte copies when
//      k is a multiple of 4, 4-byte otherwise), and the same k-slice of
//      its pairs' query rows beside them, so k has no limit. Warp w owns
//      rows 4w .. 4w+3 of a tile: lane l multiplies float4 l of each slice
//      of its 4 rows with every pair's, so each staged g value feeds one
//      FMA per pair of the group (at QB = 8 the work stays well below the
//      f32 ratio above, so FFMA is enough and the tensor cores would buy
//      nothing); the first tile's slices also give each pair's ||q||^2.
//      After a tile's last slice a transposed shuffle reduction (16 + 8 +
//      4 + 2 + 1 shuffles for the warp's 32 sums) leaves lane l the dot
//      product of row l / 8 and pair l % 8. The distances go to an 8 x 32
//      tile in shared memory; warp j then takes pair j's: the first
//      tile's sorted at once into pair j's (d, position) list
//      (topk_list::warp_fill), later ones inserted one at a time where
//      they beat its kk-th entry; the list goes to cand[pair, chunk] at
//      the end;
//   3. merge_tree (topk_list.cuh): one block per query merges its pairs'
//      and chunks' lists by (d, position) in shared memory and maps
//      positions to row ids.
//
// Every (query, row) dot product is the same sum whatever the plan: lane
// l's partial over float4 l of every slice in order, then the fixed
// reduction tree, so grouping and chunking change no distance.
//
// Wide lists (kk > topk_list::MAX_K): the blocks write every candidate's
// distance to dump[q, position] instead of keeping lists, and
// topk_list::select_wide picks the kk smallest (d, position) per query.
//
// Ragged edges (rows past the chunk, k not a multiple of the slice) are
// masked in the kernel: the copies zero-fill them. The distance is rounded
// as the plain version rounds it: (qn + gn) - 2 x. No TF32: every product
// is an f32 FFMA.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "../../csrc/topk_list.cuh"

namespace {

using namespace topk_list;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QB = WARPS;               // pairs a group: warp j keeps pair j's list
constexpr int RPW = 4;                  // rows a warp scores per tile
constexpr int TR = WARPS * RPW;         // rows per tile
constexpr int KS = 128;                 // k floats per slice (a float4 a lane)
constexpr int NSTAGE = 3;               // slices in flight
constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_MAX = 8192;          // pairs one plan sorts in shared memory

static_assert(RPW * QB == 32, "one reduced sum a lane");

struct Stage {
    float g[TR][KS];                    // segment rows
    float q[QB][KS];                    // the group's query rows
};

__host__ __device__ inline size_t smem_bytes(int kk) {
    return NSTAGE * sizeof(Stage) + sizeof(float) * QB * TR +
           (size_t)QB * kk * (sizeof(float) + sizeof(int));
}

// groups of at most QB pairs over `npairs` pairs of at most n_clusters
// segments: sum over segments of ceil(n_s / QB) <= (npairs + distinct *
// (QB - 1)) / QB, and never more than one a pair
__host__ __device__ inline int max_groups(int npairs, int n_clusters) {
    const long long distinct = npairs < n_clusters ? npairs : n_clusters;
    const long long bound = (npairs + distinct * (QB - 1) + QB - 1) / QB;
    return (int)(bound < npairs ? bound : npairs);
}

__host__ __device__ inline int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// the first index of key[0, n) at or above x (key ascending)
__device__ __forceinline__ int lower_bound(const unsigned long long* key,
                                           int n, unsigned long long x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Steps j = jtop .. 1 of bitonic stage `size` over the keys in shared
// memory, in registers: partners i ^ j (j < 32) lie in the same warp.
__device__ __forceinline__ void plan_warp_steps(unsigned long long* key,
                                                int n2, int size, int jtop) {
    for (int i = threadIdx.x; i < n2; i += PLAN_THREADS) {
        unsigned long long v = key[i];
        for (int j = jtop; j > 0; j >>= 1) {
            const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, j);
            const bool up = (i & size) == 0, lower = (i & j) == 0;
            v = (lower == up) ? (o < v ? o : v) : (o > v ? o : v);
        }
        key[i] = v;
    }
}

// Pairs [pair0, pair0 + npairs) of the call (pair = q * nprobe + p),
// sorted by (clipped segment, pair) into order[] (global pair indices);
// each segment's run cut into groups of at most QB: group g starts at
// order[gfirst[g]], holds gcount[g] pairs of segment gseg[g]; *ngroups
// groups in all. One block; n2 (a power of two, >= 32 and >= npairs) is
// the length the bitonic sort runs over: its steps across warps go
// through shared memory, one barrier each, those within a warp through
// shuffles, one barrier for all of a stage's.
__global__ void __launch_bounds__(PLAN_THREADS)
ivf_plan(const int* __restrict__ probes, int pair0, int npairs, int n2,
         int n_clusters, int* __restrict__ order, int* __restrict__ gfirst,
         int* __restrict__ gcount, int* __restrict__ gseg,
         int* __restrict__ ngroups) {
    extern __shared__ unsigned long long key[];
    __shared__ int warp_sum[PLAN_THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    for (int i = tid; i < n2; i += PLAN_THREADS) {
        unsigned long long v = ~0ull;
        if (i < npairs) {
            const int seg = min(max(probes[(long long)pair0 + i], 0),
                                n_clusters - 1);        // mode="clip"
            v = ((unsigned long long)seg << 32) | (unsigned)i;
        }
        key[i] = v;
    }
    __syncthreads();
    for (int size = 2; size <= n2; size <<= 1) {
        int j = size >> 1;
        for (; j >= 32; j >>= 1) {
            for (int i = tid; i < n2; i += PLAN_THREADS) {
                const int o = i ^ j;
                if (o > i) {
                    const unsigned long long a = key[i], b = key[o];
                    if ((a > b) == ((i & size) == 0)) {
                        key[i] = b;
                        key[o] = a;
                    }
                }
            }
            __syncthreads();
        }
        if (size <= 32) {           // every stage up to 32 in one pass
            if (size == 2) {
                for (int s = 2; s <= 32; s <<= 1)
                    plan_warp_steps(key, n2, s, s >> 1);
                __syncthreads();
            }
            continue;
        }
        plan_warp_steps(key, n2, size, 16);
        __syncthreads();
    }
    // a group starts at each QB-th entry of a segment's run; thread t
    // takes the sorted entries [lo, hi)
    const int per = (npairs + PLAN_THREADS - 1) / PLAN_THREADS;
    const int lo = min(npairs, tid * per), hi = min(npairs, lo + per);
    int starts = 0;
    for (int s = lo; s < hi; ++s) {
        const unsigned long long seg = key[s] >> 32;
        const int run0 = lower_bound(key, npairs, seg << 32);
        starts += (s - run0) % QB == 0;
    }
    // exclusive scan of the starts over the threads
    int incl = starts;
    #pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[w] = incl;
    __syncthreads();
    if (w == 0) {
        int v = warp_sum[lane];
        #pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v += u;
        }
        warp_sum[lane] = v;               // inclusive, by warp
    }
    __syncthreads();
    int gi = incl - starts + (w > 0 ? warp_sum[w - 1] : 0);
    if (tid == PLAN_THREADS - 1) *ngroups = warp_sum[31];
    for (int s = lo; s < hi; ++s) {
        const unsigned long long seg = key[s] >> 32;
        order[s] = pair0 + (int)(key[s] & 0xffffffffu);
        const int run0 = lower_bound(key, npairs, seg << 32);
        if ((s - run0) % QB == 0) {
            const int run1 = lower_bound(key, npairs, (seg + 1) << 32);
            gfirst[gi] = s;
            gcount[gi] = min(QB, run1 - s);
            gseg[gi] = (int)seg;
            ++gi;
        }
    }
}

// Rows [row0, row0 + nrows) of g (nrows <= TR), columns [k0, k0 + KS),
// and the same columns of the group's n query rows, into stage st; rows
// past nrows and columns past k read as zero (query slots past n are not
// loaded: no lane reads them).
template <bool VEC4>
__device__ __forceinline__ void load_stage(Stage& st, const float* __restrict__ g,
                                           const float* __restrict__ qp,
                                           const int* qrow, int n,
                                           long long row0, int nrows, int k,
                                           int k0) {
    if (VEC4) {
        #pragma unroll
        for (int r = 0; r < TR * KS / 4 / THREADS; ++r) {
            const int idx = threadIdx.x + r * THREADS;
            const int row = idx / (KS / 4), c = 4 * (idx % (KS / 4));
            const bool ok = row < nrows && k0 + c < k;  // k % 4 == 0: all 4 in
            cp_async16(&st.g[row][c], ok ? g + (row0 + row) * k + k0 + c : g,
                       ok ? 16 : 0);
        }
        static_assert(QB * KS / 4 == THREADS, "one query copy a thread");
        const int b = threadIdx.x / (KS / 4), c = 4 * (threadIdx.x % (KS / 4));
        if (b < n) {
            const bool ok = k0 + c < k;
            cp_async16(&st.q[b][c],
                       ok ? qp + (long long)qrow[b] * k + k0 + c : qp,
                       ok ? 16 : 0);
        }
    } else {
        #pragma unroll 4
        for (int r = 0; r < TR * KS / THREADS; ++r) {
            const int idx = threadIdx.x + r * THREADS;
            const int row = idx / KS, c = idx % KS;
            const bool ok = row < nrows && k0 + c < k;
            cp_async4(&st.g[row][c], ok ? g + (row0 + row) * k + k0 + c : g, ok);
        }
        #pragma unroll
        for (int r = 0; r < QB * KS / THREADS; ++r) {
            const int idx = threadIdx.x + r * THREADS;
            const int b = idx / KS, c = idx % KS;
            if (b < n) {
                const bool ok = k0 + c < k;
                cp_async4(&st.q[b][c],
                          ok ? qp + (long long)qrow[b] * k + k0 + c : qp, ok);
            }
        }
    }
    cp_async_commit();
}

// one step of transpose_sum: keep the O sums whose index bit O matches
// the lane's, each plus the partner lane's partial of it
template <int O, int N>
__device__ __forceinline__ void transpose_step(float (&v)[N], int lane) {
    const bool hi = lane & O;
    #pragma unroll
    for (int i = 0; i < O; ++i) {
        const float send = hi ? v[i] : v[i + O];
        const float keep = hi ? v[i + O] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
}

// v[i] is this lane's partial sum i (i < 32); returns in lane l the sum
// of v[l] over the warp: a reduce-scatter tree of 16 + 8 + 4 + 2 + 1
// shuffles
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
    transpose_step<16>(v, lane);
    transpose_step<8>(v, lane);
    transpose_step<4>(v, lane);
    transpose_step<2>(v, lane);
    transpose_step<1>(v, lane);
    return v[0];
}

// v[b] is this lane's partial of pair b's ||q||^2 (b < QB); returns in
// lane l the sum of v[l % QB] over the warp (a butterfly over lane bits
// 4 and 3, then a reduce-scatter over bits 2, 1, 0)
__device__ __forceinline__ float pair_norms(float (&v)[QB], int lane) {
    #pragma unroll
    for (int o = 16; o >= QB; o >>= 1) {
        #pragma unroll
        for (int b = 0; b < QB; ++b) v[b] += __shfl_xor_sync(0xffffffffu, v[b], o);
    }
    transpose_step<4>(v, lane);
    transpose_step<2>(v, lane);
    transpose_step<1>(v, lane);
    return v[0];
}

// kk > 0: each pair's sorted list of kk (d, position), to cand[pair,
// chunk]; kk == 0: every distance to dump[q, position] (the wide path)
template <bool VEC4>
__global__ void __launch_bounds__(THREADS, 2)
ivf_scan(const float* __restrict__ qp, const float* __restrict__ g,
         const float* __restrict__ gn, const int* __restrict__ order,
         const int* __restrict__ gfirst, const int* __restrict__ gcount,
         const int* __restrict__ gseg, const int* __restrict__ ngroups,
         float* __restrict__ cand_d, int* __restrict__ cand_p,
         float* __restrict__ dump, int nprobe, int cap, int k, int kk,
         int rows_per_chunk, int nchunk) {
    const int grp = blockIdx.x / nchunk, c = blockIdx.x % nchunk;
    if (grp >= *ngroups) return;                  // past the plan's groups
    extern __shared__ __align__(16) unsigned char smem[];
    Stage* stages = reinterpret_cast<Stage*>(smem);
    float (*dist)[TR] = reinterpret_cast<float (*)[TR]>(stages + NSTAGE);
    float* list_d = &dist[0][0] + QB * TR;        // QB lists of kk
    int* list_p = reinterpret_cast<int*>(list_d + QB * kk);
    __shared__ int s_pair[QB], s_qrow[QB];

    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int first = gfirst[grp], n = gcount[grp];
    const long long seg_row0 = (long long)gseg[grp] * cap;
    if (tid < QB) {
        const int pr = tid < n ? order[first + tid] : 0;
        s_pair[tid] = pr;
        s_qrow[tid] = pr / nprobe;
    }
    for (int i = tid; i < QB * kk; i += THREADS) {
        list_d[i] = CUDART_INF_F;
        list_p[i] = NO_POS;
    }
    __syncthreads();
    const int r0 = c * rows_per_chunk, r1 = min(cap, r0 + rows_per_chunk);
    const int nslices = (k + KS - 1) / KS;
    const int nsteps = (r1 > r0 ? (r1 - r0 + TR - 1) / TR : 0) * nslices;

    #pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (s < nsteps) {
            const int rr = r0 + (s / nslices) * TR;
            load_stage<VEC4>(stages[s], g, qp, s_qrow, n, seg_row0 + rr,
                             min(TR, r1 - rr), k, (s % nslices) * KS);
        } else {
            cp_async_commit();
        }
    }
    const int my_p = s_pair[w] % nprobe;          // warp w's pair's probe
    float* ld = list_d + w * kk;
    int* lp = list_p + w * kk;
    float thr_d = CUDART_INF_F;
    int thr_p = NO_POS;
    float acc[RPW * QB];
    float sq[QB];                   // ||q||^2 partials, first tile only
    float qn = 0.f;                 // then pair (lane % QB)'s ||q||^2
    #pragma unroll
    for (int b = 0; b < QB; ++b) sq[b] = 0.f;

    for (int st = 0; st < nsteps; ++st) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();            // slice st landed; slice st - 1 is free
        {
            const int nx = st + NSTAGE - 1;
            if (nx < nsteps) {
                const int rr = r0 + (nx / nslices) * TR;
                load_stage<VEC4>(stages[nx % NSTAGE], g, qp, s_qrow, n,
                                 seg_row0 + rr, min(TR, r1 - rr), k,
                                 (nx % nslices) * KS);
            } else {
                cp_async_commit();
            }
        }
        const int t = st / nslices, sl = st % nslices;
        if (sl == 0) {
            #pragma unroll
            for (int i = 0; i < RPW * QB; ++i) acc[i] = 0.f;
        }
        const Stage& S = stages[st % NSTAGE];
        float4 gv[RPW];
        #pragma unroll
        for (int a = 0; a < RPW; ++a)
            gv[a] = *reinterpret_cast<const float4*>(&S.g[w * RPW + a][4 * lane]);
        #pragma unroll
        for (int b = 0; b < QB; ++b) {
            if (b < n) {                          // uniform in the block
                const float4 qv =
                    *reinterpret_cast<const float4*>(&S.q[b][4 * lane]);
                #pragma unroll
                for (int a = 0; a < RPW; ++a) {
                    float& x = acc[a * QB + b];
                    x = fmaf(qv.x, gv[a].x, x);
                    x = fmaf(qv.y, gv[a].y, x);
                    x = fmaf(qv.z, gv[a].z, x);
                    x = fmaf(qv.w, gv[a].w, x);
                }
                if (t == 0) {
                    sq[b] = fmaf(qv.x, qv.x, sq[b]);
                    sq[b] = fmaf(qv.y, qv.y, sq[b]);
                    sq[b] = fmaf(qv.z, qv.z, sq[b]);
                    sq[b] = fmaf(qv.w, qv.w, sq[b]);
                }
            }
        }
        if (sl != nslices - 1) continue;
        if (t == 0) qn = pair_norms(sq, lane);
        // the tile's last slice: lane l holds row l / QB, pair l % QB
        const float v = transpose_sum(acc, lane);
        const int a = lane / QB, b = lane % QB;
        const int r = r0 + t * TR + w * RPW + a;
        const bool valid = b < n && r < r1;
        float d = CUDART_INF_F;
        if (valid) {
            d = __fsub_rn(__fadd_rn(qn, gn[seg_row0 + r]), __fmul_rn(2.f, v));
            d = fmaxf(d, 0.f);
        }
        if (kk == 0) {
            if (valid) dump[(long long)s_pair[b] * cap + r] = d;
            continue;
        }
        dist[b][w * RPW + a] = d;
        __syncthreads();
        if (w < n) {
            // warp w: pair w's candidates of the tile, lane = row
            const int rl = r0 + t * TR + lane;
            const float dd = dist[w][lane];
            const int pos = my_p * cap + rl;
            if (t == 0) {           // the list is empty: sort the tile in
                unsigned long long key[1] = {
                    rl < r1 ? select_key(dd, pos) : ~0ull};
                warp_fill<1>(ld, lp, kk, key, lane);
            } else {
                unsigned mask = __ballot_sync(
                    0xffffffffu, rl < r1 && lex_less(dd, pos, thr_d, thr_p));
                while (mask) {
                    const int src = __ffs(mask) - 1;
                    mask &= mask - 1;
                    const float cd = __shfl_sync(0xffffffffu, dd, src);
                    const int cp = __shfl_sync(0xffffffffu, pos, src);
                    warp_insert(ld, lp, kk, cd, cp, lane);
                }
            }
            thr_d = ld[kk - 1];
            thr_p = lp[kk - 1];
        }
    }
    if (kk == 0 || w >= n) return;
    const long long slot = ((long long)s_pair[w] * nchunk + c) * kk;
    for (int i = lane; i < kk; i += 32) {
        cand_d[slot + i] = ld[i];
        cand_p[slot + i] = lp[i];
    }
}

template <bool VEC4>
int launch_scan(const float* qp, const float* g, const float* gn,
                const int* plan, int plan_len, float* cand_d, int* cand_p,
                float* dump, long long nblocks, int nprobe, int cap, int k,
                int kk, int rows_per_chunk, int nchunk, cudaStream_t stream) {
    const size_t bytes = smem_bytes(kk);
    cudaError_t err = cudaFuncSetAttribute(
        ivf_scan<VEC4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ivf_scan<VEC4><<<(unsigned)nblocks, THREADS, bytes, stream>>>(
        qp, g, gn, plan, plan + plan_len, plan + 2 * plan_len,
        plan + 3 * plan_len, plan + 4 * plan_len, cand_d, cand_p, dump,
        nprobe, cap, k, kk, rows_per_chunk, nchunk);
    return (int)cudaGetLastError();
}

// the plan of pairs [pair0, pair0 + npairs) into plan: order, gfirst,
// gcount, gseg (plan_len each, >= npairs) and ngroups
int launch_plan(const int* probes, int pair0, int npairs, int n_clusters,
                int* plan, int plan_len, cudaStream_t stream) {
    const int n2 = pow2_at_least(npairs < 32 ? 32 : npairs);
    const size_t bytes = (size_t)n2 * sizeof(unsigned long long);
    cudaError_t err = cudaFuncSetAttribute(
        ivf_plan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    ivf_plan<<<1, PLAN_THREADS, bytes, stream>>>(
        probes, pair0, npairs, n2, n_clusters, plan, plan + plan_len,
        plan + 2 * plan_len, plan + 3 * plan_len, plan + 4 * plan_len);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ivf_scan_max_k() { return topk_list::MAX_K; }
int ivf_scan_tile_rows() { return TR; }
int ivf_scan_group_pairs() { return QB; }
int ivf_scan_plan_max() { return PLAN_MAX; }
long long ivf_scan_smem_bytes(int kk) { return (long long)smem_bytes(kk); }
int ivf_scan_max_groups(int npairs, int n_clusters) {
    return max_groups(npairs, n_clusters);
}

// The work plan alone (npairs <= PLAN_MAX pairs from probes[0]) into
// plan: order, gfirst, gcount, gseg (npairs each) and ngroups, as
// ivf_scan_launch makes it. Returns the first non-zero cudaError_t, else 0.
int ivf_scan_plan(const int* probes, int* plan, int npairs, int n_clusters,
                  void* stream_ptr) {
    if (npairs < 1 || npairs > PLAN_MAX || n_clusters < 1)
        return (int)cudaErrorInvalidValue;
    return launch_plan(probes, 0, npairs, n_clusters, plan, npairs,
                       static_cast<cudaStream_t>(stream_ptr));
}

// One call runs, for each PLAN_MAX pairs, ivf_plan and ivf_scan, then
// the merge (kk <= MAX_K; topk_list::launch_merge) or select_wide (kk >
// MAX_K), on `stream`. Scratch is the caller's: plan (4 * min(nq *
// nprobe, PLAN_MAX) + 1 ints), cand_d / cand_p (nq, nprobe * nchunk, kk)
// for lists, dump (nq, nprobe * cap) for the wide path. vec4 != 0 takes
// 16-byte copies (k % 4 == 0, g and qp 16-byte aligned). marks: null, or
// four cudaEvent_t recorded on the stream before the first plan, after
// it, after the last scan and after the merge (or select). Returns the
// first non-zero cudaError_t, else 0.
int ivf_scan_launch(const int* probes, const float* qp, const float* g,
                    const float* gn, const int* ids, int* plan,
                    float* cand_d, int* cand_p, float* dump, float* out_d,
                    int* out_i, int nq, int nprobe, int n_clusters, int cap,
                    int k, int kk, int rows_per_chunk, int nchunk, int vec4,
                    void* const* marks, void* stream_ptr) {
    const long long pairs = (long long)nq * nprobe;
    if (kk < 1 || (long long)kk > (long long)nprobe * cap || nq < 1 ||
        nprobe < 1 || cap < 1 || k < 1 || n_clusters < 1 || nchunk < 1 ||
        rows_per_chunk < 1 || pairs > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const bool wide = kk > topk_list::MAX_K;
    const int lists = wide ? 0 : kk;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int plan_len = (int)(pairs < PLAN_MAX ? pairs : PLAN_MAX);
    topk_list::mark(marks, 0, stream);
    for (long long pair0 = 0; pair0 < pairs; pair0 += PLAN_MAX) {
        const int np = (int)(pairs - pair0 < PLAN_MAX ? pairs - pair0 : PLAN_MAX);
        int err = launch_plan(probes, (int)pair0, np, n_clusters, plan,
                              plan_len, stream);
        if (err != 0) return err;
        if (pair0 == 0) topk_list::mark(marks, 1, stream);
        const long long nblocks =
            (long long)max_groups(np, n_clusters) * nchunk;
        err = vec4
            ? launch_scan<true>(qp, g, gn, plan, plan_len, cand_d, cand_p,
                                dump, nblocks, nprobe, cap, k, lists,
                                rows_per_chunk, nchunk, stream)
            : launch_scan<false>(qp, g, gn, plan, plan_len, cand_d, cand_p,
                                 dump, nblocks, nprobe, cap, k, lists,
                                 rows_per_chunk, nchunk, stream);
        if (err != 0) return err;
    }
    topk_list::mark(marks, 2, stream);
    int err;
    if (wide) {
        topk_list::select_wide<<<nq, topk_list::SELECT_THREADS, 0, stream>>>(
            dump, nprobe * cap, kk, probes, ids, nprobe, n_clusters, cap,
            out_d, out_i);
        err = (int)cudaGetLastError();
    } else {
        err = topk_list::launch_merge(cand_d, cand_p, probes, ids, out_d,
                                      out_i, nq, nprobe * nchunk, kk, nprobe,
                                      n_clusters, cap, stream);
    }
    topk_list::mark(marks, 3, stream);
    return err;
}

}  // extern "C"
