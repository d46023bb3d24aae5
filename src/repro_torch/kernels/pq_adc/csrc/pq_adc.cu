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
// are read only for the kk winners) and costs S table lookups and adds.
// At the serving shapes (S = 100, K = 256, cap = 1224, nprobe = 16) the
// bytes are few (the distinct probed segments' codes, 54 MB at Nq 64);
// the lookups are gathers from shared memory, 4 bytes each at 128 bytes
// a clock an SM at best (32 lanes on distinct banks), and random codes
// put ~3.5 lanes of a warp on one bank. So at large batches the lookups
// bound it, at small ones the table's staging, the launches and the merge.
//
// What the design does about it. The TPU kernel streams one query's
// probe/tile stream through a sequential grid axis, with the table
// lookups done as S one-hot matmuls on the MXU. Hopper blocks run in
// parallel in no order and have no use for the one-hot trick: a table in
// shared memory is a gather. So:
//
//   1. pq_adc: one block per (query, unit of pieces). A piece is one
//      probe's chunk of 256 segment rows (PIECE: one a thread); a query's
//      nprobe * ceil(cap / 256) pieces are dealt out in units of `ppb`
//      (the wrapper's plan: enough blocks for 4 waves of one block an SM).
//      The query's table (S * K f32: 102,400 bytes at S = 100, K = 256)
//      is staged once per block by one bulk copy (cp.async.bulk, completing
//      on an mbarrier), which overlaps the first code tile; so it is
//      copied Nq * units times, not once per (query, probe). A tile is two
//      pieces, double-buffered with 16-byte cp.async copies of each piece's
//      contiguous byte range (a row is S bytes, not 16-byte aligned: the
//      copy starts at the aligned address below the piece and the
//      zero-filled tail stops at the array's end). Each thread scores its
//      row of both pieces as two independent sequential chains, reading
//      its codes as 4-byte words when S is a multiple of 4, adding
//      LUT[s * K + code_s] for s = 0 .. S-1 in order, exactly as the plain
//      version's sequential sum; 2 ip is exact and the intrinsics below
//      keep every operation rounded on its own, so the distance is
//      bit-identical. Each warp keeps a sorted (d, position) list in
//      shared memory. After the first tile it holds the first kk of the
//      warp's 64 candidates, sorted at once (topk_list::warp_fill);
//      after that a candidate is inserted (by the whole warp, one at a
//      time) only if it beats the block's threshold: the least of the
//      warps' kk-th entries and the greatest of their m-th, m =
//      ceil(kk / 8), as published after the last tile. Either leaves at
//      least kk of the block's candidates below it, so no candidate at or
//      past it can be among the block's kk best, and the second tracks
//      the block's kk-th best closely when the warps' candidates are
//      alike. The block merges the 8 warp lists into its list in three
//      pairwise levels (topk_list::block_merge_runs);
//   2. merge_tree (topk_list.cuh): one block per query merges its
//      blocks' lists by (d, position) in shared memory and maps positions
//      to row ids.
//
// Ties: ordering by position at equal distance selects the same kk
// candidates as the reference's stable top-kk over the probe-major /
// slot-minor stream, so ids are bit-identical too after the final sort.
//
// Tables larger than shared memory. When the table and two tiles of
// whole rows do not fit a block's 227 KB, the tiles go single-buffered;
// when that does not fit either (about S = 146 at K = 256, kk 50), the
// block walks each tile in chunks of sc subspaces (sc from the wrapper's
// plan, the most that fit): the chunk's sc x K table slice and the
// tile's sc code bytes of each row are staged in shared memory, and each
// thread carries its rows' partial sums in registers from chunk to chunk,
// adding in ascending subspace order, so the sum is the same sequential
// one and the result stays bit-identical. The table is then read again
// for every tile (from L2).
//
// Wide lists (kk > topk_list::MAX_K): the block writes every candidate's
// distance to dump[q, position] instead of keeping lists, and
// topk_list::select_wide picks the kk smallest (d, position) per query.
//
// `stamps`, when given, receives five %globaltimer stamps a block from
// thread 0 (start, table and first tile landed, tiles done, end; and the
// time its warp spent inserting), for chip_smoke.py's split of the time.
// They stay in the shipped kernel because the split has to be read again
// in every card run, on the kernel as built: the insert share moves with
// the data (how many candidates pass the threshold) and with every change
// to the scoring loop, and PERF.md quotes the split only from chip_smoke's
// own output. Serving passes null; the cost then is thread 0's test of a
// uniform pointer at four points of a block (no extra barrier, no store).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "../../csrc/topk_list.cuh"

namespace {

using namespace topk_list;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PIECE = THREADS;          // rows of a piece: one a thread
constexpr int R = 2;                    // pieces a tile: rows a thread

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline size_t piece_bytes(int S) {
    return round16((size_t)PIECE * S + 16);         // + room for the misalignment
}

__host__ __device__ inline size_t lut_bytes(int S, int K) {
    return round16((size_t)S * K * sizeof(float));  // tiles 16-aligned
}

// the block's table (or table chunk), code tiles and lists: nstage tiles
// of R whole-row pieces when sc == S, else one tile of sc code bytes a row
__host__ __device__ inline size_t smem_bytes(int S, int K, int kk, int sc,
                                             int nstage) {
    const size_t lists =        // the warps' lists and room to merge them
        (size_t)(WARPS + WARPS / 2) * kk * (sizeof(float) + sizeof(int));
    if (sc >= S) return lut_bytes(S, K) + (size_t)nstage * R * piece_bytes(S) + lists;
    return lut_bytes(sc, K) + R * round16((size_t)PIECE * sc) + lists;
}

__device__ __forceinline__ long long clock_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// piece j of query q: probe p's rows [r0, r0 + nrows) of its segment
struct Piece {
    int p, nrows;
    long long row0;                     // first row in the codes array
    float dcv;
};

__device__ __forceinline__ Piece piece_of(const int* __restrict__ probes,
                                          const float* __restrict__ dc,
                                          int q, int j, int jend, int nprobe,
                                          int nchunk, int n_clusters,
                                          int cap) {
    Piece pc{0, 0, 0, 0.f};
    if (j >= jend) return pc;
    pc.p = j / nchunk;
    const int r0 = (j % nchunk) * PIECE;
    const long long pair = (long long)q * nprobe + pc.p;
    const int seg = min(max(probes[pair], 0), n_clusters - 1);
    pc.nrows = min(PIECE, cap - r0);
    pc.row0 = (long long)seg * cap + r0;
    pc.dcv = dc[pair];
    return pc;
}

// The code bytes of rows [row0, row0 + nrows) into `tile`, from the
// 16-byte aligned address at or below their start: the first row's
// first byte lands at offset (row0 * S) % 16. Bytes past
// `total` (the end of the codes array) are not read. Not committed.
__device__ __forceinline__ void load_codes(unsigned char* tile,
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
}

// ip[r] = the sequential ADC sum of the S codes at row[r], r < NR
template <bool WORDS, int NR>
__device__ __forceinline__ void score(const float* lut,
                                      const unsigned char* const (&row)[R],
                                      int S, int K, float (&ip)[R]) {
    if (WORDS) {                        // S % 4 == 0: rows 4-byte aligned
        uint32_t wv[NR];
        #pragma unroll
        for (int r = 0; r < NR; ++r) {
            wv[r] = *reinterpret_cast<const uint32_t*>(row[r]);
            ip[r] = lut[wv[r] & 255u];
            #pragma unroll
            for (int j = 1; j < 4; ++j)
                ip[r] = __fadd_rn(ip[r], lut[j * K + ((wv[r] >> (8 * j)) & 255u)]);
        }
        #pragma unroll 2
        for (int s = 4; s < S; s += 4) {
            const float* L = lut + s * K;
            #pragma unroll
            for (int r = 0; r < NR; ++r)
                wv[r] = *reinterpret_cast<const uint32_t*>(row[r] + s);
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                #pragma unroll
                for (int r = 0; r < NR; ++r)
                    ip[r] = __fadd_rn(ip[r],
                                      L[j * K + ((wv[r] >> (8 * j)) & 255u)]);
            }
        }
    } else {
        #pragma unroll
        for (int r = 0; r < NR; ++r) ip[r] = lut[row[r][0]];
        for (int s = 1; s < S; ++s) {
            #pragma unroll
            for (int r = 0; r < NR; ++r)
                ip[r] = __fadd_rn(ip[r], lut[s * K + row[r][s]]);
        }
    }
}

// kk > 0: sorted per-warp lists of kk (d, position), merged into the
// block's list; kk == 0: every distance to dump[q, position] (the wide
// path). CHUNKED: the table in chunks of sc subspaces (above); WORDS:
// codes read 4 at a time (S % 4 == 0, whole table).
template <bool CHUNKED, bool WORDS>
__global__ void __launch_bounds__(THREADS)
pq_adc(const int* __restrict__ probes, const float* __restrict__ tables,
       const float* __restrict__ dc, const uint8_t* __restrict__ codes,
       const float* __restrict__ t, float* __restrict__ cand_d,
       int* __restrict__ cand_p, float* __restrict__ dump, int nprobe,
       int n_clusters, int cap, int S, int K, int kk, int sc, int nstage,
       int nchunk, int ppb, int nunits, int bulk,
       long long* __restrict__ stamps) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ __align__(8) uint64_t table_bar;
    // each warp's kk-th and m-th list entries, by tile parity
    __shared__ float pub_d[2][WARPS], pub_md[2][WARPS];
    __shared__ int pub_p[2][WARPS], pub_mp[2][WARPS];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const long long blk = blockIdx.x;
    long long t_ins = 0;
    if (stamps && tid == 0) stamps[blk * 5] = clock_ns();

    float* lut = reinterpret_cast<float*>(smem);
    unsigned char* tiles = smem + lut_bytes(CHUNKED ? sc : S, K);
    const size_t pb = CHUNKED ? round16((size_t)PIECE * sc) : piece_bytes(S);
    float* list_d = reinterpret_cast<float*>(
        tiles + (CHUNKED ? 1 : nstage) * R * pb);
    int* list_p = reinterpret_cast<int*>(list_d + WARPS * kk);
    float* blk_d = reinterpret_cast<float*>(list_p + WARPS * kk);
    int* blk_p = reinterpret_cast<int*>(blk_d + WARPS / 2 * kk);

    const int q = (int)(blk / nunits), u = (int)(blk % nunits);
    const int j0 = u * ppb, jend = min(nprobe * nchunk, j0 + ppb);
    const int ntiles = (jend - j0 + R - 1) / R;
    const long long total = (long long)n_clusters * cap * S;
    const float* tab = tables + (long long)q * S * K;

    // the table: one bulk copy, overlapping the first code tile
    if (!CHUNKED) {
        if (bulk) {
            if (tid == 0) {
                mbar_init1(&table_bar);
                bulk_copy(lut, tab, (uint32_t)(S * K * sizeof(float)),
                          &table_bar);
            }
        } else {
            for (int i = tid; i < S * K; i += THREADS) lut[i] = tab[i];
        }
    }
    auto load_tile = [&](int ti, int buf) {
        #pragma unroll
        for (int r = 0; r < R; ++r) {
            const Piece pc = piece_of(probes, dc, q, j0 + R * ti + r, jend,
                                      nprobe, nchunk, n_clusters, cap);
            if (pc.nrows > 0)
                load_codes(tiles + (buf * R + r) * pb, codes, total, pc.row0,
                           pc.nrows, S);
        }
        cp_async_commit();
    };
    if (!CHUNKED && ntiles > 0) load_tile(0, 0);
    for (int i = tid; i < WARPS * kk; i += THREADS) {
        list_d[i] = CUDART_INF_F;
        list_p[i] = NO_POS;
    }
    if (tid < 2 * WARPS) {
        pub_d[tid / WARPS][tid % WARPS] = CUDART_INF_F;
        pub_p[tid / WARPS][tid % WARPS] = NO_POS;
        pub_md[tid / WARPS][tid % WARPS] = CUDART_INF_F;
        pub_mp[tid / WARPS][tid % WARPS] = NO_POS;
    }
    float* ld = list_d + w * kk;
    int* lp = list_p + w * kk;
    float thr_d = CUDART_INF_F;
    int thr_p = NO_POS;

    for (int ti = 0; ti < ntiles; ++ti) {
        Piece pc[R];
        float tv[R];
        #pragma unroll
        for (int r = 0; r < R; ++r) {
            pc[r] = piece_of(probes, dc, q, j0 + R * ti + r, jend, nprobe,
                             nchunk, n_clusters, cap);
            tv[r] = tid < pc[r].nrows ? t[pc[r].row0 + tid] : 0.f;
        }
        const bool two = pc[1].nrows > 0;       // uniform in the block
        float ip[R] = {0.f, 0.f};
        if (CHUNKED) {
            for (int s0 = 0; s0 < S; s0 += sc) {
                const int wd = min(sc, S - s0);
                __syncthreads();    // the last chunk's reads are done
                for (int i = tid; i < wd * K; i += THREADS)
                    lut[i] = tab[(long long)s0 * K + i];
                #pragma unroll
                for (int r = 0; r < R; ++r)
                    for (int i = tid; i < pc[r].nrows * wd; i += THREADS)
                        tiles[r * pb + i] =
                            codes[(pc[r].row0 + i / wd) * S + s0 + i % wd];
                __syncthreads();
                if (stamps && tid == 0 && ti == 0 && s0 == 0)
                    stamps[blk * 5 + 1] = clock_ns();
                // the partial sums carry over in ascending subspace order
                #pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (r == 1 && !two) break;
                    const unsigned char* cr = tiles + r * pb + tid * wd;
                    int j = 0;
                    if (s0 == 0) ip[r] = lut[cr[j++]];
                    for (; j < wd; ++j) ip[r] = __fadd_rn(ip[r], lut[j * K + cr[j]]);
                }
            }
        } else {
            const int buf = nstage == 2 ? (ti & 1) : 0;
            if (nstage == 2 && ti + 1 < ntiles) {
                load_tile(ti + 1, buf ^ 1);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();        // the tile (and the lists' init)
            if (ti == 0) {
                if (bulk) mbar_wait(&table_bar, 0);
                if (stamps && tid == 0) stamps[blk * 5 + 1] = clock_ns();
            }
            const unsigned char* row[R];
            #pragma unroll
            for (int r = 0; r < R; ++r)
                row[r] = tiles + (buf * R + r) * pb +
                         ((pc[r].row0 * S) & 15) + tid * S;
            if (two) score<WORDS, 2>(lut, row, S, K, ip);
            else score<WORDS, 1>(lut, row, S, K, ip);
        }
        long long t_a = 0;
        if (stamps && tid == 0) t_a = clock_ns();
        float d[R];
        int pos[R];
        bool valid[R];
        #pragma unroll
        for (int r = 0; r < R; ++r) {
            valid[r] = (r == 0 || two) && tid < pc[r].nrows;
            pos[r] = pc[r].p * cap + (int)(pc[r].row0 % cap) + tid;
            d[r] = CUDART_INF_F;
            if (valid[r]) {
                d[r] = __fsub_rn(__fadd_rn(pc[r].dcv, tv[r]),
                                 __fmul_rn(2.f, ip[r]));
                d[r] = fmaxf(d[r], 0.f);
            }
        }
        if (kk == 0) {
            #pragma unroll
            for (int r = 0; r < R; ++r)
                if (valid[r]) dump[(long long)q * nprobe * cap + pos[r]] = d[r];
        } else if (ti == 0) {
            // the lists are empty: the warp sorts its 2 x 32 candidates
            // and keeps the first kk
            unsigned long long key[R];
            #pragma unroll
            for (int r = 0; r < R; ++r)
                key[r] = valid[r] ? select_key(d[r], pos[r]) : ~0ull;
            warp_fill<R>(ld, lp, kk, key, lane);
            thr_d = ld[kk - 1];
            thr_p = lp[kk - 1];
        } else {
            // the block's threshold (module note): the least of the
            // warps' kk-th entries and the greatest of their m-th, m =
            // ceil(kk / WARPS), as published after the last tile
            float bd = thr_d, md = -1.f;
            int bp = thr_p, mp = -1;
            #pragma unroll
            for (int v = 0; v < WARPS; ++v) {
                const float od = pub_d[(ti + 1) & 1][v];
                const int op = pub_p[(ti + 1) & 1][v];
                if (lex_less(od, op, bd, bp)) { bd = od; bp = op; }
                const float xd = pub_md[(ti + 1) & 1][v];
                const int xp = pub_mp[(ti + 1) & 1][v];
                if (lex_less(md, mp, xd, xp)) { md = xd; mp = xp; }
            }
            if (lex_less(md, mp, bd, bp)) { bd = md; bp = mp; }
            #pragma unroll
            for (int r = 0; r < R; ++r) {
                unsigned mask = __ballot_sync(
                    0xffffffffu, valid[r] && lex_less(d[r], pos[r], bd, bp));
                while (mask) {
                    const int src = __ffs(mask) - 1;
                    mask &= mask - 1;
                    const float cd = __shfl_sync(0xffffffffu, d[r], src);
                    const int cp = __shfl_sync(0xffffffffu, pos[r], src);
                    if (lex_less(cd, cp, bd, bp)) {
                        warp_insert(ld, lp, kk, cd, cp, lane);
                        thr_d = ld[kk - 1];
                        thr_p = lp[kk - 1];
                        if (lex_less(thr_d, thr_p, bd, bp)) {
                            bd = thr_d;
                            bp = thr_p;
                        }
                    }
                }
            }
        }
        if (kk > 0 && lane == 0) {
            const int m = (kk + WARPS - 1) / WARPS;
            pub_d[ti & 1][w] = thr_d;
            pub_p[ti & 1][w] = thr_p;
            pub_md[ti & 1][w] = ld[m - 1];
            pub_mp[ti & 1][w] = lp[m - 1];
        }
        if (stamps && tid == 0) t_ins += clock_ns() - t_a;
        if (!CHUNKED) {
            __syncthreads();        // the load after next overwrites this tile
            if (nstage == 1 && ti + 1 < ntiles) load_tile(ti + 1, 0);
        }
    }
    if (stamps && tid == 0) {
        stamps[blk * 5 + 2] = clock_ns();
        stamps[blk * 5 + 4] = t_ins;
    }
    if (kk > 0) {
        __syncthreads();
        const int cur = block_merge_runs(list_d, list_p, blk_d, blk_p, WARPS, kk);
        const float* rd = cur ? blk_d : list_d;
        const int* rp = cur ? blk_p : list_p;
        for (int i = tid; i < kk; i += THREADS) {
            cand_d[blk * kk + i] = rd[i];
            cand_p[blk * kk + i] = rp[i];
        }
    }
    if (stamps && tid == 0) stamps[blk * 5 + 3] = clock_ns();
}

template <bool CHUNKED, bool WORDS>
int launch_scan(const int* probes, const float* tables, const float* dc,
                const uint8_t* codes, const float* t, float* cand_d,
                int* cand_p, float* dump, long long nblocks, int nprobe,
                int n_clusters, int cap, int S, int K, int kk, int sc,
                int nstage, int nchunk, int ppb, int nunits, int bulk,
                long long* stamps, cudaStream_t stream) {
    const size_t bytes = smem_bytes(S, K, kk, sc, nstage);
    cudaError_t err = cudaFuncSetAttribute(
        pq_adc<CHUNKED, WORDS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    pq_adc<CHUNKED, WORDS><<<(unsigned)nblocks, THREADS, bytes, stream>>>(
        probes, tables, dc, codes, t, cand_d, cand_p, dump, nprobe,
        n_clusters, cap, S, K, kk, sc, nstage, nchunk, ppb, nunits, bulk,
        stamps);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pq_adc_max_k() { return topk_list::MAX_K; }
int pq_adc_piece_rows() { return PIECE; }
long long pq_adc_smem_bytes(int S, int K, int kk, int sc, int nstage) {
    return (long long)smem_bytes(S, K, kk, sc, nstage);
}

// One call runs pq_adc and the merge (kk <= MAX_K;
// topk_list::launch_merge), or pq_adc and select_wide (kk > MAX_K), on
// `stream`: the table whole with nstage (1
// or 2) code tiles when sc == S, else in chunks of sc subspaces; a block
// per query and ppb pieces of 256 rows. Scratch is the caller's:
// cand_d / cand_p (nq, ceil(nprobe * ceil(cap / 256) / ppb), kk) for
// lists, dump (nq, nprobe * cap) for the wide path. codes and tables
// must be 16-byte aligned. stamps: null, or 5 per block (above); marks:
// null, or three cudaEvent_t recorded on the stream before the scan,
// after it and after the merge (or select). Returns the first non-zero
// cudaError_t, else 0.
int pq_adc_launch(const int* probes, const float* tables, const float* dc,
                  const uint8_t* codes, const float* t, const int* ids,
                  float* cand_d, int* cand_p, float* dump, float* out_d,
                  int* out_i, int nq, int nprobe, int n_clusters, int cap,
                  int S, int K, int kk, int sc, int nstage, int ppb,
                  long long* stamps, void* const* marks, void* stream_ptr) {
    if (kk < 1 || (long long)kk > (long long)nprobe * cap || nq < 1 ||
        nprobe < 1 || cap < 1 || S < 1 || K < 1 || K > 256 || sc < 1 ||
        sc > S || n_clusters < 1 || ppb < 1 || nstage < 1 || nstage > 2)
        return (int)cudaErrorInvalidValue;
    const bool wide = kk > topk_list::MAX_K;
    const int lists = wide ? 0 : kk;
    if (smem_bytes(S, K, lists, sc, nstage) > 232448 - 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int nchunk = (cap + PIECE - 1) / PIECE;
    const int nunits = (nprobe * nchunk + ppb - 1) / ppb;
    const long long nblocks = (long long)nq * nunits;
    const int bulk = (S * K) % 4 == 0;
    topk_list::mark(marks, 0, stream);
    int err;
    if (sc < S)
        err = launch_scan<true, false>(
            probes, tables, dc, codes, t, cand_d, cand_p, dump, nblocks,
            nprobe, n_clusters, cap, S, K, lists, sc, 1, nchunk, ppb, nunits,
            bulk, stamps, stream);
    else if (S % 4 == 0)
        err = launch_scan<false, true>(
            probes, tables, dc, codes, t, cand_d, cand_p, dump, nblocks,
            nprobe, n_clusters, cap, S, K, lists, sc, nstage, nchunk, ppb,
            nunits, bulk, stamps, stream);
    else
        err = launch_scan<false, false>(
            probes, tables, dc, codes, t, cand_d, cand_p, dump, nblocks,
            nprobe, n_clusters, cap, S, K, lists, sc, nstage, nchunk, ppb,
            nunits, bulk, stamps, stream);
    if (err != 0) return err;
    topk_list::mark(marks, 1, stream);
    if (wide) {
        topk_list::select_wide<<<nq, topk_list::SELECT_THREADS, 0, stream>>>(
            dump, nprobe * cap, kk, probes, ids, nprobe, n_clusters, cap,
            out_d, out_i);
        err = (int)cudaGetLastError();
    } else {
        err = topk_list::launch_merge(cand_d, cand_p, probes, ids, out_d,
                                      out_i, nq, nunits, kk, nprobe,
                                      n_clusters, cap, stream);
    }
    topk_list::mark(marks, 2, stream);
    return err;
}

}  // extern "C"
