// Fused DML pair loss (paper Eq. 4 forward) for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel repro/kernels/dml_pair/kernel.py::
// dml_pair_fused (Pallas) and computes the same function:
//
//   z       = xs - ys                         (B, d), never stored
//   proj    = z L^T                           (B, k)
//   d2[b]   = sum_c proj[b, c]^2
//   loss[b] = sim_b d2_b + (1 - sim_b) lam max(0, margin - d2_b)
//
// What bounds it. At the training shapes (B = 1000 pairs, d = 21504,
// k = 1000) the work is 2 B d k = 43.0 GFLOP of f32 FMA against ~262 MB
// read once (xs, ys 172 MB + L 86 MB). Plain f32 runs outside the tensor
// cores (67 TFLOP/s): 0.642 ms of compute against 0.078 ms of memory, so
// the kernel is bound by its FMA rate.
//
// What the design does about it. The TPU kernel walks (pair tile, k tile,
// d tile) as a sequential grid, carrying the projection in VMEM scratch
// across d steps and d2 across k tiles. Hopper blocks run in parallel in
// no order, and at B = k = 1000 there are only 16 x 8 = 128 output tiles
// of 64 x 128 for 132 SMs, so:
//
//   1. pair_proj_partial: grid (pair tile x L-row tile x d slice), the d
//      contraction split so that ~4 blocks per SM are in flight. Each
//      block streams its d slice through shared memory in 32-wide steps,
//      xs, ys and L double-buffered with cp.async; once a step's slices
//      have landed the block forms z = xs - ys in place in shared memory
//      (one f32 subtraction, as the plain version rounds it) and runs the
//      64 x 128 tile as f32 FFMA in registers (a thread owns 8 pairs x 4
//      L rows). Partial sums go to scratch part[slice, b, c];
//   2. pair_reduce: one block per pair sums the slices in a fixed order
//      (no atomics, so a run is deterministic and worker copies under bsp
//      stay bit-identical), writes proj, reduces d2 in a fixed order and
//      applies the hinge epilogue.
//
// Ragged edges (B, k and d not multiples of the tiles) are masked in the
// kernel: no padding. No TF32, no bf16: every product is an f32 FFMA.
// wgmma / 3xTF32 and TMA are later work. The tile helpers are copied from
// metric_topk.cu on purpose: the build hashes this file alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // L rows (d_out) of a tile
constexpr int BK = 32;          // contraction (d) slice staged per step
constexpr int THREADS = 256;    // 8 warps: warp w owns pairs TQ*w..
constexpr int TQ = 8;           // pairs per thread
constexpr int BQ = 8 * TQ;      // pairs of a tile (64)
constexpr int TM = 4;           // L rows per thread (lane, lane+32, ...)
constexpr int QPAD = BK + 4;    // 16-byte aligned rows, float4 reads
constexpr int MPAD = BM + 1;    // conflict-free transposed stores

struct Tiles {
    float x[BQ][QPAD];          // xs slice; z = xs - ys after the subtract
    float y[BQ][QPAD];          // ys slice
    float l[BK][MPAD];          // L slice, transposed
};

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

__device__ __forceinline__ void load_slice(
        Tiles& t, const float* __restrict__ xs, const float* __restrict__ ys,
        int b0, int nb, const float* __restrict__ L, int c0, int nc,
        long long d, int kb, int k1) {
    const int tid = threadIdx.x;
    #pragma unroll
    for (int r = 0; r < BQ * BK / THREADS; ++r) {
        int idx = tid + r * THREADS, row = idx / BK, k = idx % BK;
        int gr = b0 + row, gk = kb + k;
        bool ok = gr < nb && gk < k1;
        long long off = ok ? gr * d + gk : 0;
        cp_async4(&t.x[row][k], xs + off, ok);
        cp_async4(&t.y[row][k], ys + off, ok);
    }
    #pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
        int idx = tid + r * THREADS, row = idx / BK, k = idx % BK;
        int gr = c0 + row, gk = kb + k;
        bool ok = gr < nc && gk < k1;
        cp_async4(&t.l[k][row], L + (ok ? gr * d + gk : 0), ok);
    }
    cp_async_commit();
}

// acc[i][j] += sum_k z[b0 + ty*TQ + i, k] * L[c0 + lane + 32 j, k] over
// k in [k0, k1), z = xs - ys; rows past nb / nc and k past k1 read as
// zero. Slices are double-buffered: slice s+1 streams in while slice s is
// multiplied. Summation is sequential in k for every output.
__device__ __forceinline__ void pair_dot(
        Tiles* t, const float* __restrict__ xs, const float* __restrict__ ys,
        int b0, int nb, const float* __restrict__ L, int c0, int nc,
        long long d, int k0, int k1, float (&acc)[TQ][TM]) {
    const int tid = threadIdx.x, lane = tid & 31, ty = tid >> 5;
    const int nsteps = (k1 - k0 + BK - 1) / BK;
    load_slice(t[0], xs, ys, b0, nb, L, c0, nc, d, k0, k1);
    for (int st = 0; st < nsteps; ++st) {
        if (st + 1 < nsteps) {
            load_slice(t[(st + 1) & 1], xs, ys, b0, nb, L, c0, nc, d,
                       k0 + (st + 1) * BK, k1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        Tiles& c_t = t[st & 1];
        #pragma unroll
        for (int r = 0; r < BQ * BK / THREADS; ++r) {   // z = xs - ys
            int idx = tid + r * THREADS, row = idx / BK, k = idx % BK;
            c_t.x[row][k] = c_t.x[row][k] - c_t.y[row][k];
        }
        __syncthreads();
        #pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
            float4 a[TQ];
            #pragma unroll
            for (int i = 0; i < TQ; ++i)
                a[i] = *reinterpret_cast<const float4*>(&c_t.x[ty * TQ + i][kk]);
            #pragma unroll
            for (int c = 0; c < 4; ++c) {
                float b[TM];
                #pragma unroll
                for (int j = 0; j < TM; ++j) b[j] = c_t.l[kk + c][lane + 32 * j];
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
        __syncthreads();        // the next load overwrites this buffer
    }
}

// part[s, b, c] = sum_{k in slice s} (xs[b, k] - ys[b, k]) * L[c, k]
__global__ void __launch_bounds__(THREADS)
pair_proj_partial(const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ L, float* __restrict__ part,
                  int nb, int d, int nc, int kchunk) {
    extern __shared__ __align__(16) unsigned char smem[];
    Tiles* t = reinterpret_cast<Tiles*>(smem);
    const int b0 = blockIdx.x * BQ, c0 = blockIdx.y * BM, s = blockIdx.z;
    const int k0 = s * kchunk, k1 = min(d, k0 + kchunk);
    float acc[TQ][TM] = {};
    pair_dot(t, xs, ys, b0, nb, L, c0, nc, d, k0, k1, acc);
    const int lane = threadIdx.x & 31, ty = threadIdx.x >> 5;
    float* out = part + (long long)s * nb * nc;
    #pragma unroll
    for (int i = 0; i < TQ; ++i) {
        int b = b0 + ty * TQ + i;
        if (b >= nb) continue;
        #pragma unroll
        for (int j = 0; j < TM; ++j) {
            int c = c0 + lane + 32 * j;
            if (c < nc) out[(long long)b * nc + c] = acc[i][j];
        }
    }
}

// proj[b, c] = sum_s part[s, b, c] (s ascending); d2[b] = sum_c proj^2;
// loss[b] = sim d2 + (1 - sim) lam max(0, margin - d2)
__global__ void __launch_bounds__(THREADS)
pair_reduce(const float* __restrict__ part, const float* __restrict__ sim,
            float* __restrict__ proj, float* __restrict__ d2,
            float* __restrict__ loss, int nb, int nc, int nsplit, float lam,
            float margin) {
    __shared__ float warp_sums[THREADS / 32];
    const int b = blockIdx.x;
    float sq = 0.f;
    for (int c = threadIdx.x; c < nc; c += THREADS) {
        float v = 0.f;
        for (int s = 0; s < nsplit; ++s)
            v += part[((long long)s * nb + b) * nc + c];
        proj[(long long)b * nc + c] = v;
        sq = fmaf(v, v, sq);
    }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sq;
    __syncthreads();
    if (threadIdx.x == 0) {
        float tot = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) tot += warp_sums[w];
        const float simf = sim[b];
        const float hinge = fmaxf(0.f, margin - tot);
        d2[b] = tot;
        // the plain version's order: sim*d2 + ((1 - sim)*lam)*hinge
        loss[b] = __fadd_rn(__fmul_rn(simf, tot),
                            __fmul_rn(__fmul_rn(1.f - simf, lam), hinge));
    }
}

}  // namespace

extern "C" {

int dml_pair_block_q() { return BQ; }
int dml_pair_block_m() { return BM; }
int dml_pair_block_k() { return BK; }

// One call runs both kernels on `stream`. Scratch is the caller's: part
// (ksplit, B, k) with ksplit * kchunk >= d > (ksplit - 1) * kchunk.
// Returns the first non-zero cudaError_t, else 0.
int dml_pair_launch(const float* L, const float* xs, const float* ys,
                    const float* sim, float* part, float* loss, float* d2,
                    float* proj, int nb, int d, int nc, int ksplit,
                    int kchunk, float lam, float margin, void* stream_ptr) {
    if (nb < 1 || d < 1 || nc < 1 || ksplit < 1 || kchunk < 1 ||
        kchunk % BK != 0 || (long long)ksplit * kchunk < d ||
        (long long)(ksplit - 1) * kchunk >= d)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const size_t tile_bytes = 2 * sizeof(Tiles);
    cudaError_t err = cudaFuncSetAttribute(
        pair_proj_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tile_bytes);
    if (err != cudaSuccess) return (int)err;
    pair_proj_partial<<<dim3((nb + BQ - 1) / BQ, (nc + BM - 1) / BM, ksplit),
                        THREADS, tile_bytes, stream>>>(
        xs, ys, L, part, nb, d, nc, kchunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    pair_reduce<<<nb, THREADS, 0, stream>>>(part, sim, proj, d2, loss, nb,
                                             nc, ksplit, lam, margin);
    return (int)cudaGetLastError();
}

}  // extern "C"
