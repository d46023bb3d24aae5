// All-pairs squared distances in metric space for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel repro/kernels/pairwise_dist/kernel.py::
// pairwise_sqdist (Pallas) and computes the same function on projected
// points xp (N, k) and yp (M, k):
//
//   D[i, j] = max(||xp_i||^2 + ||yp_j||^2 - 2 xp_i . yp_j, 0)   (N, M)
//
// What bounds it. At the kNN-eval shapes (N = 2000 held-out rows,
// M = 8000 training rows, k = 1000) the work is 2 N M k = 32 GFLOP of f32
// FMA against ~104 MB moved (xp, yp 40 MB read, D 64 MB written). Plain
// f32 runs outside the tensor cores (67 TFLOP/s): 0.478 ms of compute
// against 0.031 ms of memory, so the kernel is bound by its FMA rate.
//
// What the design does about it. The TPU kernel walks (N tile, M tile,
// k tile) with the contraction innermost and sequential, carrying the
// cross term and both row norms in VMEM scratch. Here every block owns one
// 64 x 128 output tile and loops over k itself: 32-wide slices of xp and
// yp are double-buffered in shared memory with cp.async, the cross term
// accumulates as f32 FFMA in registers (a thread owns 8 x-rows x 4
// y-rows), and the row norms accumulate over the same slices from shared
// memory (4 threads per x-row, 2 per y-row, combined by shuffles in a
// fixed order) into shared-memory sums that the epilogue reads. N x M
// tiles give thousands of blocks at the eval shapes, so no split-K.
//
// Ragged edges (any N, M, k) are masked in the kernel: no padding. No
// TF32: every product is an f32 FFMA. wgmma / 3xTF32 and TMA are later
// work. The tile helpers are copied from metric_topk.cu on purpose: the
// build hashes this file alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // yp rows of a tile
constexpr int BK = 32;          // contraction slice staged per step
constexpr int THREADS = 256;    // 8 warps: warp w owns x-rows TQ*w..
constexpr int TQ = 8;           // x-rows per thread
constexpr int BQ = 8 * TQ;      // x-rows of a tile (64)
constexpr int TM = 4;           // y-rows per thread (lane, lane+32, ...)
constexpr int QPAD = BK + 4;    // 16-byte aligned rows, float4 reads
constexpr int MPAD = BM + 1;    // conflict-free transposed stores

struct Tiles {
    float a[BQ][QPAD];          // xp slice, k contiguous
    float b[BK][MPAD];          // yp slice, transposed
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
        Tiles& t, const float* __restrict__ xp, int a0, int n,
        const float* __restrict__ yp, int b0, int m, long long k, int kb) {
    const int tid = threadIdx.x;
    #pragma unroll
    for (int r = 0; r < BQ * BK / THREADS; ++r) {
        int idx = tid + r * THREADS, row = idx / BK, c = idx % BK;
        int gr = a0 + row, gk = kb + c;
        bool ok = gr < n && gk < k;
        cp_async4(&t.a[row][c], xp + (ok ? gr * k + gk : 0), ok);
    }
    #pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
        int idx = tid + r * THREADS, row = idx / BK, c = idx % BK;
        int gr = b0 + row, gk = kb + c;
        bool ok = gr < m && gk < k;
        cp_async4(&t.b[c][row], yp + (ok ? gr * k + gk : 0), ok);
    }
    cp_async_commit();
}

// D[a0 + ty*TQ + i, b0 + lane + 32 j] for one 64 x 128 tile
__global__ void __launch_bounds__(THREADS)
pairwise_tile(const float* __restrict__ xp, const float* __restrict__ yp,
              float* __restrict__ out, int n, int m, int k) {
    extern __shared__ __align__(16) unsigned char smem[];
    Tiles* t = reinterpret_cast<Tiles*>(smem);
    __shared__ float xn_s[BQ], yn_s[BM];
    const int tid = threadIdx.x, lane = tid & 31, ty = tid >> 5;
    const int a0 = blockIdx.x * BQ, b0 = blockIdx.y * BM;
    if (tid < BQ) xn_s[tid] = 0.f;
    if (tid < BM) yn_s[tid] = 0.f;

    float acc[TQ][TM] = {};
    const int nsteps = (k + BK - 1) / BK;
    load_slice(t[0], xp, a0, n, yp, b0, m, k, 0);
    for (int st = 0; st < nsteps; ++st) {
        if (st + 1 < nsteps) {
            load_slice(t[(st + 1) & 1], xp, a0, n, yp, b0, m, k,
                       (st + 1) * BK);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const Tiles& c_t = t[st & 1];
        {   // row norms over this slice: 4 threads per x-row (8 columns
            // each), 2 per y-row (16 each); the lowest thread adds the sum
            const int r = tid >> 2, q = tid & 3;
            float4 u = *reinterpret_cast<const float4*>(&c_t.a[r][8 * q]);
            float4 v = *reinterpret_cast<const float4*>(&c_t.a[r][8 * q + 4]);
            float s = u.x * u.x;
            s = fmaf(u.y, u.y, s); s = fmaf(u.z, u.z, s); s = fmaf(u.w, u.w, s);
            s = fmaf(v.x, v.x, s); s = fmaf(v.y, v.y, s);
            s = fmaf(v.z, v.z, s); s = fmaf(v.w, v.w, s);
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (q == 0) xn_s[r] += s;
            const int rb = tid >> 1, h = tid & 1;
            float sb = 0.f;
            #pragma unroll
            for (int c = 0; c < BK / 2; ++c) {
                float w = c_t.b[h * (BK / 2) + c][rb];
                sb = fmaf(w, w, sb);
            }
            sb += __shfl_xor_sync(0xffffffffu, sb, 1);
            if (h == 0) yn_s[rb] += sb;
        }
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
        __syncthreads();        // the next load overwrites this buffer
    }

    float yn_r[TM];
    #pragma unroll
    for (int j = 0; j < TM; ++j) yn_r[j] = yn_s[lane + 32 * j];
    #pragma unroll
    for (int i = 0; i < TQ; ++i) {
        const int row = a0 + ty * TQ + i;
        if (row >= n) continue;
        const float xn = xn_s[ty * TQ + i];
        #pragma unroll
        for (int j = 0; j < TM; ++j) {
            const int col = b0 + lane + 32 * j;
            // (xn + yn) - 2 * cross, rounded as the plain version
            float dv = __fsub_rn(__fadd_rn(xn, yn_r[j]),
                                 __fmul_rn(2.f, acc[i][j]));
            if (col < m) out[(long long)row * m + col] = fmaxf(dv, 0.f);
        }
    }
}

}  // namespace

extern "C" {

int pairwise_dist_block_n() { return BQ; }
int pairwise_dist_block_m() { return BM; }
int pairwise_dist_block_k() { return BK; }

// D (n, m) = pairwise squared distances of xp (n, k) and yp (m, k), on
// `stream`. Returns the first non-zero cudaError_t, else 0.
int pairwise_dist_launch(const float* xp, const float* yp, float* out,
                         int n, int m, int k, void* stream_ptr) {
    if (n < 1 || m < 1 || k < 1 || (m + BM - 1) / BM > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const size_t tile_bytes = 2 * sizeof(Tiles);
    cudaError_t err = cudaFuncSetAttribute(
        pairwise_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tile_bytes);
    if (err != cudaSuccess) return (int)err;
    pairwise_tile<<<dim3((n + BQ - 1) / BQ, (m + BM - 1) / BM), THREADS,
                    tile_bytes, stream>>>(xp, yp, out, n, m, k);
    return (int)cudaGetLastError();
}

}  // extern "C"
