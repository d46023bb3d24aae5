// All-pairs squared distances in metric space for Hopper (sm_90a),
// f32-accurate on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/pairwise_dist/kernel.py::
// pairwise_sqdist (Pallas) and computes the same function on projected
// points xp (N, k) and yp (M, k):
//
//   D[i, j] = max(||xp_i||^2 + ||yp_j||^2 - 2 xp_i . yp_j, 0)   (N, M)
//
// What bounds it. At the kNN-eval shapes (N = 2000 held-out rows,
// M = 8000 training rows, k = 1000) the cross term is 2 N M k = 32 GFLOP
// against ~104 MB moved (xp, yp 40 MB read, D 64 MB written). In 3xTF32
// (kernels/csrc/tf32x3_sm90.cuh) the tensor cores do it as 3 x 32 GFLOP
// at 495 TFLOP/s: 0.194 ms, against 0.031 ms of memory, so the bound is
// the 3xTF32 rate.
//
// What the design does about it. The TPU kernel walks (N tile, M tile,
// k tile) with the contraction innermost and sequential, carrying the
// cross term and both row norms in VMEM scratch. Here:
//
//   1. row_norms: one warp per row of xp, then of yp, sums x^2 in a fixed
//      order (lanes over strided columns, then a fixed shuffle tree), so
//      a run is deterministic;
//   2. tf32x3::partial_product<128, false, Distance>: the mainloop that
//      dml_pair and metric_topk share. A block owns one 128 x 128 output
//      tile: xp rows are the wgmma M side (two warpgroups of 64 rows,
//      each reading its fragments from the landed stage and splitting
//      them in registers), yp rows the N side (split in shared memory);
//      TMA streams 32-column slices of both through a ring of 4 stages
//      with the 128-byte swizzle, and each stage's 12 wgmmas are
//      promoted into an f32 sum. No split of k (ksplit = 1): at the eval
//      shape 16 x 63 = 1008 tiles fill the 132 SMs, every output is one
//      block's fixed-order sum, and repeat calls are bit-equal. The
//      Distance epilogue forms (xn + yn) - 2 cross, rounded as the plain
//      version, and max(., 0) on the accumulator fragment, so D is
//      written once. Tiles run along a 1-D grid axis (xp tile fastest),
//      so neither N nor M is held to the grid's y limit.
//
// Ragged N, M and k are zero rows and columns of the TMA boxes, masked at
// the store; the wrapper zero-pads k to a multiple of 4 (the tensor map's
// 16-byte row stride). No plain TF32: every product is 3xTF32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tf32x3_sm90.cuh"

namespace {

constexpr int BN = 128;             // yp rows of a tile (the wgmma N side)
constexpr int STAGES = 4;
constexpr int NORM_THREADS = 256;   // 8 rows a block, one a warp

// xn[r] = sum_c x[r, c]^2 over the k columns, in a fixed order
__global__ void __launch_bounds__(NORM_THREADS)
row_norms(const float* __restrict__ x, float* __restrict__ xn, int rows,
          int k, int ld) {
    const int r = blockIdx.x * (NORM_THREADS / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (r >= rows) return;
    const float* row = x + (long long)r * ld;
    float s = 0.f;
    for (int c = lane; c < k; c += 32) s = fmaf(row[c], row[c], s);
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) xn[r] = s;
}

// D[m, n] = max((xn[m] + yn[n]) - 2 cross, 0), rounded as the plain
// version rounds it
struct Distance {
    const float* xn;
    const float* yn;
    float* out;
    long long ld;
    __device__ __forceinline__ void operator()(int, int m, int n,
                                               float cross) const {
        const float d = __fsub_rn(__fadd_rn(xn[m], yn[n]),
                                  __fmul_rn(2.f, cross));
        out[(long long)m * ld + n] = fmaxf(d, 0.f);
    }
};

}  // namespace

extern "C" {

int pairwise_dist_block_m() { return tf32x3::BM; }
int pairwise_dist_block_n() { return BN; }
int pairwise_dist_block_k() { return tf32x3::BK; }
int pairwise_dist_stages() { return STAGES; }
int pairwise_dist_smem() { return tf32x3::partial_smem(BN, false, STAGES); }

// D (n, m) = pairwise squared distances of xp (n, kp) and yp (m, kp), whose
// first k columns hold the points (kp = k rounded up to a multiple of 4,
// the rest zero; 16-byte aligned bases), on `stream`. Scratch is the
// caller's: xn (n), yn (m). Returns the first non-zero cudaError_t, else 0.
int pairwise_dist_launch(const float* xp, const float* yp, float* xn,
                         float* yn, float* out, int n, int m, int k, int kp,
                         void* stream_ptr) {
    if (n < 1 || m < 1 || k < 1 || kp % 4 != 0 || kp < k || kp >= k + 4)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    constexpr int RPB = NORM_THREADS / 32;
    row_norms<<<(n + RPB - 1) / RPB, NORM_THREADS, 0, stream>>>(xp, xn, n, k,
                                                                kp);
    row_norms<<<(m + RPB - 1) / RPB, NORM_THREADS, 0, stream>>>(yp, yn, m, k,
                                                                kp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int kchunk = (kp + tf32x3::BK - 1) / tf32x3::BK * tf32x3::BK;
    return tf32x3::launch_partial_epi<BN, false>(
        xp, nullptr, yp, Distance{xn, yn, out, m}, n, m, kp, 1, kchunk,
        STAGES, stream);
}

}  // extern "C"
