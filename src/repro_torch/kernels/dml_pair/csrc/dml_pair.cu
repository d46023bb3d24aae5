// Fused DML pair loss (paper Eq. 4 forward) for Hopper (sm_90a),
// f32-accurate on the tensor cores.
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
// k = 1000) the product is 2 B d k = 43.0 GFLOP against ~262 MB read once
// (xs, ys 172 MB + L 86 MB). In 3xTF32 (kernels/csrc/tf32x3_sm90.cuh) the
// tensor cores do it as 3 x 43.0 GFLOP at 495 TFLOP/s: 0.261 ms, against
// 0.078 ms of memory, so the bound is the 3xTF32 rate.
//
// What the design does about it. The TPU kernel walks (pair tile, k tile,
// d tile) as a sequential grid, carrying the projection in VMEM across d
// steps. Here:
//
//   1. tf32x3::partial_product<128, DIFF>: a block is a 128-pair x
//      128-L-row tile of one d slice. TMA streams xs, ys and L slices of
//      32 columns through a ring of 4 stages (48 KB each); each consumer
//      warpgroup forms its 64 pairs' z = xs - ys in registers (one f32
//      subtraction, as the plain version rounds it) and splits it there,
//      L is split in shared memory, and the 3xTF32 wgmmas take z from
//      registers. At B = k = 1000 there are 64 tiles, so d is split
//      in two to fill 128 of the 132 SMs; the slices are the slowest grid
//      axis, so the 8 blocks that read one xs/ys row tile or one L row
//      tile run together and share it through L2 (HBM traffic ~262 MB,
//      not the 2.1 GB of every block reading its operands from memory).
//      Partial sums go to part[slice, b, c];
//   2. pair_reduce: one block per pair sums the slices in a fixed order
//      (no atomics, so a run is deterministic and worker copies under bsp
//      stay bit-identical), writes proj, reduces d2 in a fixed order and
//      applies the hinge epilogue.
//
// Ragged B and k are zero rows of the TMA boxes, masked at the store; the
// wrapper zero-pads d to a multiple of 4 (the tensor map's 16-byte row
// stride). No plain TF32 and no bf16: every product is 3xTF32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/tf32x3_sm90.cuh"

namespace {

constexpr int BN = 128;             // L rows of a tile (the wgmma N side)
constexpr int STAGES = 4;
constexpr int REDUCE_THREADS = 256;

// proj[b, c] = sum_s part[s, b, c] (s ascending); d2[b] = sum_c proj^2;
// loss[b] = sim d2 + (1 - sim) lam max(0, margin - d2)
__global__ void __launch_bounds__(REDUCE_THREADS)
pair_reduce(const float* __restrict__ part, const float* __restrict__ sim,
            float* __restrict__ proj, float* __restrict__ d2,
            float* __restrict__ loss, int nb, int nc, int nsplit, float lam,
            float margin) {
    __shared__ float warp_sums[REDUCE_THREADS / 32];
    const int b = blockIdx.x;
    float sq = 0.f;
    for (int c = threadIdx.x; c < nc; c += REDUCE_THREADS) {
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
        for (int w = 0; w < REDUCE_THREADS / 32; ++w) tot += warp_sums[w];
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

int dml_pair_block_m() { return tf32x3::BM; }
int dml_pair_block_n() { return BN; }
int dml_pair_block_k() { return tf32x3::BK; }
int dml_pair_stages() { return STAGES; }
int dml_pair_smem() { return tf32x3::partial_smem(BN, true, STAGES); }

// One call runs both kernels on `stream`. xs, ys (nb, d) and L (nc, d)
// are contiguous with d a multiple of 4 and 16-byte aligned bases.
// Scratch is the caller's: part (ksplit, nb, nc) with kchunk a multiple
// of 32 and ksplit * kchunk >= d > (ksplit - 1) * kchunk. Returns the
// first non-zero cudaError_t, else 0.
int dml_pair_launch(const float* L, const float* xs, const float* ys,
                    const float* sim, float* part, float* loss, float* d2,
                    float* proj, int nb, int d, int nc, int ksplit,
                    int kchunk, float lam, float margin, void* stream_ptr) {
    if (nb < 1 || d < 1 || nc < 1 || ksplit < 1 || kchunk < 1 ||
        d % 4 != 0 || kchunk % tf32x3::BK != 0 ||
        (long long)ksplit * kchunk < d ||
        (long long)(ksplit - 1) * kchunk >= d)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int err = tf32x3::launch_partial<BN, true>(
        xs, ys, L, part, nb, nc, d, ksplit, kchunk, STAGES,
        (long long)nb * nc, nc, 1, stream);
    if (err != 0) return err;
    pair_reduce<<<nb, REDUCE_THREADS, 0, stream>>>(part, sim, proj, d2, loss,
                                                   nb, nc, ksplit, lam,
                                                   margin);
    return (int)cudaGetLastError();
}

}  // extern "C"
