// Mamba2 SSD chunk scan for Hopper (sm_90a): f32 arithmetic on bf16 or f32
// inputs.
//
// Replaces the TPU kernel repro/kernels/ssd_chunk/kernel.py::_ssd_kernel
// (launched by ssd_scan, :80) and computes the same function for every
// pane (b, h), with p = head dim and n = state size:
//
//   h_t = exp(la_t) h_{t-1} + dt_t x_t B_t^T      (h: p x n, h_0 = 0)
//   y_t = h_t C_t
//
// returning y in x's dtype and the final h in f32. It evaluates the
// recurrence by chunks of Q = 64 steps, as the TPU kernel does with its
// chunk: with W the inclusive prefix sum of la over the chunk,
//
//   y   = (C h^T) exp(W) + (tril(C B^T o exp(W_t - W_s)) dt_s) x
//   h'  = exp(W_last) h + (x dt exp(W_last - W))^T B
//
// What bounds it. At the zamba2-2.7b embedding service's shapes (B 4,
// T 8192, 80 heads, p = n = 64, bf16) one layer's scan needs, at Q = 64,
// 2 ((Q + 1) / 2 p + 2 p n) = 20,544 FLOP per (token, head) (the lower
// triangle of att . x, C h^T and the state update) and 2 (Q + 1) / 2 n =
// 4,160 per token for the lower triangle of C B^T, which all heads of a
// batch row share: 54 GFLOP, 0.81 ms at the f32 FFMA rate (67 TFLOP/s).
// This kernel computes C B^T once per head, 80 times the needed work of
// that term. Against that, 0.37 GB moved (x read and y
// written: 168 MB each; B and C 4 MB each, read once; dt and la 10.5 MB
// each; h 5 MB): 0.11 ms. So the FMA rate bounds it.
//
// What the design does about it. The TPU kernel runs a (pane, chunk)
// grid with the chunk axis sequential and the (p, n) state in VMEM
// scratch. Blocks do not run in order here, so one block owns one pane
// and loops over its chunks, with the state in registers (each thread
// owns p/16 x n/16 entries) and a copy in shared memory for the y term.
// Every chunk's tiles (x, B, C, the Q x Q decay-weighted scores, the
// state) stay in shared memory: device memory sees the inputs once and
// the outputs once. Q = 64 rather than the TPU kernel's 128 halves the
// Q^2 work per token and keeps a block at 84 KB of shared memory (p <= 64),
// so two blocks share an SM (320 panes at the service's shapes). Every
// product is an f32 FFMA from 4 x 4 (or 4 x p/16) register tiles; no
// TF32. B and C are shared by a batch's heads (Mamba2's ngroups = 1): the
// caller passes a head stride of 0 and the kernel indexes them by batch,
// so no per-head copy exists. All inputs are read through strides, so the
// model's (B, T, H, p) layout needs no transpose. The scores above the
// diagonal are selected away, never multiplied by a mask: exp(W_t - W_s)
// overflows to inf there and inf * 0 would be NaN. A ragged last chunk
// and p, n below the tile are zero-filled in shared memory, which is
// exact: zero x, B, C, dt and la add nothing and decay nothing.
// Later work: one block for several heads of a batch sharing C B^T (the
// same for all 80 heads), tensor cores with 3xTF32, cp.async staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;               // chunk length
constexpr int THREADS = 256;        // thread (ty, tx) = (tid / 16, tid % 16)

struct Params {
    int H, T, p, n;
    long long x_b, x_h, x_t;        // element strides (last dim contiguous)
    long long b_b, b_h, b_t;
    long long c_b, c_h, c_t;
    long long dt_b, dt_h, dt_t;
    long long la_b, la_h, la_t;
    long long y_b, y_h, y_t;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
    *dst = __float2bfloat16_rn(x);
}

// P >= p, N >= n: the tile sizes the kernel is built for
template <int P, int N>
struct Smem {
    float xs[Q][P];
    float bm[Q][N + 1];             // odd row strides: rows read across a
    float cm[Q][N + 1];             // half-warp hit 16 banks
    float h[P][N + 1];
    float att[Q][Q + 1];
    float w[Q], ew[Q], src[Q], dt[Q];
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan(const T* __restrict__ xs, const T* __restrict__ bm,
               const T* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ la, T* __restrict__ y,
               float* __restrict__ hout, Params p) {
    constexpr int RP = P / 16;      // state rows of a thread (and y columns)
    constexpr int CN = N / 16;      // state columns of a thread
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<P, N>& s = *reinterpret_cast<Smem<P, N>*>(smem_raw);
    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int b = blockIdx.x / p.H, hh = blockIdx.x % p.H;
    const T* xg = xs + b * p.x_b + hh * p.x_h;
    const T* bg = bm + b * p.b_b + hh * p.b_h;
    const T* cg = cm + b * p.c_b + hh * p.c_h;
    const float* dtg = dt + b * p.dt_b + hh * p.dt_h;
    const float* lag = la + b * p.la_b + hh * p.la_h;
    T* yg = y + b * p.y_b + hh * p.y_h;

    float hreg[RP][CN];
    #pragma unroll
    for (int r = 0; r < RP; ++r)
        #pragma unroll
        for (int j = 0; j < CN; ++j) hreg[r][j] = 0.f;
    for (int i = tid; i < P * (N + 1); i += THREADS) (&s.h[0][0])[i] = 0.f;

    for (int c0 = 0; c0 < p.T; c0 += Q) {
        // stage the chunk; zeros past T and past p, n
        for (int i = tid; i < Q * P; i += THREADS) {
            const int t = i / P, col = i % P;
            s.xs[t][col] = c0 + t < p.T && col < p.p
                ? to_f32(xg[(long long)(c0 + t) * p.x_t + col]) : 0.f;
        }
        for (int i = tid; i < Q * N; i += THREADS) {
            const int t = i / N, col = i % N;
            const bool in = c0 + t < p.T && col < p.n;
            s.bm[t][col] = in ? to_f32(bg[(long long)(c0 + t) * p.b_t + col])
                              : 0.f;
            s.cm[t][col] = in ? to_f32(cg[(long long)(c0 + t) * p.c_t + col])
                              : 0.f;
        }
        if (tid < Q) {
            const bool in = c0 + tid < p.T;
            s.dt[tid] = in ? dtg[(long long)(c0 + tid) * p.dt_t] : 0.f;
            s.w[tid] = in ? lag[(long long)(c0 + tid) * p.la_t] : 0.f;
        }
        __syncthreads();

        // W = inclusive prefix sum of la (warp 0, two steps a lane), then
        // exp(W) and src = dt exp(W_last - W)
        if (tid < 32) {
            const float a0 = s.w[2 * tid], a1 = s.w[2 * tid + 1];
            float run = a0 + a1;
            #pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float up = __shfl_up_sync(0xffffffffu, run, off);
                if (tid >= off) run += up;
            }
            const float before = __shfl_up_sync(0xffffffffu, run, 1);
            const float w0 = (tid == 0 ? 0.f : before) + a0;
            const float w1 = w0 + a1;
            const float wl = __shfl_sync(0xffffffffu, w1, 31);
            s.w[2 * tid] = w0;
            s.w[2 * tid + 1] = w1;
            s.ew[2 * tid] = expf(w0);
            s.ew[2 * tid + 1] = expf(w1);
            s.src[2 * tid] = s.dt[2 * tid] * expf(wl - w0);
            s.src[2 * tid + 1] = s.dt[2 * tid + 1] * expf(wl - w1);
        }
        __syncthreads();

        // att[t][u] = (C_t . B_u) exp(W_t - W_u) dt_u for u <= t, else 0
        {
            float acc[4][4];
            #pragma unroll
            for (int r = 0; r < 4; ++r)
                acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
            #pragma unroll 8
            for (int k = 0; k < N; ++k) {
                float cv[4], bv[4];
                #pragma unroll
                for (int r = 0; r < 4; ++r) cv[r] = s.cm[4 * ty + r][k];
                #pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = s.bm[tx + 16 * j][k];
                #pragma unroll
                for (int r = 0; r < 4; ++r)
                    #pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[r][j] = fmaf(cv[r], bv[j], acc[r][j]);
            }
            #pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int t = 4 * ty + r;
                #pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int u = tx + 16 * j;
                    // select: exp(W_t - W_u) is inf above the diagonal
                    s.att[t][u] = u <= t
                        ? acc[r][j] * expf(s.w[t] - s.w[u]) * s.dt[u] : 0.f;
                }
            }
        }
        __syncthreads();

        // y[t][i] = exp(W_t) (C_t . h_i) + sum_{u <= t} att[t][u] x[u][i]
        {
            float inter[4][RP], intra[4][RP];
            #pragma unroll
            for (int r = 0; r < 4; ++r)
                #pragma unroll
                for (int j = 0; j < RP; ++j) inter[r][j] = intra[r][j] = 0.f;
            #pragma unroll 8
            for (int k = 0; k < N; ++k) {
                float cv[4], hv[RP];
                #pragma unroll
                for (int r = 0; r < 4; ++r) cv[r] = s.cm[4 * ty + r][k];
                #pragma unroll
                for (int j = 0; j < RP; ++j) hv[j] = s.h[tx + 16 * j][k];
                #pragma unroll
                for (int r = 0; r < 4; ++r)
                    #pragma unroll
                    for (int j = 0; j < RP; ++j)
                        inter[r][j] = fmaf(cv[r], hv[j], inter[r][j]);
            }
            const int u_last = 4 * ty + 3;     // att is 0 past the diagonal
            for (int u = 0; u <= u_last; ++u) {
                float av[4], xv[RP];
                #pragma unroll
                for (int r = 0; r < 4; ++r) av[r] = s.att[4 * ty + r][u];
                #pragma unroll
                for (int j = 0; j < RP; ++j) xv[j] = s.xs[u][tx + 16 * j];
                #pragma unroll
                for (int r = 0; r < 4; ++r)
                    #pragma unroll
                    for (int j = 0; j < RP; ++j)
                        intra[r][j] = fmaf(av[r], xv[j], intra[r][j]);
            }
            #pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int t = 4 * ty + r;
                if (c0 + t >= p.T) continue;
                T* yrow = yg + (long long)(c0 + t) * p.y_t;
                #pragma unroll
                for (int j = 0; j < RP; ++j) {
                    const int col = tx + 16 * j;
                    if (col < p.p)
                        store(yrow + col, inter[r][j] * s.ew[t] + intra[r][j]);
                }
            }
        }
        __syncthreads();            // every thread has read h

        // h[i][k] = exp(W_last) h[i][k] + sum_u (x[u][i] src[u]) B[u][k]
        {
            const float ewl = s.ew[Q - 1];
            float upd[RP][CN];
            #pragma unroll
            for (int r = 0; r < RP; ++r)
                #pragma unroll
                for (int j = 0; j < CN; ++j) upd[r][j] = 0.f;
            #pragma unroll 4
            for (int u = 0; u < Q; ++u) {
                const float sv = s.src[u];
                float xv[RP], bv[CN];
                #pragma unroll
                for (int r = 0; r < RP; ++r) xv[r] = s.xs[u][RP * ty + r] * sv;
                #pragma unroll
                for (int j = 0; j < CN; ++j) bv[j] = s.bm[u][tx + 16 * j];
                #pragma unroll
                for (int r = 0; r < RP; ++r)
                    #pragma unroll
                    for (int j = 0; j < CN; ++j)
                        upd[r][j] = fmaf(xv[r], bv[j], upd[r][j]);
            }
            #pragma unroll
            for (int r = 0; r < RP; ++r)
                #pragma unroll
                for (int j = 0; j < CN; ++j) {
                    hreg[r][j] = ewl * hreg[r][j] + upd[r][j];
                    s.h[RP * ty + r][tx + 16 * j] = hreg[r][j];
                }
        }
        __syncthreads();            // the next chunk overwrites x, B and h
    }

    float* hg = hout + (long long)blockIdx.x * p.p * p.n;
    #pragma unroll
    for (int r = 0; r < RP; ++r)
        #pragma unroll
        for (int j = 0; j < CN; ++j) {
            const int i = RP * ty + r, k = tx + 16 * j;
            if (i < p.p && k < p.n) hg[i * p.n + k] = hreg[r][j];
        }
}

template <typename T, int P, int N>
int launch_tile(const void* xs, const void* bm, const void* cm,
                const float* dt, const float* la, void* y, float* hout,
                const Params& p, int panes, cudaStream_t stream) {
    const size_t smem = sizeof(Smem<P, N>);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_scan<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_scan<T, P, N><<<panes, THREADS, smem, stream>>>(
        static_cast<const T*>(xs), static_cast<const T*>(bm),
        static_cast<const T*>(cm), dt, la, static_cast<T*>(y), hout, p);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_type(const void* xs, const void* bm, const void* cm,
                const float* dt, const float* la, void* y, float* hout,
                const Params& p, int panes, cudaStream_t stream) {
    if (p.p <= 64)
        return launch_tile<T, 64, 64>(xs, bm, cm, dt, la, y, hout, p, panes,
                                      stream);
    return launch_tile<T, 128, 64>(xs, bm, cm, dt, la, y, hout, p, panes,
                                   stream);
}

}  // namespace

extern "C" {

int ssd_chunk_length() { return Q; }
int ssd_chunk_max_p() { return 128; }
int ssd_chunk_max_n() { return 64; }

// y (in x's dtype) and hout (B*H, p, n) f32 of the SSD scan over B x H
// panes of T steps; x (b, h, t, :), B, C (b, h, t, :) and dt, la (b, h, t)
// are read and y written through the given element strides (the last
// axis of x, B, C and y is contiguous; a head stride of 0 shares B and C
// across heads). bf16 != 0: x, B, C and y are bf16, else f32. Returns the
// first non-zero cudaError_t, else 0.
int ssd_scan_launch(const void* xs, const void* bm, const void* cm,
                    const float* dt, const float* la, void* y, float* hout,
                    int B, int H, int T, int p, int n,
                    long long x_b, long long x_h, long long x_t,
                    long long b_b, long long b_h, long long b_t,
                    long long c_b, long long c_h, long long c_t,
                    long long dt_b, long long dt_h, long long dt_t,
                    long long la_b, long long la_h, long long la_t,
                    long long y_b, long long y_h, long long y_t, int bf16,
                    void* stream_ptr) {
    const long long panes = (long long)B * H;
    if (B < 1 || H < 1 || T < 1 || p < 1 || n < 1 || p > 128 || n > 64 ||
        panes > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const Params prm{H, T, p, n, x_b, x_h, x_t, b_b, b_h, b_t, c_b, c_h, c_t,
                     dt_b, dt_h, dt_t, la_b, la_h, la_t, y_b, y_h, y_t};
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (bf16)
        return launch_type<__nv_bfloat16>(xs, bm, cm, dt, la, y, hout, prm,
                                          (int)panes, stream);
    return launch_type<float>(xs, bm, cm, dt, la, y, hout, prm, (int)panes,
                              stream);
}

}  // extern "C"
