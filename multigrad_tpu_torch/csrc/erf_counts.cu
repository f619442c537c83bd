// Dense erf-CDF binned counts: forward and backward kernels for Hopper.
//
// Replaces the Pallas TPU kernels of multigrad_tpu/ops/pallas_kernels.py:
//   * _make_erf_fwd_kernel (the forward, launched by _erf_counts_fwd) and
//   * _make_erf_bwd_kernel (the backward, launched by _erf_bwd_pallas_call),
// scalar-sigma variant.  Built with nvcc into a shared library with a
// plain C interface and loaded with ctypes
// (multigrad_tpu_torch/ops/erf_kernels.py).
//
// What bounds them on an H100: the forward evaluates the clamped rational
// erf at every edge for every particle (E*N evaluations of ~30 f32
// operations, one of them a division) and reads 4*N bytes, so it is bound
// by the FP32 pipes.  The backward does one expf and ~10 f32 operations
// per (edge, particle) and reads and writes 4*N bytes each, so at E = 11
// it sits near the memory roofline.
//
// Design: neither kernel writes an (E, N) matrix.  A grid-stride loop
// walks the particles; the edges (and the backward's h) sit in shared
// memory; each thread accumulates its per-bin sums in registers (the
// edge loop is unrolled to a compile-time cap, MAXE).  Each block reduces
// its threads' sums in a fixed order (warp shuffles, then the warps in
// order) and writes one row of a (grid, cols) partials buffer, and a
// second kernel sums the rows of each column in a fixed order.  No
// atomics: for a given N and grid the result is the same bit for bit on
// every run.  This replaces the TPU's sequential-grid accumulator, which
// has no counterpart on 132 SMs that run blocks in no order.
//
// Numerics follow the plain PyTorch versions in erf_kernels.py: the same
// clamped rational polynomial as XLA's f32 erf (_erf_f32), IEEE division
// and expf (no fast-math), and +-inf particles clipped to +-1e18 so that
// a padded particle contributes exactly 0 forward and backward.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kPad = 1e18f;
constexpr float kSqrt2 = 1.4142135623730951f;

// Clip to +-1e18, keeping NaN (like torch.clamp and jnp.clip).
__device__ __forceinline__ float clip_pad(float v) {
  return v > kPad ? kPad : (v < -kPad ? -kPad : v);
}

// XLA's float32 erf: clamp to [-4, 4], then x * P(x^2) / Q(x^2).
__device__ __forceinline__ float erf_f32(float x) {
  x = x > 4.0f ? 4.0f : (x < -4.0f ? -4.0f : x);
  const float x2 = x * x;
  float a = -2.72614225801306e-10f;
  a = a * x2 + 2.77068142495902e-08f;
  a = a * x2 + -2.10102402082508e-06f;
  a = a * x2 + -5.69250639462346e-05f;
  a = a * x2 + -7.34990630326855e-04f;
  a = a * x2 + -2.95459980854025e-03f;
  a = a * x2 + -1.60960333262415e-02f;
  float b = -1.45660718464996e-05f;
  b = b * x2 + -2.13374055278905e-04f;
  b = b * x2 + -1.68282697438203e-03f;
  b = b * x2 + -7.37332916720468e-03f;
  b = b * x2 + -1.42647390514189e-02f;
  return x * a / b;
}

__device__ __forceinline__ float norm_cdf(float z) {
  return 0.5f * (1.0f + erf_f32(z));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// Reduce each of the first `ncols` of a thread's `acc` over the block and
// write them to row blockIdx.x of `partials` (fixed order throughout).
template <int NACC>
__device__ __forceinline__ void block_rows(const float (&acc)[NACC], int ncols,
                                           float (*s_warp)[NACC], float* partials) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NACC; ++c) {
    if (c < ncols) {
      const float x = warp_sum(acc[c]);
      if (lane == 0) s_warp[warp][c] = x;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += s_warp[w][c];
    partials[(long long)blockIdx.x * ncols + c] = s;
  }
}

// counts_b = sum_i [cdf((e_{b+1} - v_i) inv) - cdf((e_b - v_i) inv)],
// differenced per particle before the sum (see ops/binned.py).
template <int MAXE>
__global__ void __launch_bounds__(kThreads)
erf_fwd_kernel(const float* __restrict__ vals, long long n,
               const float* __restrict__ edges, int n_edges,
               const float* __restrict__ sigma, float* __restrict__ partials) {
  __shared__ float s_edges[MAXE];
  __shared__ float s_warp[kWarps][MAXE - 1];
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) s_edges[e] = edges[e];
  __syncthreads();
  const float inv = 1.0f / (kSqrt2 * sigma[0]);

  float acc[MAXE - 1];
#pragma unroll
  for (int b = 0; b < MAXE - 1; ++b) acc[b] = 0.0f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = clip_pad(vals[i]);
    float prev = norm_cdf((s_edges[0] - v) * inv);
#pragma unroll
    for (int e = 1; e < MAXE; ++e) {
      if (e < n_edges) {
        const float cur = norm_cdf((s_edges[e] - v) * inv);
        acc[e - 1] += cur - prev;
        prev = cur;
      }
    }
  }
  block_rows<MAXE - 1>(acc, n_edges - 1, s_warp, partials);
}

// With P = exp(-z^2), z = (e - v) inv and h_e = g_{e-1} - g_e:
//   dv_raw_i = sum_e h_e P_ei                 (per particle)
//   row e    = sum_i P_ei                     (e < n_edges)
//   row E    = sum_ei h_e P_ei z_ei           (scalar)
// The constant factors (inv/sqrt(pi), 1/(sigma sqrt(pi))) are applied by
// the caller, as _erf_counts_bwd does for the TPU kernel.
template <int MAXE>
__global__ void __launch_bounds__(kThreads)
erf_bwd_kernel(const float* __restrict__ vals, long long n,
               const float* __restrict__ edges, int n_edges,
               const float* __restrict__ sigma, const float* __restrict__ h,
               float* __restrict__ dv_raw, float* __restrict__ partials) {
  __shared__ float s_edges[MAXE];
  __shared__ float s_h[MAXE];
  __shared__ float s_warp[kWarps][MAXE + 1];
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) {
    s_edges[e] = edges[e];
    s_h[e] = h[e];
  }
  __syncthreads();
  const float inv = 1.0f / (kSqrt2 * sigma[0]);

  float acc[MAXE + 1];  // acc[e] = sum_i P_ei for e < n_edges; hpz goes
                       // into acc[n_edges] after the loop
#pragma unroll
  for (int e = 0; e < MAXE + 1; ++e) acc[e] = 0.0f;
  float hpz = 0.0f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = clip_pad(vals[i]);
    float dv = 0.0f;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (e < n_edges) {
        const float z = (s_edges[e] - v) * inv;
        const float p = expf(-(z * z));
        dv += s_h[e] * p;
        acc[e] += p;
        hpz += s_h[e] * (p * z);
      }
    }
    dv_raw[i] = dv;
  }
  // Column n_edges of the partials row carries sum h P z.
#pragma unroll
  for (int e = 0; e < MAXE + 1; ++e) {
    if (e == n_edges) acc[e] = hpz;
  }
  block_rows<MAXE + 1>(acc, n_edges + 1, s_warp, partials);
}

// out[c] = sum_r partials[r, c], one block per column, fixed order.
__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const float* __restrict__ partials, int rows, int cols,
                float* __restrict__ out) {
  __shared__ float s[kThreads];
  const int c = blockIdx.x;
  float x = 0.0f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) x += partials[(long long)r * cols + c];
  s[threadIdx.x] = x;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[c] = s[0];
}

template <int MAXE>
void launch_fwd(const float* vals, long long n, const float* edges, int n_edges,
                const float* sigma, float* partials, int grid, cudaStream_t stream) {
  erf_fwd_kernel<MAXE><<<grid, kThreads, 0, stream>>>(vals, n, edges, n_edges, sigma, partials);
}

template <int MAXE>
void launch_bwd(const float* vals, long long n, const float* edges, int n_edges,
                const float* sigma, const float* h, float* dv_raw, float* partials,
                int grid, cudaStream_t stream) {
  erf_bwd_kernel<MAXE><<<grid, kThreads, 0, stream>>>(vals, n, edges, n_edges, sigma, h,
                                                      dv_raw, partials);
}

}  // namespace

extern "C" {

// Forward: counts (n_edges - 1,) from vals (n,), edges (n_edges,), sigma
// (a device scalar).  partials is a (grid, n_edges - 1) scratch buffer.
// 2 <= n_edges <= 128.  Returns cudaGetLastError() after both launches.
int erf_counts_fwd(const float* vals, long long n, const float* edges, int n_edges,
                   const float* sigma, float* partials, int grid, float* counts,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_edges <= 16) launch_fwd<16>(vals, n, edges, n_edges, sigma, partials, grid, s);
  else if (n_edges <= 32) launch_fwd<32>(vals, n, edges, n_edges, sigma, partials, grid, s);
  else if (n_edges <= 64) launch_fwd<64>(vals, n, edges, n_edges, sigma, partials, grid, s);
  else launch_fwd<128>(vals, n, edges, n_edges, sigma, partials, grid, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_kernel<<<n_edges - 1, kThreads, 0, s>>>(partials, grid, n_edges - 1, counts);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dv_raw (n,) and sums (n_edges + 1,) = [sum_i P_ei ..., sum h P z]
// from vals, edges, sigma and h (n_edges,).  partials is a
// (grid, n_edges + 1) scratch buffer.  Returns cudaGetLastError().
int erf_counts_bwd(const float* vals, long long n, const float* edges, int n_edges,
                   const float* sigma, const float* h, float* dv_raw, float* partials,
                   int grid, float* sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_edges <= 16) launch_bwd<16>(vals, n, edges, n_edges, sigma, h, dv_raw, partials, grid, s);
  else if (n_edges <= 32) launch_bwd<32>(vals, n, edges, n_edges, sigma, h, dv_raw, partials, grid, s);
  else if (n_edges <= 64) launch_bwd<64>(vals, n, edges, n_edges, sigma, h, dv_raw, partials, grid, s);
  else launch_bwd<128>(vals, n, edges, n_edges, sigma, h, dv_raw, partials, grid, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_kernel<<<n_edges + 1, kThreads, 0, s>>>(partials, grid, n_edges + 1, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
