// Numerics and reductions shared by the erf-CDF kernels (erf_counts.cu,
// fused_counts.cu) and the pair kernels (pair_counts.cu).
//
// The same clamped rational polynomial as XLA's f32 erf (the plain
// PyTorch versions' _erf_f32), IEEE division and expf (no fast-math), and
// +-inf particles clipped to +-1e18 so that a padded particle contributes
// exactly 0 forward and backward.
#pragma once
#include <cuda_runtime.h>

namespace erfk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kPad = 1e18f;
constexpr float kSqrt2 = 1.4142135623730951f;
constexpr float kInvSqrtPi = 0.5641895835477563f;

// Clip to +-1e18, keeping NaN (like torch.clamp and jnp.clip).
__device__ __forceinline__ float clip_pad(float v) {
  return v > kPad ? kPad : (v < -kPad ? -kPad : v);
}

// XLA's float32 erf: clamp to [-4, 4], then x * P(x^2) / Q(x^2).  Each
// Horner step is a rounded multiply and a rounded add (__fmul_rn,
// __fadd_rn, which nvcc never contracts into an FMA), as PyTorch's
// separate elementwise ops round them: every cdf then equals the plain
// version's bit for bit.  That matters in the deep tails, where
// 0.5 * (1 + erf) keeps only a few bits and one ulp of erf is the whole
// content of a near-empty bin: contracted into FMAs, the history model
// with 41 edges on an H100 missed the loss of its CPU path, fed the same
// history, by up to 61%; this way by at most 4.4e-7
// (tools/hist_card_vs_cpu.py).
__device__ __forceinline__ float horner(float acc, float x2, float c) {
  return __fadd_rn(__fmul_rn(acc, x2), c);
}

__device__ __forceinline__ float erf_f32(float x) {
  x = x > 4.0f ? 4.0f : (x < -4.0f ? -4.0f : x);
  const float x2 = x * x;
  float a = -2.72614225801306e-10f;
  a = horner(a, x2, 2.77068142495902e-08f);
  a = horner(a, x2, -2.10102402082508e-06f);
  a = horner(a, x2, -5.69250639462346e-05f);
  a = horner(a, x2, -7.34990630326855e-04f);
  a = horner(a, x2, -2.95459980854025e-03f);
  a = horner(a, x2, -1.60960333262415e-02f);
  float b = -1.45660718464996e-05f;
  b = horner(b, x2, -2.13374055278905e-04f);
  b = horner(b, x2, -1.68282697438203e-03f);
  b = horner(b, x2, -7.37332916720468e-03f);
  b = horner(b, x2, -1.42647390514189e-02f);
  return x * a / b;
}

__device__ __forceinline__ float norm_cdf(float z) {
  return 0.5f * (1.0f + erf_f32(z));
}

// 1 / (sqrt(2) sigma), the scale of z = (e - v) * inv.
__device__ __forceinline__ float inv_of(float sigma) {
  return 1.0f / (kSqrt2 * sigma);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// After every thread of the block has written its part of the block's
// partials row: true in the last block of the grid to get here, which
// may then read every row.
__device__ __forceinline__ bool last_block(int* counter) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
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

}  // namespace erfk
