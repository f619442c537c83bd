// Fused (windowed) erf-CDF bin masses: forward and backward kernels for
// Hopper.
//
// Replaces the Pallas TPU kernels of multigrad_tpu/ops/pallas_kernels.py:
//   * _make_fused_fwd_kernel (the forward, launched by _fused_masses_fwd)
//   * _make_fused_bwd_kernel (the backward, launched by _fused_masses_bwd)
// in both their scalar-sigma and per-particle-sigma (VEC) variants.  Built
// with nvcc into a shared library with a plain C interface and loaded with
// ctypes (multigrad_tpu_torch/ops/fused_kernels.py).
//
// Each particle i evaluates the cdf at the W consecutive edges that start
// at start_i (the window, located by a searchsorted in the wrapper) and
// writes its W-1 bin masses; the scatter of the masses into the count
// vector stays outside the kernel (ops/binned.py::scatter_bin_masses),
// as in the JAX package.
//
// What bounds them on an H100: the forward reads v, sigma and start (4 to
// 12 bytes a particle) and writes 4*(W-1) bytes of masses for ~30*W f32
// operations, so at W = 33 the 128 bytes written outweigh the ~1,000
// operations and it is bound by memory; the backward reads the masses'
// cotangent (another 4*(W-1) bytes) and does one expf and ~10 operations
// per slot, also bound by memory.
//
// Design: one thread per particle over a grid-stride loop.  The whole
// edge vector sits in dynamic shared memory and each thread reads
// edges[start_i + w] from there, so the (N, W) gather of edge windows that
// the TPU kernel needs (Mosaic has no per-element gather) never exists.
// Masses and their cotangent are slot-major, (W-1, N): a warp's loads and
// stores for one slot are 128 contiguous bytes.  The backward's per-slot
// edge cotangent dewin (W, N) is written only when asked for (a null
// pointer otherwise).  With a scalar sigma the backward reduces sum h P z
// per block in a fixed order into a partials row and sum_rows_kernel adds
// the rows: no atomics, so every output is the same bit for bit on repeat.
#include "erf_common.cuh"

namespace {

using namespace erfk;

constexpr int kSmemDefault = 48 * 1024;

// masses[w-1, i] = cdf((e[s_i + w] - v_i) inv_i) - cdf((e[s_i + w - 1] - v_i) inv_i)
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const float* __restrict__ vals, long long n,
                 const float* __restrict__ edges, int n_edges,
                 const float* __restrict__ sigma, const int* __restrict__ start,
                 int window, float* __restrict__ masses) {
  extern __shared__ float s_edges[];
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) s_edges[e] = edges[e];
  __syncthreads();
  const float inv_s = VEC ? 0.0f : inv_of(sigma[0]);

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = clip_pad(vals[i]);
    const float inv = VEC ? inv_of(sigma[i]) : inv_s;
    const float* ew = s_edges + start[i];
    float* out = masses + i;
    float prev = norm_cdf((ew[0] - v) * inv);
    for (int w = 1; w < window; ++w) {
      const float cur = norm_cdf((ew[w] - v) * inv);
      out[(long long)(w - 1) * n] = cur - prev;
      prev = cur;
    }
  }
}

// With z = (e[s_i + w] - v_i) inv_i, P = exp(-z^2) and, per slot,
// h_w = g[w-1, i] - g[w, i] (g[-1] = g[W-1] = 0):
//   dv[i]       = -(inv_i / sqrt(pi)) sum_w h_w P_w
//   dewin[w, i] =  (inv_i / sqrt(pi)) h_w P_w            (if dewin)
//   ds[i]       = -(1 / (sigma_i sqrt(pi))) sum_w h_w P_w z_w   (VEC)
//   partials[b] = sum over block b of sum_w h_w P_w z_w  (scalar sigma;
//                 the caller applies -(1 / (sigma sqrt(pi))))
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
fused_bwd_kernel(const float* __restrict__ vals, long long n,
                 const float* __restrict__ edges, int n_edges,
                 const float* __restrict__ sigma, const int* __restrict__ start,
                 int window, const float* __restrict__ g,
                 float* __restrict__ dv_out, float* __restrict__ dewin,
                 float* __restrict__ ds_out, float* __restrict__ partials) {
  extern __shared__ float s_edges[];
  __shared__ float s_warp[kWarps][1];
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) s_edges[e] = edges[e];
  __syncthreads();
  const float inv_s = VEC ? 0.0f : inv_of(sigma[0]);

  float hpz = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = clip_pad(vals[i]);
    const float inv = VEC ? inv_of(sigma[i]) : inv_s;
    const float* ew = s_edges + start[i];
    float g_prev = 0.0f, dv = 0.0f, hz = 0.0f;
    for (int w = 0; w < window; ++w) {
      const float g_cur = w < window - 1 ? g[(long long)w * n + i] : 0.0f;
      const float h = g_prev - g_cur;
      g_prev = g_cur;
      const float z = (ew[w] - v) * inv;
      const float hp = h * expf(-(z * z));
      dv += hp;
      if (dewin != nullptr) dewin[(long long)w * n + i] = (inv * kInvSqrtPi) * hp;
      hz += hp * z;
    }
    dv_out[i] = -(inv * kInvSqrtPi) * dv;
    if (VEC) ds_out[i] = -(inv * kSqrt2 * kInvSqrtPi) * hz;
    else hpz += hz;
  }
  if (!VEC) {
    const float acc[1] = {hpz};
    block_rows<1>(acc, 1, s_warp, partials);
  }
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Forward: masses (window - 1, n), slot-major, from vals (n,), edges
// (n_edges,), sigma (a device scalar, or (n,) when vec_sigma is nonzero)
// and start (n,) int32 with 0 <= start_i <= n_edges - window.  Returns
// cudaGetLastError() after the launch.
int fused_masses_fwd(const float* vals, long long n, const float* edges, int n_edges,
                     const float* sigma, int vec_sigma, const int* start, int window,
                     float* masses, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * n_edges;
  cudaError_t err;
  if (vec_sigma) {
    err = allow_smem(fused_fwd_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_fwd_kernel<true><<<grid, kThreads, smem, s>>>(vals, n, edges, n_edges, sigma, start,
                                                        window, masses);
  } else {
    err = allow_smem(fused_fwd_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_fwd_kernel<false><<<grid, kThreads, smem, s>>>(vals, n, edges, n_edges, sigma, start,
                                                         window, masses);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, for the masses' cotangent g (window - 1, n), slot-major: dv
// (n,) and, if dewin is not null, dewin (window, n).  vec_sigma: ds (n,),
// partials and ds_sum unused.  Scalar sigma: ds_sum (1,) = sum h P z
// through partials, a (grid,) scratch buffer.  Returns cudaGetLastError().
int fused_masses_bwd(const float* vals, long long n, const float* edges, int n_edges,
                     const float* sigma, int vec_sigma, const int* start, int window,
                     const float* g, float* dv, float* dewin, float* ds, float* partials,
                     int grid, float* ds_sum, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * n_edges;
  cudaError_t err;
  if (vec_sigma) {
    err = allow_smem(fused_bwd_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_bwd_kernel<true><<<grid, kThreads, smem, s>>>(vals, n, edges, n_edges, sigma, start,
                                                        window, g, dv, dewin, ds, partials);
    return static_cast<int>(cudaGetLastError());
  }
  err = allow_smem(fused_bwd_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_bwd_kernel<false><<<grid, kThreads, smem, s>>>(vals, n, edges, n_edges, sigma, start,
                                                       window, g, dv, dewin, ds, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_kernel<<<1, kThreads, 0, s>>>(partials, grid, 1, ds_sum);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
