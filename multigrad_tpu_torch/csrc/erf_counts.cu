// Dense erf-CDF binned counts: forward and backward kernels for Hopper.
//
// Replaces the Pallas TPU kernels of multigrad_tpu/ops/pallas_kernels.py:
//   * _make_erf_fwd_kernel (the forward, launched by _erf_counts_fwd) and
//   * _make_erf_bwd_kernel (the backward, launched by _erf_bwd_pallas_call),
// both in their scalar-sigma and per-particle-sigma (vec_sigma) variants,
// which are the template flag VEC here.  Built with nvcc into a shared
// library with a plain C interface and loaded with ctypes
// (multigrad_tpu_torch/ops/erf_kernels.py).
//
// What bounds them on an H100: the forward evaluates the clamped rational
// erf at every edge for every particle (E*N evaluations of ~30 f32
// operations, one of them a division) and reads 4*N bytes (8*N with a
// per-particle sigma), so it is bound by the FP32 pipes.  The backward
// does one expf and ~10 f32 operations per (edge, particle) and reads and
// writes 4*N bytes each (with VEC: reads 8*N, writes dv and dsigma, 8*N),
// so at E = 11..14 it sits near the memory roofline.
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
// has no counterpart on 132 SMs that run blocks in no order.  With VEC,
// each thread reads sigma_i beside v_i and forms inv_i = 1/(sqrt2 sigma_i)
// itself; the backward then writes dvalues and dsigma per particle,
// already scaled, and its partials rows hold the inv-weighted sums
// sum_i inv_i P_ei that dedges needs.
#include "erf_common.cuh"

namespace {

using namespace erfk;

// counts_b = sum_i [cdf((e_{b+1} - v_i) inv_i) - cdf((e_b - v_i) inv_i)],
// differenced per particle before the sum (see ops/binned.py).
template <int MAXE, bool VEC>
__global__ void __launch_bounds__(kThreads)
erf_fwd_kernel(const float* __restrict__ vals, long long n,
               const float* __restrict__ edges, int n_edges,
               const float* __restrict__ sigma, float* __restrict__ partials) {
  __shared__ float s_edges[MAXE];
  __shared__ float s_warp[kWarps][MAXE - 1];
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) s_edges[e] = edges[e];
  __syncthreads();
  const float inv_s = VEC ? 0.0f : inv_of(sigma[0]);

  float acc[MAXE - 1];
#pragma unroll
  for (int b = 0; b < MAXE - 1; ++b) acc[b] = 0.0f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = clip_pad(vals[i]);
    const float inv = VEC ? inv_of(sigma[i]) : inv_s;
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

// With P = exp(-z^2), z = (e - v) inv and h_e = g_{e-1} - g_e.
// Scalar sigma (the caller applies the constant factors, as
// _erf_counts_bwd does for the TPU kernel):
//   dv[i]    = sum_e h_e P_ei                 (raw, per particle)
//   row e    = sum_i P_ei                     (e < n_edges)
//   row E    = sum_ei h_e P_ei z_ei           (scalar)
// Per-particle sigma (VEC), scaled here with each particle's inv_i:
//   dv[i]    = -(inv_i / sqrt(pi)) sum_e h_e P_ei
//   ds[i]    = -(1 / (sigma_i sqrt(pi))) sum_e h_e P_ei z_ei
//   row e    = sum_i inv_i P_ei
template <int MAXE, bool VEC>
__global__ void __launch_bounds__(kThreads)
erf_bwd_kernel(const float* __restrict__ vals, long long n,
               const float* __restrict__ edges, int n_edges,
               const float* __restrict__ sigma, const float* __restrict__ h,
               float* __restrict__ dv_out, float* __restrict__ ds_out,
               float* __restrict__ partials) {
  __shared__ float s_edges[MAXE];
  __shared__ float s_h[MAXE];
  __shared__ float s_warp[kWarps][MAXE + 1];
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) {
    s_edges[e] = edges[e];
    s_h[e] = h[e];
  }
  __syncthreads();
  const float inv_s = VEC ? 0.0f : inv_of(sigma[0]);

  float acc[MAXE + 1];  // acc[e] = row e for e < n_edges; with a scalar
                       // sigma hpz goes into acc[n_edges] after the loop
#pragma unroll
  for (int e = 0; e < MAXE + 1; ++e) acc[e] = 0.0f;
  float hpz = 0.0f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = clip_pad(vals[i]);
    const float inv = VEC ? inv_of(sigma[i]) : inv_s;
    float dv = 0.0f;
    float hz = VEC ? 0.0f : hpz;
#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      if (e < n_edges) {
        const float z = (s_edges[e] - v) * inv;
        const float p = expf(-(z * z));
        dv += s_h[e] * p;
        acc[e] += VEC ? inv * p : p;
        hz += s_h[e] * (p * z);
      }
    }
    if (VEC) {
      dv_out[i] = -(inv * kInvSqrtPi) * dv;
      ds_out[i] = -(inv * kSqrt2 * kInvSqrtPi) * hz;
    } else {
      dv_out[i] = dv;
      hpz = hz;
    }
  }
  // With a scalar sigma, column n_edges of the partials row carries
  // sum h P z.
  if (!VEC) {
#pragma unroll
    for (int e = 0; e < MAXE + 1; ++e) {
      if (e == n_edges) acc[e] = hpz;
    }
  }
  block_rows<MAXE + 1>(acc, VEC ? n_edges : n_edges + 1, s_warp, partials);
}

template <bool VEC>
void launch_fwd(const float* vals, long long n, const float* edges, int n_edges,
                const float* sigma, float* partials, int grid, cudaStream_t s) {
#define MGT_FWD(M) erf_fwd_kernel<M, VEC><<<grid, kThreads, 0, s>>>(vals, n, edges, n_edges, sigma, partials)
  if (n_edges <= 16) MGT_FWD(16);
  else if (n_edges <= 32) MGT_FWD(32);
  else if (n_edges <= 64) MGT_FWD(64);
  else MGT_FWD(128);
#undef MGT_FWD
}

template <bool VEC>
void launch_bwd(const float* vals, long long n, const float* edges, int n_edges,
                const float* sigma, const float* h, float* dv, float* ds, float* partials,
                int grid, cudaStream_t s) {
#define MGT_BWD(M) erf_bwd_kernel<M, VEC><<<grid, kThreads, 0, s>>>(vals, n, edges, n_edges, sigma, h, dv, ds, partials)
  if (n_edges <= 16) MGT_BWD(16);
  else if (n_edges <= 32) MGT_BWD(32);
  else if (n_edges <= 64) MGT_BWD(64);
  else MGT_BWD(128);
#undef MGT_BWD
}

}  // namespace

extern "C" {

// Forward: counts (n_edges - 1,) from vals (n,), edges (n_edges,) and
// sigma: a device scalar, or (n,) when vec_sigma is nonzero.  partials is
// a (grid, n_edges - 1) scratch buffer.  2 <= n_edges <= 128.  Returns
// cudaGetLastError() after both launches.
int erf_counts_fwd(const float* vals, long long n, const float* edges, int n_edges,
                   const float* sigma, int vec_sigma, float* partials, int grid,
                   float* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_sigma) launch_fwd<true>(vals, n, edges, n_edges, sigma, partials, grid, s);
  else launch_fwd<false>(vals, n, edges, n_edges, sigma, partials, grid, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_kernel<<<n_edges - 1, kThreads, 0, s>>>(partials, grid, n_edges - 1, counts);
  return static_cast<int>(cudaGetLastError());
}

// Backward, for h (n_edges,).  Scalar sigma: dv (n,) raw, sums
// (n_edges + 1,) = [sum_i P_ei ..., sum h P z], ds unused.  vec_sigma:
// dv and ds (n,) scaled, sums (n_edges,) = [sum_i inv_i P_ei ...].
// partials is a (grid, len(sums)) scratch buffer.  Returns
// cudaGetLastError().
int erf_counts_bwd(const float* vals, long long n, const float* edges, int n_edges,
                   const float* sigma, int vec_sigma, const float* h, float* dv, float* ds,
                   float* partials, int grid, float* sums, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_sigma) launch_bwd<true>(vals, n, edges, n_edges, sigma, h, dv, ds, partials, grid, s);
  else launch_bwd<false>(vals, n, edges, n_edges, sigma, h, dv, ds, partials, grid, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = vec_sigma ? n_edges : n_edges + 1;
  sum_rows_kernel<<<cols, kThreads, 0, s>>>(partials, grid, cols, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
