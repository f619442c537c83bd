// Dense erf-CDF binned counts: forward and backward kernels for Hopper.
//
// Replaces the Pallas TPU kernels of multigrad_tpu/ops/pallas_kernels.py:
//   * _make_erf_fwd_kernel (the forward, launched by _erf_counts_fwd) and
//   * _make_erf_bwd_kernel (the backward, launched by _erf_bwd_pallas_call),
// both in their scalar-sigma and per-particle-sigma (vec_sigma) variants,
// which are the last template flag, VEC, here.  Built with nvcc into a
// shared library with a plain C interface and loaded with ctypes
// (multigrad_tpu_torch/ops/erf_kernels.py).
//
// What bounds them on an H100.  The forward evaluates the clamped
// rational erf at every edge for every particle and reads 4 bytes a
// particle (8 with a per-particle sigma), so bytes never bind it.  Its
// f32 operations (≈31 a cdf) over 67 TFLOP/s are not its floor either:
// each Horner step is a rounded multiply and a rounded add that must not
// be contracted (erf_common.cuh), and nvcc's IEEE division issues ≈10
// instructions (MUFU.RCP, four FFMAs, the FCHK test, its branch and the
// BSSY/BSYNC around the slow path).  So a cdf issues ≈41 warp-
// instructions, and at one instruction per clock on each of the 528
// sub-partitions the floor is instruction issue: ≈1.35 ms for the SMF's
// 1.1e9 cdfs at 1.98 GHz.  The
// backward issues ≈16 instructions a (particle, edge) (z, z², expf, the
// row and particle sums) and moves 8 bytes a particle (16 with VEC):
// ≈0.5-0.6 ms of issue at 1e8 and 11 edges, against a byte bound of
// 0.24 ms.
//
// Design, against that floor:
//   * The edge count is a template argument for 2..16 edges (EXACT), so
//     the unrolled edge loop has no guard and no branch between edges,
//     and one edge's dependent chain overlaps the next edge's; above 16
//     edges caps of 32, 64 and 128 keep a guard at every edge.
//   * Each thread takes four particles a step (one 16-byte load of vals,
//     and of sigma with VEC, where every pointer is 16-byte aligned; a
//     one-particle loop takes the tail, or everything when unaligned), so
//     four independent cdf chains interleave at every edge.
//   * The division stays IEEE: its fast path without the FCHK test
//     rounds otherwise at some float32 in [-4, 4] (|x| below ~2^-98, where
//     the residual underflows; an exhaustive check on an H100), so every
//     cdf keeps erf_f32's bits.
//   * One launch per call.  Each thread sums its bins in registers, each
//     block reduces them in a fixed order (warp shuffles, then the warps
//     in order) into one row of a (grid, cols) partials buffer; a ticket
//     (__threadfence, then atomicAdd on an int counter) picks the last
//     block to finish, which sums each column over the rows in a fixed
//     order, writes the outputs and puts the counter back to 0.  No
//     atomic touches a sum: for a given N and grid every output is the
//     same bit for bit on every run.  This replaces the TPU's sequential
//     grid accumulator, which has no counterpart on 132 SMs that run
//     blocks in no order.  The grid gives each thread at least four
//     steps and each SM at most 16 blocks (ops/erf_kernels.py::erf_grid).
//   * The backward takes the counts' cotangent g and forms h_e = g_{e-1}
//     - g_e in shared memory, and writes every gradient already scaled
//     (the factors of ops/erf_kernels.py::_scale_grads, rounded as it
//     rounds them), so a call is one launch and nothing else.
#include <cstdint>

#include "erf_common.cuh"

namespace {

using namespace erfk;

// Particles a thread takes per step of the 16-byte path.
constexpr int kPer = 4;
constexpr float kSqrtPi = 1.7724538509055159f;

// True on every thread when each pointer is 16-byte aligned (a null
// pointer counts as aligned).
__device__ __forceinline__ bool aligned16(const void* a, const void* b, const void* c,
                                          const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15u) == 0;
}

// In the last block: each column of partials (rows, cols) summed over
// the rows, in a fixed order; the sum of column c is returned to thread
// c < cols.  Thread t adds column t % cols over rows t / cols, t / cols +
// lanes, ... (neighbouring threads read neighbouring floats, 8 loads in
// flight), then thread c adds its column's lanes in order.  __ldcg reads
// through L2, where the other blocks' rows are.  cols <= kThreads.
__device__ __forceinline__ float column_sums(const float* partials, int rows, int cols) {
  __shared__ float s_part[kThreads];
  const int lanes = kThreads / cols;
  const int c = threadIdx.x % cols, l = threadIdx.x / cols;
  float x = 0.0f;
  if (l < lanes) {
#pragma unroll 8
    for (int r = l; r < rows; r += lanes) x += __ldcg(partials + (long long)r * cols + c);
  }
  s_part[threadIdx.x] = x;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < cols) {
    for (int j = 0; j < lanes; ++j) s += s_part[j * cols + threadIdx.x];
  }
  return s;
}

// The four values at group q of a 16-byte-aligned array.
__device__ __forceinline__ void load4(const float* p, long long q, float (&out)[kPer]) {
  const float4 x = reinterpret_cast<const float4*>(p)[q];
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, long long q, const float (&x)[kPer]) {
  reinterpret_cast<float4*>(p)[q] = make_float4(x[0], x[1], x[2], x[3]);
}

// counts_b += sum_k [cdf((e_{b+1} - v_k) inv_k) - cdf((e_b - v_k) inv_k)]
// over NP particles, differenced per particle before the sum (see
// ops/binned.py).
template <int NP, int MAXE, bool EXACT>
__device__ __forceinline__ void fwd_step(const float (&v)[NP], const float (&inv)[NP],
                                         const float* s_edges, int n_edges,
                                         float (&acc)[MAXE - 1]) {
  float prev[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) prev[k] = norm_cdf((s_edges[0] - v[k]) * inv[k]);
#pragma unroll
  for (int e = 1; e < MAXE; ++e) {
    if (EXACT || e < n_edges) {
      const float edge = s_edges[e];
      float d = 0.0f;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const float cur = norm_cdf((edge - v[k]) * inv[k]);
        d = k == 0 ? cur - prev[k] : d + (cur - prev[k]);
        prev[k] = cur;
      }
      acc[e - 1] += d;
    }
  }
}

// counts (n_edges - 1,) of vals (n,) for a scalar sigma (sigma[0]) or a
// per-particle one (VEC, sigma (n,)).  EXACT: n_edges == MAXE.
template <int MAXE, bool EXACT, bool VEC>
__global__ void __launch_bounds__(kThreads)
erf_fwd_kernel(const float* __restrict__ vals, long long n, const float* __restrict__ edges,
               int n_edges, const float* __restrict__ sigma, float* __restrict__ partials,
               int* __restrict__ counter, float* __restrict__ counts) {
  __shared__ float s_edges[MAXE];
  __shared__ float s_warp[kWarps][MAXE - 1];
  if (EXACT) n_edges = MAXE;
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) s_edges[e] = edges[e];
  __syncthreads();
  const float inv_s = VEC ? 0.0f : inv_of(sigma[0]);

  float acc[MAXE - 1];
#pragma unroll
  for (int b = 0; b < MAXE - 1; ++b) acc[b] = 0.0f;

  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long groups =
      aligned16(vals, VEC ? sigma : nullptr, nullptr, nullptr) ? n / kPer : 0;
  for (long long q = tid; q < groups; q += stride) {
    float v[kPer], inv[kPer];
    load4(vals, q, v);
    if (VEC) load4(sigma, q, inv);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = clip_pad(v[k]);
      inv[k] = VEC ? inv_of(inv[k]) : inv_s;
    }
    fwd_step<kPer, MAXE, EXACT>(v, inv, s_edges, n_edges, acc);
  }
  for (long long i = groups * kPer + tid; i < n; i += stride) {
    const float v[1] = {clip_pad(vals[i])};
    const float inv[1] = {VEC ? inv_of(sigma[i]) : inv_s};
    fwd_step<1, MAXE, EXACT>(v, inv, s_edges, n_edges, acc);
  }

  block_rows<MAXE - 1>(acc, n_edges - 1, s_warp, partials);
  if (!last_block(counter)) return;
  const float s = column_sums(partials, gridDim.x, n_edges - 1);
  if (threadIdx.x < n_edges - 1) counts[threadIdx.x] = s;
  if (threadIdx.x == 0) *counter = 0;
}

// With P = exp(-z^2), z = (e - v) inv and h_e = g_{e-1} - g_e, over NP
// particles: dv_k = sum_e h_e P, hz_k = sum_e h_e P z, and the row terms
// acc[e] += sum_k P (scalar sigma) or sum_k inv_k P (VEC).
template <int NP, int MAXE, bool EXACT, bool VEC>
__device__ __forceinline__ void bwd_step(const float (&v)[NP], const float (&inv)[NP],
                                         const float* s_edges, const float* s_h, int n_edges,
                                         float (&acc)[MAXE + 1], float (&dv)[NP],
                                         float (&hz)[NP]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) dv[k] = hz[k] = 0.0f;
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    if (EXACT || e < n_edges) {
      const float edge = s_edges[e], he = s_h[e];
      float r = 0.0f;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const float z = (edge - v[k]) * inv[k];
        const float p = expf(-(z * z));
        dv[k] += he * p;
        const float term = VEC ? inv[k] * p : p;
        r = k == 0 ? term : r + term;
        hz[k] += he * (p * z);
      }
      acc[e] += r;
    }
  }
}

// All three gradients for the counts' cotangent g (n_edges - 1,), scaled:
//   dv[i]  = -(inv_i / sqrt(pi)) sum_e h_e P_ei
//   de[e]  = (inv / sqrt(pi)) h_e sum_i P_ei        scalar sigma
//          = (1 / sqrt(pi)) h_e sum_i inv_i P_ei    VEC
//   ds     = -(1 / (sigma sqrt(pi))) sum_ei h_e P_ei z_ei    scalar (1,)
//   ds[i]  = -(1 / (sigma_i sqrt(pi))) sum_e h_e P_ei z_ei   VEC (n,)
// Partials columns: e < n_edges the row sums, and with a scalar sigma
// column n_edges the sum of h P z.
template <int MAXE, bool EXACT, bool VEC>
__global__ void __launch_bounds__(kThreads)
erf_bwd_kernel(const float* __restrict__ vals, long long n, const float* __restrict__ edges,
               int n_edges, const float* __restrict__ sigma, const float* __restrict__ g,
               float* __restrict__ dv_out, float* __restrict__ de_out,
               float* __restrict__ ds_out, float* __restrict__ partials,
               int* __restrict__ counter) {
  __shared__ float s_edges[MAXE];
  __shared__ float s_h[MAXE];
  __shared__ float s_warp[kWarps][MAXE + 1];
  if (EXACT) n_edges = MAXE;
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) {
    s_edges[e] = edges[e];
    // h_e = g_{e-1} - g_e with g_{-1} = g_{E-1} = 0 (_h_from_g).
    s_h[e] = (e > 0 ? g[e - 1] : 0.0f) - (e < n_edges - 1 ? g[e] : 0.0f);
  }
  __syncthreads();
  const float inv_s = VEC ? 0.0f : inv_of(sigma[0]);
  // _scale_grads: dv = dv_raw * -(inv * (1/sqrt(pi))).
  const float dv_scale = -(inv_s * kInvSqrtPi);

  float acc[MAXE + 1];
#pragma unroll
  for (int e = 0; e < MAXE + 1; ++e) acc[e] = 0.0f;
  float hpz = 0.0f;

  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long groups =
      aligned16(vals, dv_out, VEC ? sigma : nullptr, VEC ? ds_out : nullptr) ? n / kPer : 0;
  for (long long q = tid; q < groups; q += stride) {
    float v[kPer], inv[kPer], dv[kPer], hz[kPer];
    load4(vals, q, v);
    if (VEC) load4(sigma, q, inv);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = clip_pad(v[k]);
      inv[k] = VEC ? inv_of(inv[k]) : inv_s;
    }
    bwd_step<kPer, MAXE, EXACT, VEC>(v, inv, s_edges, s_h, n_edges, acc, dv, hz);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (VEC) {
        dv[k] = -(inv[k] * kInvSqrtPi) * dv[k];
        hz[k] = -(inv[k] * kSqrt2 * kInvSqrtPi) * hz[k];
      } else {
        dv[k] = dv[k] * dv_scale;
        hpz += hz[k];
      }
    }
    store4(dv_out, q, dv);
    if (VEC) store4(ds_out, q, hz);
  }
  for (long long i = groups * kPer + tid; i < n; i += stride) {
    const float v[1] = {clip_pad(vals[i])};
    const float inv[1] = {VEC ? inv_of(sigma[i]) : inv_s};
    float dv[1], hz[1];
    bwd_step<1, MAXE, EXACT, VEC>(v, inv, s_edges, s_h, n_edges, acc, dv, hz);
    if (VEC) {
      dv_out[i] = -(inv[0] * kInvSqrtPi) * dv[0];
      ds_out[i] = -(inv[0] * kSqrt2 * kInvSqrtPi) * hz[0];
    } else {
      dv_out[i] = dv[0] * dv_scale;
      hpz += hz[0];
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
  const int cols = VEC ? n_edges : n_edges + 1;
  block_rows<MAXE + 1>(acc, cols, s_warp, partials);
  if (!last_block(counter)) return;
  const float s = column_sums(partials, gridDim.x, cols);
  const int c = threadIdx.x;
  if (c < n_edges) {
    de_out[c] = (VEC ? kInvSqrtPi * s_h[c] : (inv_s * kInvSqrtPi) * s_h[c]) * s;
  } else if (c == n_edges && !VEC) {
    ds_out[0] = -(s / (sigma[0] * kSqrtPi));
  }
  if (threadIdx.x == 0) *counter = 0;
}

// Instantiate LAUNCH(MAXE, EXACT) for n_edges: exact for 2..16 edges,
// caps of 32, 64 and 128 above.
#define MGT_BY_EDGES(LAUNCH)                       \
  switch (n_edges) {                               \
    case 2: LAUNCH(2, true); break;                \
    case 3: LAUNCH(3, true); break;                \
    case 4: LAUNCH(4, true); break;                \
    case 5: LAUNCH(5, true); break;                \
    case 6: LAUNCH(6, true); break;                \
    case 7: LAUNCH(7, true); break;                \
    case 8: LAUNCH(8, true); break;                \
    case 9: LAUNCH(9, true); break;                \
    case 10: LAUNCH(10, true); break;              \
    case 11: LAUNCH(11, true); break;              \
    case 12: LAUNCH(12, true); break;              \
    case 13: LAUNCH(13, true); break;              \
    case 14: LAUNCH(14, true); break;              \
    case 15: LAUNCH(15, true); break;              \
    case 16: LAUNCH(16, true); break;              \
    default:                                       \
      if (n_edges <= 32) LAUNCH(32, false);        \
      else if (n_edges <= 64) LAUNCH(64, false);   \
      else LAUNCH(128, false);                     \
  }

template <bool VEC>
void launch_fwd(const float* vals, long long n, const float* edges, int n_edges,
                const float* sigma, float* partials, int* counter, int grid, float* counts,
                cudaStream_t s) {
#define MGT_FWD(M, X) \
  erf_fwd_kernel<M, X, VEC><<<grid, kThreads, 0, s>>>(vals, n, edges, n_edges, sigma, partials, counter, counts)
  MGT_BY_EDGES(MGT_FWD)
#undef MGT_FWD
}

template <bool VEC>
void launch_bwd(const float* vals, long long n, const float* edges, int n_edges,
                const float* sigma, const float* g, float* dv, float* de, float* ds,
                float* partials, int* counter, int grid, cudaStream_t s) {
#define MGT_BWD(M, X)                                                                        \
  erf_bwd_kernel<M, X, VEC><<<grid, kThreads, 0, s>>>(vals, n, edges, n_edges, sigma, g, dv, \
                                                      de, ds, partials, counter)
  MGT_BY_EDGES(MGT_BWD)
#undef MGT_BWD
}

}  // namespace

extern "C" {

// Forward: counts (n_edges - 1,) from vals (n,), edges (n_edges,) and
// sigma: a device scalar, or (n,) when vec_sigma is nonzero.  partials is
// a scratch buffer of at least grid * (n_edges - 1) floats; counter an
// int that is 0 before the launch and is 0 again after it.  2 <= n_edges
// <= 128.  One launch; returns cudaGetLastError().
int erf_counts_fwd(const float* vals, long long n, const float* edges, int n_edges,
                   const float* sigma, int vec_sigma, float* partials, int* counter, int grid,
                   float* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_sigma) launch_fwd<true>(vals, n, edges, n_edges, sigma, partials, counter, grid, counts, s);
  else launch_fwd<false>(vals, n, edges, n_edges, sigma, partials, counter, grid, counts, s);
  return static_cast<int>(cudaGetLastError());
}

// Backward, for the counts' cotangent g (n_edges - 1,): dv (n,) and de
// (n_edges,), scaled; ds (n,) with vec_sigma, else (1,).  partials is a
// scratch buffer of at least grid * (n_edges + 1) floats; counter as for
// the forward.  One launch; returns cudaGetLastError().
int erf_counts_bwd(const float* vals, long long n, const float* edges, int n_edges,
                   const float* sigma, int vec_sigma, const float* g, float* dv, float* de,
                   float* ds, float* partials, int* counter, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_sigma) launch_bwd<true>(vals, n, edges, n_edges, sigma, g, dv, de, ds, partials, counter, grid, s);
  else launch_bwd<false>(vals, n, edges, n_edges, sigma, g, dv, de, ds, partials, counter, grid, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
