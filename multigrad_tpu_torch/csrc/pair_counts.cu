// Weighted pair counts: forward and backward kernels for Hopper.
//
// Replaces the Pallas TPU kernels of multigrad_tpu/ops/pallas_kernels.py:
//   * _make_pair_fwd_kernel (the forward, launched by _pair_fwd) and
//   * _make_pair_bwd_kernel (the row-side weight gradient, launched by
//     _pair_bwd_rowgrad for _pair_bwd),
// with the separations of _pair_sep_block.  Built with nvcc into a shared
// library with a plain C interface and loaded with ctypes
// (multigrad_tpu_torch/ops/pair_kernels.py).
//
//   counts_b = sum_ij w1_i w2_j [esq_b <= sep2_ij < esq_{b+1}] (and |pi| < pimax)
//   dw1_i    = sum_j G_ij w2_j,   G_ij = sum_b g_b [pair ij in bin b]
//
// sep2 is the squared 3D separation, or r_p^2 over (x, y) with the cut
// |dz| < pimax when projected; with a box, each coordinate difference takes
// the periodic minimum image d - box * rint(d / box).
//
// Numerics.  One ulp in sep2 moves a pair on a bin edge into the next bin,
// so sep2 must equal the plain PyTorch version's bit for bit: an IEEE
// division (__fdiv_rn), rintf (half to even, like torch.round and
// jnp.round), and __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never
// contracts into an FMA, in the order (dx^2 + dy^2) + dz^2.  The squared
// edges come in already squared by PyTorch.  The masks then agree with the
// plain version's exactly and the counts differ only in the order of the
// float32 sums.  No atomics: the forward adds per-block partial rows in a
// fixed order (erfk::sum_rows_kernel), so it is bit-identical on repeat.
//
// What bounds them on an H100: the work is O(N1 N2) pairs on O(N) bytes, so
// both are bound by the FP32 pipes.  Per pair, counted from this source:
// 3 differences; with a box, per coordinate a division, rintf, a multiply
// and a subtract (12); the squares and sums (3 projected, 5 in 3D); the
// projected cut (|dz|, compare: 2); the range test against the smallest
// and largest squared edge (2).  That is 22 operations for a projected or a
// 3D pair with a box, 10 without one.  A pair inside the range (a small
// share of all pairs at the configurations the models run) adds, per bin,
// two compares and a predicated add (3), and in the backward one
// multiply-add for dw (1).  The IEEE division counts as one operation here
// but issues several instructions.
//
// Design: one thread owns one row i (a block of kThreads rows).  The block
// stages the columns j through shared memory in tiles of kThreads, as SoA
// x, y, z, w, and every thread walks the tile (a broadcast read).  A pair
// outside [min esq, max esq) or outside the pi cut is skipped after the
// range test; a pair inside adds w2_j to the accumulator of its bin with a
// predicated add per bin.  The accumulators are registers, unrolled to a
// compile-time bound MAXB, so no dynamic register indexing spills to local
// memory.  The forward multiplies them by w1_i at the end and reduces them
// over the block (erfk::block_rows); the backward weights each pair by
// g_b from shared memory and writes dw1_i itself, so it needs no
// cross-block reduction.  dw2 is the same backward with the two sides
// swapped, launched by the wrapper (skipped for an autocorrelation).
#include "erf_common.cuh"

namespace {

using erfk::kThreads;
using erfk::kWarps;

constexpr int kTile = kThreads;  // columns staged per shared-memory tile

template <bool BOX>
__device__ __forceinline__ float min_image(float d, float box) {
  if (!BOX) return d;
  return __fsub_rn(d, __fmul_rn(box, rintf(__fdiv_rn(d, box))));
}

// Squared separation of the pair (r_p^2 when PROJ) and whether it passes
// the projected cut.
template <bool BOX, bool PROJ>
__device__ __forceinline__ float sep_sq(float xi, float yi, float zi, float xj,
                                        float yj, float zj, float box,
                                        float pimax, bool& ok) {
  const float dx = min_image<BOX>(__fsub_rn(xi, xj), box);
  const float dy = min_image<BOX>(__fsub_rn(yi, yj), box);
  const float dz = min_image<BOX>(__fsub_rn(zi, zj), box);
  const float s = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  if (PROJ) {
    ok = fabsf(dz) < pimax;
    return s;
  }
  ok = true;
  return __fadd_rn(s, __fmul_rn(dz, dz));
}

// Stage the squared edges in shared memory; [lo, hi) is the range outside
// which a pair falls in no bin (min and max over the edges, so that edges
// in any order give the plain version's masks).
__device__ __forceinline__ void load_edges(const float* __restrict__ esq,
                                           int n_edges, float* s_esq,
                                           float& lo, float& hi) {
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) s_esq[e] = esq[e];
  __syncthreads();
  lo = s_esq[0];
  hi = s_esq[0];
  for (int e = 1; e < n_edges; ++e) {
    lo = fminf(lo, s_esq[e]);
    hi = fmaxf(hi, s_esq[e]);
  }
}

// Stage columns [j0, j0 + kTile) of pos (n, 3) and w as SoA.
__device__ __forceinline__ void load_tile(const float* __restrict__ pos,
                                          const float* __restrict__ w,
                                          long long n, long long j0,
                                          float* s_x, float* s_y, float* s_z,
                                          float* s_w) {
  __syncthreads();  // every thread is done with the previous tile
  const long long j = j0 + threadIdx.x;
  if (j < n) {
    s_x[threadIdx.x] = pos[3 * j];
    s_y[threadIdx.x] = pos[3 * j + 1];
    s_z[threadIdx.x] = pos[3 * j + 2];
    s_w[threadIdx.x] = w[j];
  }
  __syncthreads();
}

template <int MAXB, bool BOX, bool PROJ>
__global__ void __launch_bounds__(kThreads)
pair_fwd_kernel(const float* __restrict__ p1, const float* __restrict__ w1,
                long long n1, const float* __restrict__ p2,
                const float* __restrict__ w2, long long n2,
                const float* __restrict__ esq, int n_edges, float box,
                float pimax, float* __restrict__ partials) {
  __shared__ float s_esq[MAXB + 1];
  __shared__ float s_x[kTile], s_y[kTile], s_z[kTile], s_w[kTile];
  __shared__ float s_warp[kWarps][MAXB];
  float lo, hi;
  load_edges(esq, n_edges, s_esq, lo, hi);
  const int nb = n_edges - 1;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool row = i < n1;
  const float xi = row ? p1[3 * i] : 0.0f;
  const float yi = row ? p1[3 * i + 1] : 0.0f;
  const float zi = row ? p1[3 * i + 2] : 0.0f;

  float acc[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] = 0.0f;

  for (long long j0 = 0; j0 < n2; j0 += kTile) {
    load_tile(p2, w2, n2, j0, s_x, s_y, s_z, s_w);
    const int m = (int)(n2 - j0 < kTile ? n2 - j0 : kTile);
    for (int t = 0; t < m; ++t) {
      bool ok;
      const float s = sep_sq<BOX, PROJ>(xi, yi, zi, s_x[t], s_y[t], s_z[t], box,
                                        pimax, ok);
      if (ok && s >= lo && s < hi) {
        const float w = s_w[t];
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b < nb && s >= s_esq[b] && s < s_esq[b + 1]) acc[b] += w;
        }
      }
    }
  }
  const float wi = row ? w1[i] : 0.0f;
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] *= wi;
  erfk::block_rows<MAXB>(acc, nb, s_warp, partials);
}

template <int MAXB, bool BOX, bool PROJ>
__global__ void __launch_bounds__(kThreads)
pair_bwd_kernel(const float* __restrict__ p1, long long n1,
                const float* __restrict__ p2, const float* __restrict__ w2,
                long long n2, const float* __restrict__ esq, int n_edges,
                const float* __restrict__ g, float box, float pimax,
                float* __restrict__ dw1) {
  __shared__ float s_esq[MAXB + 1];
  __shared__ float s_g[MAXB];
  __shared__ float s_x[kTile], s_y[kTile], s_z[kTile], s_w[kTile];
  const int nb = n_edges - 1;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) s_g[b] = g[b];
  float lo, hi;
  load_edges(esq, n_edges, s_esq, lo, hi);  // its barrier covers s_g too
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool row = i < n1;
  const float xi = row ? p1[3 * i] : 0.0f;
  const float yi = row ? p1[3 * i + 1] : 0.0f;
  const float zi = row ? p1[3 * i + 2] : 0.0f;

  float dw = 0.0f;
  for (long long j0 = 0; j0 < n2; j0 += kTile) {
    load_tile(p2, w2, n2, j0, s_x, s_y, s_z, s_w);
    const int m = (int)(n2 - j0 < kTile ? n2 - j0 : kTile);
    for (int t = 0; t < m; ++t) {
      bool ok;
      const float s = sep_sq<BOX, PROJ>(xi, yi, zi, s_x[t], s_y[t], s_z[t], box,
                                        pimax, ok);
      if (ok && s >= lo && s < hi) {
        float gp = 0.0f;  // G_ij, summed over bins in order
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b < nb && s >= s_esq[b] && s < s_esq[b + 1]) gp += s_g[b];
        }
        dw += gp * s_w[t];
      }
    }
  }
  if (row) dw1[i] = dw;
}

// Launch KERNEL<M, use_box, projected> with the given arguments.
#define MGT_PAIR_FLAGS(KERNEL, M, ...)                                       \
  do {                                                                       \
    if (use_box && projected)                                                \
      KERNEL<M, true, true><<<grid, kThreads, 0, s>>>(__VA_ARGS__);          \
    else if (use_box)                                                        \
      KERNEL<M, true, false><<<grid, kThreads, 0, s>>>(__VA_ARGS__);         \
    else if (projected)                                                      \
      KERNEL<M, false, true><<<grid, kThreads, 0, s>>>(__VA_ARGS__);         \
    else                                                                     \
      KERNEL<M, false, false><<<grid, kThreads, 0, s>>>(__VA_ARGS__);        \
  } while (0)

// ... with the smallest bin bound M >= nb.
#define MGT_PAIR(KERNEL, ...)                                                \
  do {                                                                       \
    if (nb <= 8) MGT_PAIR_FLAGS(KERNEL, 8, __VA_ARGS__);                     \
    else if (nb <= 16) MGT_PAIR_FLAGS(KERNEL, 16, __VA_ARGS__);              \
    else if (nb <= 32) MGT_PAIR_FLAGS(KERNEL, 32, __VA_ARGS__);              \
    else if (nb <= 64) MGT_PAIR_FLAGS(KERNEL, 64, __VA_ARGS__);              \
    else MGT_PAIR_FLAGS(KERNEL, 128, __VA_ARGS__);                           \
  } while (0)

}  // namespace

extern "C" {

// Forward: counts (n_edges - 1,) of pos1 (n1, 3), w1 (n1,) against pos2
// (n2, 3), w2 (n2,), for the squared edges esq (n_edges,), 2 <= n_edges <=
// 129.  partials is a (grid, n_edges - 1) scratch buffer, grid =
// ceil(n1 / 256) (at least 1).  Returns cudaGetLastError() after both
// launches.
int pair_counts_fwd(const float* p1, const float* w1, long long n1,
                    const float* p2, const float* w2, long long n2,
                    const float* esq, int n_edges, float box, int use_box,
                    float pimax, int projected, float* partials, int grid,
                    float* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n_edges - 1;
  MGT_PAIR(pair_fwd_kernel, p1, w1, n1, p2, w2, n2, esq, n_edges, box, pimax,
           partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  erfk::sum_rows_kernel<<<nb, kThreads, 0, s>>>(partials, grid, nb, counts);
  return static_cast<int>(cudaGetLastError());
}

// Backward, row side: dw1 (n1,) for the cotangent g (n_edges - 1,) of the
// counts; grid = ceil(n1 / 256) (at least 1).  Returns cudaGetLastError().
int pair_counts_bwd(const float* p1, long long n1, const float* p2,
                    const float* w2, long long n2, const float* esq,
                    int n_edges, const float* g, float box, int use_box,
                    float pimax, int projected, float* dw1, int grid,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n_edges - 1;
  MGT_PAIR(pair_bwd_kernel, p1, n1, p2, w2, n2, esq, n_edges, g, box, pimax,
           dw1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
