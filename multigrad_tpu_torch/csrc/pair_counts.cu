// Weighted pair counts: the forward, the row-side gradient and the column
// sweep, for Hopper.
//
// Replaces the Pallas TPU kernels of multigrad_tpu/ops/pallas_kernels.py:
//   * _make_pair_fwd_kernel (the forward, launched by _pair_fwd) and
//   * _make_pair_bwd_kernel (the weight gradient, launched by
//     _pair_bwd_rowgrad for _pair_bwd),
// with the separations of _pair_sep_block.  Built with nvcc into a shared
// library with a plain C interface and loaded with ctypes
// (multigrad_tpu_torch/ops/pair_kernels.py).
//
//   counts_b = sum_ij w1_i w2_j [esq_b <= sep2_ij < esq_{b+1}] (and |pi| < pimax)
//   R_bi     = sum_j w2_j [pair ij in bin b]        (the forward's row sums)
//   dw1_i    = sum_j G_ij w2_j = sum_b g_b R_bi,  G_ij = sum_b g_b [pair ij in bin b]
//
// sep2 is the squared 3D separation, or r_p^2 over (x, y) with the cut
// |dz| < pimax when projected; with a box, each coordinate difference takes
// the periodic minimum image d - box * rint(d / box).
//
// Numerics.  One ulp in sep2 moves a pair on a bin edge into the next bin,
// so sep2 must equal the plain PyTorch version's bit for bit: rintf (half to
// even, like torch.round and jnp.round) of the IEEE quotient, and
// __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into an
// FMA, in the order (dx^2 + dy^2) + dz^2.  The squared edges come in
// already squared by PyTorch.  The masks then agree with the plain
// version's exactly and the counts differ only in the order of the float32
// sums.  No atomics: the forward adds per-block partial rows in a fixed
// order (erfk::sum_rows_kernel), so it is bit-identical on repeat.
//
// The minimum image without a division.  For |d| <= box, fl(|d| / box) <= 1,
// so rint(fl(d / box)) is 0 or +-1, and +-1 exactly when fl(|d| / box) > 0.5
// (half rounds to even, to 0).  IEEE division is monotone in d, so the
// least float32 thr with fl(thr / box) > 0.5, found once per launch on the
// host by stepping (pair_kernels.min_image_threshold), decides it:
// |d| >= thr gives d - copysign(box, d), else d.  That is the division's
// result bit for bit but for the sign of a zero d, which the square and
// |dz| drop, so sep2 and the pi cut are unchanged.  Both positions in
// [0, box] bound |d| by box; the kernels test that once per row and once
// per tile of columns, and a pair with a position outside the box (which
// the models' catalogs never hold) takes the division, min_image_far, kept
// out of line so that the near loop has none of its instructions.
//
// What bounds them on an H100: the work is O(N1 N2) pairs on O(N) bytes, so
// the forward and the sweep are bound by the FP32 pipes.  Per pair, counted
// from this source: 3 differences; with a box, per coordinate |d|, a
// compare and a subtract (9); the squares and sums (3 projected, 5 in 3D);
// the projected cut (|dz|, compare: 2); the range test against the
// smallest and largest squared edge (2).  That is 19 operations for a
// projected or a 3D pair with a box, 10 without one.  A pair inside the
// range (a small share of all pairs at the configurations the models run)
// adds, per bin, two compares and a predicated add (3).  The row gradient
// reads R once and writes dw1 once: bound by bytes.
//
// Design: one thread owns one row i (a block of kThreads rows).  The block
// stages the columns j through shared memory in tiles of kThreads, as
// (x, y, z, w) float4s that every thread reads in turn (a broadcast, one
// 16-byte load a pair).  A pair outside [min esq, max esq) or outside the
// pi cut is skipped after the range test; a pair inside adds w2_j to the
// accumulator of its bin with a predicated add per bin.  The accumulators
// are registers, unrolled to a compile-time bound MAXB, so no dynamic
// register indexing spills to local memory.  The forward writes them, as
// R, bin-major so that a warp's stores coalesce, when asked; then it
// multiplies them by w1_i and reduces them over the block
// (erfk::block_rows).  The backward of one block's pairs is then an O(N B)
// pass, pair_rowgrad_kernel, with no pair sweep.  Only the column side of
// a cross-correlation, dw2_j = sum_i w1_i G_ij, needs one: pair_bwd_kernel
// runs the forward's sweep with the two sides swapped and ends with
// dw_i = sum_b g_b acc_b, so it needs no cross-block sum either.
//
// Compiled code: the division's MUFU.RCP lives only in min_image_far, out
// of every kernel's loops; PERF.md quotes nvcc -Xptxas -v (registers and
// spills of each instantiation) and cuobjdump -sass (MUFU.RCP and
// instructions per loop) for this source on sm_90a.
#include "erf_common.cuh"

namespace {

using erfk::kThreads;
using erfk::kWarps;

constexpr int kTile = kThreads;  // columns staged per shared-memory tile
constexpr int kMaxBins = 128;

__device__ __forceinline__ bool in_box(float x, float box) {
  return x >= 0.0f && x <= box;  // false for NaN
}

// d - box * rint(d / box) for any d, by the IEEE division.
__device__ __noinline__ float min_image_far(float d, float box) {
  return __fsub_rn(d, __fmul_rn(box, rintf(__fdiv_rn(d, box))));
}

// The minimum image of d; NEAR promises |d| <= box (see the note above).
template <bool BOX, bool NEAR>
__device__ __forceinline__ float min_image(float d, float box, float thr) {
  if (!BOX) return d;
  if (!NEAR) return min_image_far(d, box);
  return fabsf(d) >= thr ? __fsub_rn(d, copysignf(box, d)) : d;
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

// Stage columns [j0, j0 + kTile) of pos (n, 3) and w as (x, y, z, w);
// return whether every one of them lies in [0, box]^3 (always, without a
// box).
template <bool BOX>
__device__ __forceinline__ bool load_tile(const float* __restrict__ pos,
                                          const float* __restrict__ w,
                                          long long n, long long j0, float box,
                                          float4* s_tile) {
  __syncthreads();  // every thread is done with the previous tile
  const long long j = j0 + threadIdx.x;
  bool near = true;
  if (j < n) {
    const float4 c = make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], w[j]);
    s_tile[threadIdx.x] = c;
    if (BOX) near = in_box(c.x, box) && in_box(c.y, box) && in_box(c.z, box);
  }
  return __syncthreads_and(near) != 0;
}

// Add the row's pairs with the m staged columns to acc, bin by bin.
template <int MAXB, bool BOX, bool PROJ, bool NEAR>
__device__ __forceinline__ void sweep_tile(const float4* s_tile, int m, float xi,
                                           float yi, float zi, float box,
                                           float thr, float pimax,
                                           const float* s_esq, int nb, float lo,
                                           float hi, float (&acc)[MAXB]) {
#pragma unroll 4
  for (int t = 0; t < m; ++t) {
    const float4 c = s_tile[t];
    const float dx = min_image<BOX, NEAR>(__fsub_rn(xi, c.x), box, thr);
    const float dy = min_image<BOX, NEAR>(__fsub_rn(yi, c.y), box, thr);
    const float dz = min_image<BOX, NEAR>(__fsub_rn(zi, c.z), box, thr);
    float s = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    bool ok = true;
    if (PROJ) {
      ok = fabsf(dz) < pimax;
    } else {
      s = __fadd_rn(s, __fmul_rn(dz, dz));
    }
    if (ok && s >= lo && s < hi) {
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < nb && s >= s_esq[b] && s < s_esq[b + 1]) acc[b] += c.w;
      }
    }
  }
}

// acc[b] = sum_j w2_j [pair (i, j) in bin b] for this thread's row i of p1
// (zeros past the last row), columns in order.
template <int MAXB, bool BOX, bool PROJ>
__device__ __forceinline__ void row_bin_sums(
    const float* __restrict__ p1, long long n1, const float* __restrict__ p2,
    const float* __restrict__ w2, long long n2, const float* __restrict__ esq,
    int n_edges, float box, float thr, float pimax, float* s_esq,
    float4* s_tile, float (&acc)[MAXB]) {
  float lo, hi;
  load_edges(esq, n_edges, s_esq, lo, hi);
  const int nb = n_edges - 1;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool row = i < n1;
  const float xi = row ? p1[3 * i] : 0.0f;
  const float yi = row ? p1[3 * i + 1] : 0.0f;
  const float zi = row ? p1[3 * i + 2] : 0.0f;
  const bool row_near = in_box(xi, box) && in_box(yi, box) && in_box(zi, box);
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] = 0.0f;

  for (long long j0 = 0; j0 < n2; j0 += kTile) {
    const bool tile_near = load_tile<BOX>(p2, w2, n2, j0, box, s_tile);
    const int m = (int)(n2 - j0 < kTile ? n2 - j0 : kTile);
    if (!BOX || (row_near && tile_near)) {
      sweep_tile<MAXB, BOX, PROJ, true>(s_tile, m, xi, yi, zi, box, thr, pimax,
                                        s_esq, nb, lo, hi, acc);
    } else {
      sweep_tile<MAXB, BOX, PROJ, false>(s_tile, m, xi, yi, zi, box, thr, pimax,
                                         s_esq, nb, lo, hi, acc);
    }
  }
}

template <int MAXB, bool BOX, bool PROJ>
__global__ void __launch_bounds__(kThreads)
pair_fwd_kernel(const float* __restrict__ p1, const float* __restrict__ w1,
                long long n1, const float* __restrict__ p2,
                const float* __restrict__ w2, long long n2,
                const float* __restrict__ esq, int n_edges, float box,
                float thr, float pimax, float* __restrict__ rows,
                float* __restrict__ partials) {
  __shared__ float s_esq[MAXB + 1];
  __shared__ float4 s_tile[kTile];
  __shared__ float s_warp[kWarps][MAXB];
  float acc[MAXB];
  row_bin_sums<MAXB, BOX, PROJ>(p1, n1, p2, w2, n2, esq, n_edges, box, thr,
                                pimax, s_esq, s_tile, acc);
  const int nb = n_edges - 1;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool row = i < n1;
  if (rows != nullptr && row) {
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < nb) rows[b * n1 + i] = acc[b];
    }
  }
  const float wi = row ? w1[i] : 0.0f;
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] *= wi;
  erfk::block_rows<MAXB>(acc, nb, s_warp, partials);
}

// dw1_i = sum_b g_b R_bi, bins in order: one thread per row.
__global__ void __launch_bounds__(kThreads)
pair_rowgrad_kernel(const float* __restrict__ rows, long long n1,
                    const float* __restrict__ g, int nb,
                    float* __restrict__ dw1) {
  __shared__ float s_g[kMaxBins];
  for (int b = threadIdx.x; b < nb; b += blockDim.x) s_g[b] = g[b];
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n1) return;
  float dw = 0.0f;
#pragma unroll 8
  for (int b = 0; b < nb; ++b) dw = fmaf(s_g[b], rows[b * n1 + i], dw);
  dw1[i] = dw;
}

// dw1_i = sum_b g_b acc_b of the forward's sweep (the column side of a
// cross-correlation, launched with the two sides swapped).
template <int MAXB, bool BOX, bool PROJ>
__global__ void __launch_bounds__(kThreads)
pair_bwd_kernel(const float* __restrict__ p1, long long n1,
                const float* __restrict__ p2, const float* __restrict__ w2,
                long long n2, const float* __restrict__ esq, int n_edges,
                const float* __restrict__ g, float box, float thr, float pimax,
                float* __restrict__ dw1) {
  __shared__ float s_esq[MAXB + 1];
  __shared__ float s_g[MAXB];
  __shared__ float4 s_tile[kTile];
  const int nb = n_edges - 1;
  // The barrier in load_edges (row_bin_sums) covers s_g too.
  for (int b = threadIdx.x; b < nb; b += blockDim.x) s_g[b] = g[b];
  float acc[MAXB];
  row_bin_sums<MAXB, BOX, PROJ>(p1, n1, p2, w2, n2, esq, n_edges, box, thr,
                                pimax, s_esq, s_tile, acc);
  float dw = 0.0f;
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b < nb) dw = fmaf(s_g[b], acc[b], dw);
  }
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n1) dw1[i] = dw;
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
    else MGT_PAIR_FLAGS(KERNEL, kMaxBins, __VA_ARGS__);                      \
  } while (0)

}  // namespace

extern "C" {

// Forward: counts (n_edges - 1,) of pos1 (n1, 3), w1 (n1,) against pos2
// (n2, 3), w2 (n2,), for the squared edges esq (n_edges,), 2 <= n_edges <=
// 129; thr is min_image_threshold(box) when use_box.  rows, when not
// null, receives R (n_edges - 1, n1).  partials is a (grid, n_edges - 1)
// scratch buffer, grid = ceil(n1 / 256) (at least 1).  Returns
// cudaGetLastError() after both launches.
int pair_counts_fwd(const float* p1, const float* w1, long long n1,
                    const float* p2, const float* w2, long long n2,
                    const float* esq, int n_edges, float box, float thr,
                    int use_box, float pimax, int projected, float* rows,
                    float* partials, int grid, float* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n_edges - 1;
  MGT_PAIR(pair_fwd_kernel, p1, w1, n1, p2, w2, n2, esq, n_edges, box, thr,
           pimax, rows, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  erfk::sum_rows_kernel<<<nb, kThreads, 0, s>>>(partials, grid, nb, counts);
  return static_cast<int>(cudaGetLastError());
}

// Row gradient: dw1 (n1,) = g (nb,) . R (nb, n1), 1 <= nb <= 128; grid =
// ceil(n1 / 256) (at least 1).  Returns cudaGetLastError().
int pair_rowgrad(const float* rows, long long n1, const float* g, int nb,
                 float* dw1, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_rowgrad_kernel<<<grid, kThreads, 0, s>>>(rows, n1, g, nb, dw1);
  return static_cast<int>(cudaGetLastError());
}

// The sweep: dw1 (n1,) = G . w2 for the cotangent g (n_edges - 1,) of the
// counts; grid = ceil(n1 / 256) (at least 1).  Returns cudaGetLastError().
int pair_counts_bwd(const float* p1, long long n1, const float* p2,
                    const float* w2, long long n2, const float* esq,
                    int n_edges, const float* g, float box, float thr,
                    int use_box, float pimax, int projected, float* dw1,
                    int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n_edges - 1;
  MGT_PAIR(pair_bwd_kernel, p1, n1, p2, w2, n2, esq, n_edges, g, box, thr,
           pimax, dw1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
