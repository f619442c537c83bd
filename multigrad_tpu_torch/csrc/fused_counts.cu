// Fused (windowed) erf-CDF binned counts: forward and backward kernels for
// Hopper, one launch each.
//
// Replaces the Pallas TPU kernels of multigrad_tpu/ops/pallas_kernels.py:
//   * _make_fused_fwd_kernel (the forward, launched by _fused_masses_fwd)
//   * _make_fused_bwd_kernel (the backward, launched by _fused_masses_bwd)
// in both their scalar-sigma and per-particle-sigma (VEC) variants, and
// with them the work the JAX package leaves to XLA around those kernels:
// the window start (binned.window_starts, a searchsorted), the scatter of
// the masses into bins (binned.scatter_bin_masses) and, in the backward,
// the gather of the counts' cotangent into the window and the transpose
// of the edge-window gather.  Built with nvcc into a shared library with
// a plain C interface and loaded with ctypes
// (multigrad_tpu_torch/ops/fused_kernels.py).
//
// Each particle i evaluates the cdf at only the W consecutive edges that
// start at s_i, the last edge <= v_i - SAT_Z*sqrt(2)*sigma_i clipped to
// [0, E - W], and adds its W - 1 masses
//   m_w = cdf((e[s_i + w + 1] - v_i) inv_i) - cdf((e[s_i + w] - v_i) inv_i)
// into bins s_i + w.  The backward recomputes P = exp(-z^2) with the
// window-local h_w = gm[w - 1] - gm[w], gm[w] = dcounts[s_i + w] for
// w < W - 1 and gm[-1] = gm[W - 1] = 0 (as the TPU kernel forms it from
// the masses' cotangent), and
//   dv_i     = -(inv_i / sqrt(pi)) sum_w h_w P_w
//   dsigma_i = -(1 / (sigma_i sqrt(pi))) sum_w h_w P_w z_w   (summed over i
//                                                             for a scalar)
//   dedges[s_i + w] += (inv_i / sqrt(pi)) h_w P_w            (if asked)
//
// What bounds them on an H100.  The forward reads v and sigma (4 or 8
// bytes a particle) and writes E - 1 counts; it issues ~41 warp-
// instructions a cdf (the uncontracted Horner steps and the IEEE
// division of erf_common.cuh) at W cdfs a particle, plus a binary search
// of log2(E) steps and W - 1 shared-memory adds: at W = 33 about 1,500
// instructions a particle, so instruction issue bounds it, not bytes
// (~0.045 ms at 1e6 particles over 528 sub-partitions at 1.98 GHz).  The
// backward reads v and sigma and writes dv and dsigma (16 bytes a
// particle with VEC) and issues ~16 instructions a slot: issue-bound too.
//
// Design, against that:
//   * No (W-1, N) masses and no (W, N) cotangents in device memory: the
//     search, the masses, the scatter and (backward) the gather all stay
//     on chip.  The edges, and the counts' cotangent, sit in shared memory.
//   * The scatter without atomics, in a fixed order.  Per-thread columns:
//     s_hist[bin][threadIdx.x]; thread t adds its masses to its own column
//     (bank t mod 32: no conflicts), and after the particle loop each bin
//     is summed over the threads in a fixed order (a warp a bin) into the
//     block's row of a (grid, cols) partials buffer.  Where the columns do
//     not fit in shared memory even at 32 threads a block (beyond ~1,770
//     bins), per-warp rows: each lane writes its masses to a per-lane
//     scratch, the lanes that share a start are found by __match_any_sync
//     and add into the warp's row one rank at a time, in lane order, so no
//     two lanes touch one address in one step.  The last block to finish,
//     elected by a ticket (erf_common.cuh::last_block), sums the rows in a
//     fixed order and writes the outputs.  No atomic touches a sum: for a
//     given N every output is the same bit for bit on every run.
//   * The window start is found in the kernel as window_starts finds it:
//     x = v - fl(5.656854f * sigma), rounded as PyTorch rounds it (no FMA
//     contraction), then an upper bound by the predicate !(x < e), as
//     torch.searchsorted(right=True) uses it.  The start is the plain
//     version's, integer for integer.
//   * One launch per call, on the grid the caller gives
//     (ops/fused_kernels.py::fused_grid, the rule of every one-launch
//     kernel).  The backward's block size is the one its edge histogram
//     would take whether or not dedges is asked, and a scalar sigma's sum
//     is added up in its own pass of the last block: dv and dsigma are
//     the same bit for bit with and without dedges.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "erf_common.cuh"

namespace {

using namespace erfk;

// SAT_Z * sqrt(2) and sqrt(2) / sqrt(pi) as float32, as PyTorch rounds the
// Python doubles 4.0 * 1.4142135623730951 and 1.4142135623730951 *
// 0.5641895835477563 when it multiplies a float32 tensor by them.
constexpr float kHalfZ = 5.656854249492381f;
constexpr float kSqrt2InvSqrtPi = 0.7978845608028654f;
// Shared memory left for the kernels' static arrays.
constexpr int kStaticSmem = 1024;

enum Layout { kNone = 0, kCols = 1, kRows = 2 };

// Floats rounded up to a multiple of 4 (16-byte aligned regions).
__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// The window start of ops/binned.py::window_starts for a clipped value v.
__device__ __forceinline__ int window_start(const float* s_edges, int n_edges, int window,
                                            float v, float sigma) {
  const float x = __fsub_rn(v, __fmul_rn(kHalfZ, sigma));
  // Upper bound: the count of edges e with !(x < e), in log2(E) steps.
  int base = 0, len = n_edges;
  while (len > 1) {
    const int half = len >> 1;
    if (!(x < s_edges[base + half])) base += half;
    len -= half;
  }
  const int count = base + (x < s_edges[base] ? 0 : 1);
  return min(max(count - 1, 0), n_edges - window);
}

// The W - 1 masses of one particle whose window starts at ew:
// emit(w, m_w) for w in [0, window - 1).
template <typename Emit>
__device__ __forceinline__ void particle_masses(const float* ew, float v, float inv, int window,
                                                Emit emit) {
  float prev = norm_cdf((ew[0] - v) * inv);
#pragma unroll 4
  for (int w = 1; w < window; ++w) {
    const float cur = norm_cdf((ew[w] - v) * inv);
    emit(w - 1, cur - prev);
    prev = cur;
  }
}

// One slot of the backward: h_w = g_prev - g_cur from the window's
// cotangents, then dv += h P, hz += h P z and emit(w, (inv / sqrt(pi)) h P).
template <bool DE, typename Emit>
__device__ __forceinline__ void grad_slot(int w, float g_cur, const float* ew, float v, float inv,
                                          float c, float& g_prev, float& dv, float& hz, Emit emit) {
  const float h = g_prev - g_cur;
  g_prev = g_cur;
  const float z = (ew[w] - v) * inv;
  const float hp = h * expf(-(z * z));
  dv += hp;
  hz += hp * z;
  if (DE) emit(w, c * hp);
}

// The window's W slots: gm[w] = gw[w] for w < W - 1, and the last slot's
// gm[W - 1] = 0 taken out of the loop (no select in the loop's slots).
// A slot is ~16 instructions, so the loop's own compare, branch and
// increments weigh: unrolled by 8 it ran 5% faster than by 4 on an H100,
// and within 3-6% of a loop unrolled whole for a window fixed at compile
// time (tools/fused_kernels_ab.py).
template <bool DE, typename Emit>
__device__ __forceinline__ void particle_grads(const float* ew, const float* gw, float v, float inv,
                                               int window, float& dv, float& hz, Emit emit) {
  const float c = inv * kInvSqrtPi;
  float g_prev = 0.0f;
  dv = hz = 0.0f;
#pragma unroll 8
  for (int w = 0; w < window - 1; ++w) grad_slot<DE>(w, gw[w], ew, v, inv, c, g_prev, dv, hz, emit);
  grad_slot<DE>(window - 1, 0.0f, ew, v, inv, c, g_prev, dv, hz, emit);
}

// Per-warp rows: add each active lane's `slots` values (its scratch,
// scr[k * 32]) into row[s + k], the lanes that share s one rank at a time
// in lane order, a __syncwarp between steps (a lane's next address may be
// one that another lane wrote in this step).  Every lane of the warp calls
// this; inactive lanes pass a key no other lane has.
__device__ __forceinline__ void warp_rows_add(float* row, const float* scr, int s, bool active,
                                              int slots) {
  const int lane = threadIdx.x & 31;
  const int key = active ? s : -1 - lane;
  const unsigned group = __match_any_sync(0xffffffffu, key);
  const int rank = __popc(group & ((1u << lane) - 1u));
  const int rounds = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(rank))) + 1;
  __syncwarp();
  for (int r = 0; r < rounds; ++r) {
    const bool mine = active && rank == r;
    for (int k = 0; k < slots; ++k) {
      if (mine) row[s + k] += scr[k * 32];
      __syncwarp();
    }
  }
}

// The block's sums of each of `nrows` histogram rows into partials row
// blockIdx.x (columns [0, nrows) of `cols`), in a fixed order.  Columns:
// s_hist[r * T + t], a warp a row, each lane over threads lane, lane + 32,
// ..., then the warp's shuffle tree.  Rows: s_hist[k * nrows + r] over the
// warps k in order.
template <int LAYOUT>
__device__ __forceinline__ void hist_to_partials(const float* s_hist, int nrows, int cols,
                                                 float* partials) {
  const int T = blockDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = T >> 5;
  float* out = partials + static_cast<long long>(blockIdx.x) * cols;
  if (LAYOUT == kCols) {
    for (int r = warp; r < nrows; r += warps) {
      const float* row = s_hist + static_cast<long long>(r) * T;
      float x = 0.0f;
      for (int t = lane; t < T; t += 32) x += row[t];
      x = warp_sum(x);
      if (lane == 0) out[r] = x;
    }
  } else if (LAYOUT == kRows) {
    for (int r = threadIdx.x; r < nrows; r += T) {
      float x = 0.0f;
      for (int k = 0; k < warps; ++k) x += s_hist[k * nrows + r];
      out[r] = x;
    }
  }
}

// In the last block: the sum of each column c < cols of partials (rows
// of ld floats) over the rows, in a fixed order that depends on rows,
// cols and the block size alone, handed to done(c, sum).  With fewer
// columns than threads, lanes = T / cols threads share a column (rows l,
// l + lanes, ...; neighbouring threads read neighbouring floats) and
// thread c adds its column's lanes in order through `scratch` (T floats
// of shared memory).  __ldcg reads through L2, where the other blocks'
// rows are.
template <typename Done>
__device__ __forceinline__ void column_sums(const float* partials, int rows, int ld, int cols,
                                            float* scratch, Done done) {
  const int T = blockDim.x;
  if (cols >= T) {
    for (int c = threadIdx.x; c < cols; c += T) {
      float s = 0.0f;
      for (int r = 0; r < rows; ++r) s += __ldcg(partials + static_cast<long long>(r) * ld + c);
      done(c, s);
    }
    return;
  }
  const int lanes = T / cols;
  const int c = threadIdx.x % cols, l = threadIdx.x / cols;
  float x = 0.0f;
  if (l < lanes) {
#pragma unroll 8
    for (int r = l; r < rows; r += lanes) x += __ldcg(partials + static_cast<long long>(r) * ld + c);
  }
  scratch[threadIdx.x] = x;
  __syncthreads();
  if (threadIdx.x < cols) {
    float s = 0.0f;
    for (int j = 0; j < lanes; ++j) s += scratch[j * cols + threadIdx.x];
    done(threadIdx.x, s);
  }
}

// counts (n_edges - 1,) of vals (n,) for a scalar sigma (sigma[0]) or a
// per-particle one (VEC).  Dynamic shared memory: the edges, then the
// histogram (LAYOUT kCols: (E - 1) x T; kRows: (E - 1) per warp and a
// (W - 1) x 32 scratch per warp).
template <bool VEC, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
fused_counts_fwd_kernel(const float* __restrict__ vals, long long n,
                        const float* __restrict__ edges, int n_edges,
                        const float* __restrict__ sigma, int window, float* __restrict__ partials,
                        int* __restrict__ counter, float* __restrict__ counts) {
  extern __shared__ float smem[];
  const int T = blockDim.x, nb = n_edges - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = T >> 5;
  float* s_edges = smem;
  float* s_hist = smem + pad4(n_edges);
  const int hist = LAYOUT == kCols ? nb * T : warps * nb;
  for (int e = threadIdx.x; e < n_edges; e += T) s_edges[e] = edges[e];
  for (int k = threadIdx.x; k < hist; k += T) s_hist[k] = 0.0f;
  __syncthreads();
  const float sig_s = VEC ? 0.0f : sigma[0];
  const float inv_s = VEC ? 0.0f : inv_of(sig_s);
  float* col = s_hist + threadIdx.x;                             // kCols
  float* row = s_hist + warp * nb;                               // kRows
  float* scr = s_hist + warps * nb + warp * (window - 1) * 32 + lane;   // kRows

  const long long stride = static_cast<long long>(gridDim.x) * T;
  for (long long base = static_cast<long long>(blockIdx.x) * T + warp * 32; base < n;
       base += stride) {
    const long long i = base + lane;
    const bool active = i < n;
    int s = 0;
    if (active) {
      const float v = clip_pad(vals[i]);
      const float sg = VEC ? sigma[i] : sig_s;
      const float inv = VEC ? inv_of(sg) : inv_s;
      s = window_start(s_edges, n_edges, window, v, sg);
      if (LAYOUT == kCols) {
        float* c = col + s * T;
        particle_masses(s_edges + s, v, inv, window, [&](int w, float m) { c[w * T] += m; });
      } else {
        particle_masses(s_edges + s, v, inv, window, [&](int w, float m) { scr[w * 32] = m; });
      }
    }
    if (LAYOUT == kRows) warp_rows_add(row, scr, s, active, window - 1);
  }
  __syncthreads();
  hist_to_partials<LAYOUT>(s_hist, nb, nb, partials);
  if (!last_block(counter)) return;
  column_sums(partials, gridDim.x, nb, nb, s_hist, [&](int c, float x) { counts[c] = x; });
  if (threadIdx.x == 0) *counter = 0;
}

// dv (n,), ds ((n,) with VEC, else (1,)) and, with DE, dedges (n_edges,)
// for the counts' cotangent g (n_edges - 1,), all scaled.  Dynamic shared
// memory: the edges, g, then with DE the edge histogram (kCols: E x T;
// kRows: E per warp and a W x 32 scratch per warp).  Partials columns:
// [0, E) the edge sums with DE, then with a scalar sigma sum h P z.
template <bool VEC, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
fused_counts_bwd_kernel(const float* __restrict__ vals, long long n,
                        const float* __restrict__ edges, int n_edges,
                        const float* __restrict__ sigma, int window, const float* __restrict__ g,
                        float* __restrict__ dv_out, float* __restrict__ de_out,
                        float* __restrict__ ds_out, float* __restrict__ partials,
                        int* __restrict__ counter) {
  constexpr bool DE = LAYOUT != kNone;
  extern __shared__ float smem[];
  __shared__ float s_warp[kWarps];
  const int T = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = T >> 5;
  float* s_edges = smem;
  float* s_g = smem + pad4(n_edges);
  float* s_hist = s_g + pad4(n_edges - 1);
  const int hist = LAYOUT == kCols ? n_edges * T : (LAYOUT == kRows ? warps * n_edges : 0);
  for (int e = threadIdx.x; e < n_edges; e += T) {
    s_edges[e] = edges[e];
    if (e < n_edges - 1) s_g[e] = g[e];
  }
  for (int k = threadIdx.x; k < hist; k += T) s_hist[k] = 0.0f;
  __syncthreads();
  const float sig_s = VEC ? 0.0f : sigma[0];
  const float inv_s = VEC ? 0.0f : inv_of(sig_s);
  float* col = s_hist + threadIdx.x;                             // kCols
  float* row = s_hist + warp * n_edges;                          // kRows
  float* scr = s_hist + warps * n_edges + warp * window * 32 + lane;   // kRows

  float hpz = 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * T;
  for (long long base = static_cast<long long>(blockIdx.x) * T + warp * 32; base < n;
       base += stride) {
    const long long i = base + lane;
    const bool active = i < n;
    int s = 0;
    if (active) {
      const float v = clip_pad(vals[i]);
      const float sg = VEC ? sigma[i] : sig_s;
      const float inv = VEC ? inv_of(sg) : inv_s;
      s = window_start(s_edges, n_edges, window, v, sg);
      float dv, hz;
      if (LAYOUT == kCols) {
        float* c = col + s * T;
        particle_grads<DE>(s_edges + s, s_g + s, v, inv, window, dv, hz,
                           [&](int w, float x) { c[w * T] += x; });
      } else {
        particle_grads<DE>(s_edges + s, s_g + s, v, inv, window, dv, hz,
                           [&](int w, float x) { scr[w * 32] = x; });
      }
      // As fused_masses_bwd_plain rounds them.
      dv_out[i] = -(inv * kInvSqrtPi) * dv;
      if (VEC) ds_out[i] = -((inv * kSqrt2InvSqrtPi) * hz);
      else hpz += hz;
    }
    if (LAYOUT == kRows) warp_rows_add(row, scr, s, active, window);
  }
  const int cols = (DE ? n_edges : 0) + (VEC ? 0 : 1);
  if (cols == 0) return;
  if (!VEC) {
    hpz = warp_sum(hpz);
    if (lane == 0) s_warp[warp] = hpz;
  }
  __syncthreads();
  hist_to_partials<LAYOUT>(s_hist, n_edges, cols, partials);
  if (!VEC && threadIdx.x == 0) {
    float x = 0.0f;
    for (int k = 0; k < warps; ++k) x += s_warp[k];
    partials[static_cast<long long>(blockIdx.x) * cols + cols - 1] = x;
  }
  if (!last_block(counter)) return;
  if (DE) {
    column_sums(partials, gridDim.x, cols, n_edges, s_hist, [&](int c, float x) { de_out[c] = x; });
    __syncthreads();
  }
  // The scalar sigma's column in a pass of its own, in the order of the
  // launch without dedges; its factor -(1 / (sigma sqrt(pi))) applied as
  // -(sum * inv) * (sqrt(2) / sqrt(pi)).
  if (!VEC)
    column_sums(partials + cols - 1, gridDim.x, cols, 1, s_hist,
                [&](int, float x) { ds_out[0] = -((x * inv_s) * kSqrt2InvSqrtPi); });
  if (threadIdx.x == 0) *counter = 0;
}

// ---------------------------------------------------------------------------
// Host side: the launch plan.
// ---------------------------------------------------------------------------
constexpr int kMaxDevices = 64;

// The current device and the shared memory a block may opt into on it
// (cached per device).
cudaError_t current_device(int* dev, int* optin) {
  static int optins[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& o = optins[*dev];
  if (!o) cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  *optin = o;
  return o > 0 ? cudaSuccess : cudaErrorInvalidDevice;
}

// Raise a kernel instance's dynamic shared memory limit on device dev,
// once (`raised`: a bit a device).
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<unsigned long long>& raised, int dev, int optin) {
  const unsigned long long bit = 1ull << dev;
  if (raised.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin - kStaticSmem);
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

struct Plan {
  int layout;   // kNone, kCols or kRows
  int threads;  // a block
  int bytes;    // dynamic shared memory a block
};

// The layout and block size for `fixed` floats of shared inputs and a
// histogram of `hist_rows` rows, `slots` scratch floats a lane in the
// per-warp-row layout.  Per-thread columns at the most threads (256 down
// to 32) that fit; else per-warp rows with as many warps as fit.
bool plan_for(int fixed, int hist_rows, int slots, int optin, Plan* plan) {
  const long long budget = static_cast<long long>(optin) - kStaticSmem;
  for (int t = kThreads; t >= 32; t >>= 1) {
    const long long bytes = 4LL * (fixed + static_cast<long long>(hist_rows) * t);
    if (bytes <= budget) {
      *plan = {kCols, t, static_cast<int>(bytes)};
      return true;
    }
  }
  const long long per_warp = 4LL * (hist_rows + slots * 32);
  long long warps = (budget - 4LL * fixed) / per_warp;
  if (warps < 1) return false;
  if (warps > kWarps) warps = kWarps;
  *plan = {kRows, static_cast<int>(warps * 32),
           static_cast<int>(4LL * fixed + warps * per_warp)};
  return true;
}

// Whether `grid` blocks of `cols` partials columns fit in partials_cap
// floats (cols 0: no partials).
bool grid_fits(int grid, int cols, long long partials_cap) {
  return grid >= 1 && static_cast<long long>(grid) * cols <= partials_cap;
}

template <bool VEC, int LAYOUT>
int fwd_instance(const float* vals, long long n, const float* edges, int n_edges,
                 const float* sigma, int window, float* partials, int* counter, float* counts,
                 int grid, cudaStream_t s, int dev, int optin, const Plan& plan) {
  static std::atomic<unsigned long long> raised{0};
  auto kernel = fused_counts_fwd_kernel<VEC, LAYOUT>;
  const cudaError_t err = allow_smem(kernel, raised, dev, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, plan.threads, plan.bytes, s>>>(vals, n, edges, n_edges, sigma, window, partials,
                                                counter, counts);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, int LAYOUT>
int bwd_instance(const float* vals, long long n, const float* edges, int n_edges,
                 const float* sigma, int window, const float* g, float* dv, float* de, float* ds,
                 float* partials, int* counter, int grid, cudaStream_t s, int dev, int optin,
                 const Plan& plan) {
  static std::atomic<unsigned long long> raised{0};
  auto kernel = fused_counts_bwd_kernel<VEC, LAYOUT>;
  const cudaError_t err = allow_smem(kernel, raised, dev, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, plan.threads, plan.bytes, s>>>(vals, n, edges, n_edges, sigma, window, g, dv, de,
                                                ds, partials, counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Forward: counts (n_edges - 1,) from vals (n,), edges (n_edges,), sigma
// (a device scalar, or (n,) when vec_sigma is nonzero) and the window (2
// <= window <= min(128, n_edges)), on `grid` blocks.  partials is a
// scratch buffer of partials_cap floats, at least grid * (n_edges - 1);
// counter an int that is 0 before the launch and is 0 again after it.
// One launch; returns a CUDA error code (0: launched).
int fused_counts_fwd(const float* vals, long long n, const float* edges, int n_edges,
                     const float* sigma, int vec_sigma, int window, float* partials,
                     long long partials_cap, int* counter, int grid, float* counts,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev, optin;
  const cudaError_t err = current_device(&dev, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan plan;
  if (!plan_for(pad4(n_edges), n_edges - 1, window - 1, optin, &plan) ||
      !grid_fits(grid, n_edges - 1, partials_cap))
    return static_cast<int>(cudaErrorInvalidValue);
#define MGT_FWD(VEC, LAYOUT)                                                                      \
  return fwd_instance<VEC, LAYOUT>(vals, n, edges, n_edges, sigma, window, partials, counter,     \
                                   counts, grid, s, dev, optin, plan)
  if (plan.layout == kRows) {
    if (vec_sigma) MGT_FWD(true, kRows);
    MGT_FWD(false, kRows);
  }
  if (vec_sigma) MGT_FWD(true, kCols);
  MGT_FWD(false, kCols);
#undef MGT_FWD
}

// Backward, for the counts' cotangent g (n_edges - 1,): dv (n,) and ds
// ((n,) with vec_sigma, else (1,)), scaled; dedges (n_edges,) unless it is
// null.  grid, partials (at least grid * (n_edges + 1) floats),
// partials_cap and counter as for the forward.  The block size and the
// order of every sum but dedges' do not depend on whether dedges is
// asked.  One launch; returns a CUDA error code (0: launched).
int fused_counts_bwd(const float* vals, long long n, const float* edges, int n_edges,
                     const float* sigma, int vec_sigma, int window, const float* g, float* dv,
                     float* dedges, float* ds, float* partials, long long partials_cap,
                     int* counter, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev, optin;
  const cudaError_t err = current_device(&dev, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fixed = pad4(n_edges) + pad4(n_edges - 1);
  Plan plan;
  const int cols = (dedges ? n_edges : 0) + (vec_sigma ? 0 : 1);
  if (!plan_for(fixed, n_edges, window, optin, &plan) || !grid_fits(grid, cols, partials_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!dedges) plan = {kNone, plan.threads, 4 * (fixed + plan.threads)};
#define MGT_BWD(VEC, LAYOUT)                                                                      \
  return bwd_instance<VEC, LAYOUT>(vals, n, edges, n_edges, sigma, window, g, dv, dedges, ds,     \
                                   partials, counter, grid, s, dev, optin, plan)
  if (plan.layout == kRows) {
    if (vec_sigma) MGT_BWD(true, kRows);
    MGT_BWD(false, kRows);
  }
  if (plan.layout == kCols) {
    if (vec_sigma) MGT_BWD(true, kCols);
    MGT_BWD(false, kCols);
  }
  if (vec_sigma) MGT_BWD(true, kNone);
  MGT_BWD(false, kNone);
#undef MGT_BWD
}

}  // extern "C"
