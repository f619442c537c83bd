// The history model's chunk: mean log10 M* at the observation epochs and
// its parameter gradient, forward and backward kernels for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves this block
// (multigrad_tpu/models/galhalo_hist.py, the mean log M* block) to XLA,
// which fuses it.  PyTorch runs it op by op: ≈70 launches a chunk in the
// forward, again in the checkpoint's recompute and ≈100 more in the
// backward, over (chunk, T) tensors, and a torch.cumsum over rows of T-1
// floats that ran at under 1% of the card's bandwidth.  Here each halo
// is one thread and its T values live in registers; only the (K, n)
// result is written (ops/hist_kernels.py, behind one autograd.Function).
//
// What it computes, per halo of z=0 mass lm (pad halos, lm > 100, give
// the sentinel 1e18 and no gradient), on the time grid t_j:
//   L_j   = lg_eff(logMh_j) + log10(F_B) + logMh_j + log10(max(D_j, 1e-30) ln10)
//   logMh_j = lm + alpha_j lam_j,  lam_j = log10(t_j / T0)
//   ref   = max_j L_j,  sfr_j = 10^(L_j - ref)
//   cum_c = sum_{j<=c} (sfr_j + sfr_{j+1}) dt_j / 2
//   out_k = ref + log10(max(cum_{o_k - 1}, 1e-30))
// with alpha_j, lam_j and D_j = d logMh/dt depending on the time and the
// parameters only: they are worked out once a block, into shared memory.
// Every step is the plain version's (models/galhalo_hist.py, the mean
// log M* block) in its order, each multiply and add rounded on its own
// (__fmul_rn, __fadd_rn: nvcc would contract them into FMAs, which
// PyTorch's separate ops never do), with the accurate expf, log10f,
// log1pf and exp10f (no fast math).  The running sum accumulates in
// double and rounds each partial sum to float, as PyTorch's CPU cumsum
// does: the sums are the CPU's bit for bit, given the same increments.
//
// The backward recomputes the halo and forms the exact derivative of
// those formulas.  The shift by ref cancels analytically where the
// integral's clamp is inactive (d out_k = sum_j w_kj sfr_j dL_j / cum),
// and is d L_{jmax} where it is active; a clamp of D_j zeroes that
// term's derivative, as torch.clamp's backward does.  Each block writes
// one row of the eight nonzero parameter sums to the partials buffer; a
// ticket picks the last block, which adds the rows in a fixed order
// (erf_common.cuh): repeated calls give the same bits.
//
// What bounds it on an H100.  Per halo and time step the forward
// evaluates expf twice, log1pf twice and exp10f once (≈100 issued
// instructions with the adds around them), and reads 4 bytes and writes
// 4K bytes a halo: at 1e6 halos, T = 16, ≈1.6e9 thread-instructions, or
// ≈50 us of issue on 528 sub-partitions at 1.98 GHz, against 5 us of
// bytes.  The backward does the forward's work and about as much again.
// Measured on an H100 80GB HBM3 at 700 W: 0.130 ms forward and 0.446 ms
// backward at 1e6 halos, T = 16, K = 3 (the backward at MAXT 16 holds
// 255 registers; a bound of two blocks an SM saved 4%, MAXT 32 cost 9%),
// both small beside the host's launch of the rest of the chunk.
#include "erf_common.cuh"

namespace {

using namespace erfk;

constexpr float kT0 = 13.8f;                   // galhalo_hist.T0_GYR
constexpr float kLn10 = 2.302585092994046f;    // galhalo_hist._LN10
constexpr float kLog10FB = -0.8068754076957703f;  // log10(F_BARYON = 0.156)
constexpr float kLn2 = 0.6931471805599453f;    // galhalo_hist._SOFTPLUS0
constexpr float kTiny = 1e-30f;                // the clamps' floor
constexpr float kPadOut = 1e18f;               // galhalo_hist._PAD_OUT
// Most time steps (registers: MAXT of 16, 32 or 64) and epochs a call
// takes (the observation columns go by value in the kernel's arguments,
// __grid_constant__, so a thread reads them from the constant bank);
// ops/hist_kernels.py sends larger shapes to the plain version.
constexpr int kMaxTimes = 64;
constexpr int kMaxEpochs = 64;
// The eight parameters the history depends on (sigma_0 and sigma_slope
// enter only the scatter): alpha_early, alpha_late, lg_tc, k_t,
// lgeps_max, logm_crit, eps_lo, eps_hi.
constexpr int kGrads = 8;
constexpr int kParams = 10;

struct Epochs {
  int k;                  // number of epochs
  int col[kMaxEpochs];    // cumulative-sum column of each: obs_index - 1
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// F.softplus (beta 1, threshold 20) of z, from e = expf(z).
__device__ __forceinline__ float softplus(float z, float e) {
  return z > 20.0f ? z : log1pf(e);
}

// What a block shares: the time-only terms, MAXT of each.
template <int MAXT>
struct TimeTerms {
  float alam[MAXT];   // alpha_j * lam_j
  float lgd[MAXT];    // log10(max(D_j, 1e-30) * ln10)
  float dt[MAXT];     // t_{j+1} - t_j (j < T - 1)
  float lam[MAXT];
  float dalpha[4][MAXT];  // d alpha_j / d (alpha_early, alpha_late, lg_tc, k_t)
  float dlgd[4][MAXT];    // d lgd_j / d the same (0 where the clamp holds)
};

// The parameters and the constants made of them, as the plain version
// forms them from 0-d float32 tensors.
struct Params {
  float ae, al, lg_tc, k_t, lgeps, crit, elo2, ehi2, ramp0, elo, ehi;
  __device__ explicit Params(const float* p) {
    ae = p[0];
    al = p[1];
    lg_tc = p[2];
    k_t = p[3];
    lgeps = p[4];
    crit = p[5];
    elo = p[6];
    ehi = p[7];
    elo2 = mul(elo, 0.5f);  // eps_lo / k, k = 2
    ehi2 = mul(ehi, 0.5f);
    ramp0 = mul(mul(add(elo, ehi), 0.5f), kLn2);  // (eps_lo + eps_hi) / k * ln 2
  }
};

// Threads j < T fill the time-only terms (with the derivatives when
// GRAD), in the plain version's order of operations.
template <int MAXT, bool GRAD>
__device__ __forceinline__ void time_terms(const float* __restrict__ t_grid, int T,
                                           const Params& p, TimeTerms<MAXT>& s) {
  const int j = threadIdx.x;
  if (j >= T) return;
  const float t = t_grid[j];
  const float lt = log10f(t);
  const float u = mul(p.k_t, sub(p.lg_tc, lt));
  const float sg = 1.0f / add(1.0f, expf(-u));               // torch.sigmoid
  const float de = sub(p.ae, p.al);
  const float alpha = add(p.al, mul(de, sg));                // mah_alpha
  const float lam = log10f(t / kT0);
  const float tl = mul(t, kLn10);
  const float om = sub(1.0f, sg);
  const float dadt = mul(mul(mul(-de, sg), om), p.k_t) / tl;  // _dlogmh_dt
  const float d = add(mul(lam, dadt), alpha / tl);
  const float dc = d < kTiny ? kTiny : d;                    // keeps NaN
  s.alam[j] = mul(alpha, lam);
  s.lgd[j] = log10f(mul(dc, kLn10));
  s.dt[j] = j + 1 < T ? sub(t_grid[j + 1], t) : 0.0f;
  s.lam[j] = lam;
  if (GRAD) {
    // alpha = al + de s, s = sigmoid(u), u = k_t (lg_tc - lg t);
    // D = lam dadt + alpha c, dadt = -de q k_t c, q = s (1 - s),
    // c = 1 / (t ln10); d lgd = dD / (D ln10) where D >= 1e-30.
    const float q = sg * om;
    const float c = 1.0f / tl;
    const float du_tc = p.k_t, du_k = sub(p.lg_tc, lt);
    const float dalpha_du = de * q;
    s.dalpha[0][j] = sg;
    s.dalpha[1][j] = om;
    s.dalpha[2][j] = dalpha_du * du_tc;
    s.dalpha[3][j] = dalpha_du * du_k;
    const float dd_du = -lam * de * p.k_t * c * q * (1.0f - 2.0f * sg) + c * dalpha_du;
    const float dd[4] = {-lam * q * p.k_t * c + sg * c, lam * q * p.k_t * c + om * c,
                         dd_du * du_tc, -lam * de * q * c + dd_du * du_k};
    const float scale = d >= kTiny ? 1.0f / (d * kLn10) : 0.0f;
#pragma unroll
    for (int m = 0; m < 4; ++m) s.dlgd[m][j] = dd[m] * scale;
  }
}

// L_j of one halo (lm already sanitized).
template <int MAXT>
__device__ __forceinline__ float lg_sfr(float lm, int j, const Params& p,
                                        const TimeTerms<MAXT>& s) {
  const float logmh = add(lm, s.alam[j]);
  const float lg_dmh = add(logmh, s.lgd[j]);
  const float x = sub(logmh, p.crit);
  const float zm = mul(-2.0f, x), zp = mul(2.0f, x);
  const float ramp = add(mul(p.elo2, softplus(zm, expf(zm))), mul(p.ehi2, softplus(zp, expf(zp))));
  const float lg_eff = sub(p.lgeps, sub(ramp, p.ramp0));
  return add(add(lg_eff, kLog10FB), lg_dmh);
}

// L (MAXT registers) of one halo and its row maximum (NaN if any L is;
// jmax the first index of the maximum).
template <int MAXT>
__device__ __forceinline__ float fill_l(float lm, int T, const Params& p,
                                        const TimeTerms<MAXT>& s, float (&l)[MAXT], int& jmax) {
  float ref = __int_as_float(0xff800000);  // -inf
  bool nan = false;
  jmax = 0;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    if (j < T) {
      l[j] = lg_sfr<MAXT>(lm, j, p, s);
      nan = nan || l[j] != l[j];
      if (l[j] > ref) {
        ref = l[j];
        jmax = j;
      }
    }
  }
  return nan ? __int_as_float(0x7fc00000) : ref;
}

// One increment of the cumulative trapezoid: (lo + hi) / 2 * dt.
__device__ __forceinline__ float trapezoid(float lo, float hi, float dt) {
  return mul(mul(0.5f, add(hi, lo)), dt);
}

template <int MAXT>
__global__ void __launch_bounds__(kThreads)
history_fwd_kernel(const float* __restrict__ lm0, long long n, const float* __restrict__ params,
                   const float* __restrict__ t_grid, int T, const __grid_constant__ Epochs ep,
                   float* __restrict__ out) {
  __shared__ TimeTerms<MAXT> s;
  const Params p(params);
  time_terms<MAXT, false>(t_grid, T, p, s);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float lm = lm0[i];
    if (lm > 100.0f) {
      for (int k = 0; k < ep.k; ++k) out[k * n + i] = kPadOut;
      continue;
    }
    float l[MAXT];
    int jmax;
    const float ref = fill_l<MAXT>(lm, T, p, s, l, jmax);
    double acc = 0.0;
    float prev = exp10f(sub(l[0], ref));
#pragma unroll
    for (int j = 0; j + 1 < MAXT; ++j) {
      if (j + 1 < T) {
        const float next = exp10f(sub(l[j + 1], ref));
        acc = __dadd_rn(acc, (double)trapezoid(prev, next, s.dt[j]));
        prev = next;
        const float cum = (float)acc;
        for (int k = 0; k < ep.k; ++k) {
          if (ep.col[k] == j) out[k * n + i] = add(ref, log10f(cum < kTiny ? kTiny : cum));
        }
      }
    }
  }
}

// d out / d params of the chunk for the cotangent g of out (n, K) with
// strides (gs_i, gs_k): 10 floats to grad (sigma_0 and sigma_slope 0).
template <int MAXT>
__global__ void __launch_bounds__(kThreads)
history_bwd_kernel(const float* __restrict__ lm0, long long n, const float* __restrict__ params,
                   const float* __restrict__ t_grid, int T, const __grid_constant__ Epochs ep,
                   const float* __restrict__ g, long long gs_i, long long gs_k,
                   float* __restrict__ partials, int* __restrict__ counter,
                   float* __restrict__ grad) {
  __shared__ TimeTerms<MAXT> s;
  __shared__ float s_warp[kWarps][kGrads];
  __shared__ float s_part[kThreads];
  const Params p(params);
  time_terms<MAXT, true>(t_grid, T, p, s);
  __syncthreads();
  float acc[kGrads];
#pragma unroll
  for (int m = 0; m < kGrads; ++m) acc[m] = 0.0f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float lm = lm0[i];
    if (lm > 100.0f) continue;  // pad: the plain version's where() zeroes it
    // The forward again: sfr in place of L, and per column c the weight
    // h_c = sum over the epochs read at c of g_k / cum_c (the clamped
    // ones' g go to the row maximum instead).
    float sfr[MAXT], h[MAXT];
    int jmax;
    const float ref = fill_l<MAXT>(lm, T, p, s, sfr, jmax);
    float at_max = 0.0f;
    double cum = 0.0;
    sfr[0] = exp10f(sub(sfr[0], ref));
#pragma unroll
    for (int j = 0; j < MAXT; ++j) h[j] = 0.0f;
#pragma unroll
    for (int j = 0; j + 1 < MAXT; ++j) {
      if (j + 1 < T) {
        sfr[j + 1] = exp10f(sub(sfr[j + 1], ref));
        cum = __dadd_rn(cum, (double)trapezoid(sfr[j], sfr[j + 1], s.dt[j]));
        const float cf = (float)cum;
        for (int k = 0; k < ep.k; ++k) {
          if (ep.col[k] == j) {
            const float gk = g[i * gs_i + k * gs_k];
            if (cf >= kTiny) h[j] += gk / cf;
            else at_max += gk;
          }
        }
      }
    }
    // F_c = sum_{c' >= c} h_c' (the cotangent of increment c), then the
    // weight of sfr_j: (dt_j F_j + dt_{j-1} F_{j-1}) / 2.
#pragma unroll
    for (int j = MAXT - 2; j >= 0; --j) h[j] += h[j + 1];
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      if (j < T) {
        float w = 0.0f;
        if (j + 1 < T) w += s.dt[j] * h[j];
        if (j > 0) w += s.dt[j - 1] * h[j - 1];
        const float a = 0.5f * w * sfr[j] + (j == jmax ? at_max : 0.0f);
        // dL_j / d params.  With x = logMh - logm_crit and R = d ramp /
        // dx = eps_hi sigmoid(2x) - eps_lo sigmoid(-2x): d/d lgeps_max 1,
        // d/d logm_crit R, d/d eps_lo (ln2 - softplus(-2x)) / 2, d/d
        // eps_hi (ln2 - softplus(2x)) / 2, and through logMh (1 - R)
        // lam_j d alpha_j plus d lgd_j for the accretion parameters.
        const float x = lm + s.alam[j] - p.crit;
        const float em = expf(-2.0f * x), epx = expf(2.0f * x);
        const float r = p.ehi / (1.0f + em) - p.elo / (1.0f + epx);
        acc[4] += a;
        acc[5] += a * r;
        acc[6] += a * 0.5f * (kLn2 - softplus(-2.0f * x, em));
        acc[7] += a * 0.5f * (kLn2 - softplus(2.0f * x, epx));
        const float b = a * (1.0f - r) * s.lam[j];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m] += b * s.dalpha[m][j] + a * s.dlgd[m][j];
      }
    }
  }

  block_rows<kGrads>(acc, kGrads, s_warp, partials);
  if (!last_block(counter)) return;
  // Each column over the rows, in a fixed order: thread t adds column t
  // % kGrads over rows t / kGrads, + lanes, ...; then thread c adds its
  // column's lanes in order.  __ldcg reads through L2.
  constexpr int lanes = kThreads / kGrads;
  const int c = threadIdx.x % kGrads, l = threadIdx.x / kGrads;
  float x = 0.0f;
#pragma unroll 8
  for (int r = l; r < (int)gridDim.x; r += lanes) x += __ldcg(partials + (long long)r * kGrads + c);
  s_part[threadIdx.x] = x;
  __syncthreads();
  if (threadIdx.x < kParams) {
    float sum = 0.0f;
    if (threadIdx.x < kGrads) {
      for (int j = 0; j < lanes; ++j) sum += s_part[j * kGrads + threadIdx.x];
    }
    grad[threadIdx.x] = sum;
  }
  if (threadIdx.x == 0) *counter = 0;
}

bool shape_ok(int T, int K) { return T >= 2 && T <= kMaxTimes && K >= 1 && K <= kMaxEpochs; }

Epochs epochs(const int* cols, int k) {
  Epochs e;
  e.k = k;
  for (int j = 0; j < k; ++j) e.col[j] = cols[j];
  return e;
}

// Instantiate LAUNCH(MAXT) for T time steps: registers for 16, 32 or 64.
#define MGT_BY_TIMES(LAUNCH) \
  if (T <= 16) LAUNCH(16);   \
  else if (T <= 32) LAUNCH(32); \
  else LAUNCH(64);

}  // namespace

extern "C" {

// Forward: out (K, n) from lm0 (n,), params (10,) and t_grid (T,) on the
// device; cols (K,) the cumulative columns (obs_index - 1) in host
// memory, passed by value.  2 <= T <= 64, 1 <= K <= 64.  One launch;
// returns cudaGetLastError().
int hist_history_fwd(const float* lm0, long long n, const float* params, const float* t_grid,
                     int T, const int* cols, int K, float* out, int grid, void* stream) {
  if (!shape_ok(T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epochs e = epochs(cols, K);
#define MGT_FWD(M) \
  history_fwd_kernel<M><<<grid, kThreads, 0, st>>>(lm0, n, params, t_grid, T, e, out)
  MGT_BY_TIMES(MGT_FWD)
#undef MGT_FWD
  return static_cast<int>(cudaGetLastError());
}

// Backward: grad (10,) for the cotangent g of out, read as g[i * gs_i +
// k * gs_k].  partials holds at least grid * 8 floats; counter an int
// that is 0 before the launch and is 0 again after it.  One launch;
// returns cudaGetLastError().
int hist_history_bwd(const float* lm0, long long n, const float* params, const float* t_grid,
                     int T, const int* cols, int K, const float* g, long long gs_i,
                     long long gs_k, float* partials, int* counter, int grid, float* grad,
                     void* stream) {
  if (!shape_ok(T, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epochs e = epochs(cols, K);
#define MGT_BWD(M)                                                                       \
  history_bwd_kernel<M><<<grid, kThreads, 0, st>>>(lm0, n, params, t_grid, T, e, g, gs_i, \
                                                   gs_k, partials, counter, grad)
  MGT_BY_TIMES(MGT_BWD)
#undef MGT_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
