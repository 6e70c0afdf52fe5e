// Single-swaption LMM path kernels: the discounted payoff of one payer
// swaption on every path of the spot-measure NORMAL LIBOR market model, the
// "fast revaluation" of a calibrated model.
//
// Replaces two Pallas kernels, each in its two variants:
//   * finmath_tpu/ops/lmm_kernel.py::_lmm_kernel (pallas_call sites :141,
//     lmm_swaption_kernel, with the on-core PRNG, and :351,
//     lmm_swaption_kernel_with_normals, on injected normals): one factor,
//       dL_i = lam_i (sum_{j=s+1..i} delta_j lam_j / (1 + delta_j L_j) dt
//              + sqrt_dt z),   lam_i = volT[i, s] for i >= s + 1,
//     no clamp (the Pallas kernel has none);
//   * finmath_tpu/ops/lmm_stochvol_kernel.py::_sv_kernel (sites :157,
//     lmm_stochvol_swaption_kernel, and :362, ..._with_normals): F <= 8
//     factors, blended local volatility times sqrt(V),
//       lam_{i,f} = volT[f, i, s] ((1 - b) L_i + b L_i(0)) sqrt(V),
//       dL_i = sum_f lam_{i,f} (sum_{j=s+1..i} m_j lam_{j,f}) dt
//              + sum_f lam_{i,f} sqrt_dt z_f,   m_j = delta_j / (1 + delta_j L_j),
//     L clamped to +-1e3, V carried MULTIPLICATIVELY as in the Pallas kernel
//     (:104-107; not the log V of lmm_stochvol_products.cu):
//       V *= expf(nu sqrt_dt (rho z_0 + sqrt(1 - rho^2) z_F) - nu^2 dt / 2),
//     capped at 1e6, the new V used from the next step on.
// Every step first accrues the spot numeraire over the period's own accrual
// fraction, N *= 1 + delta_s L_s. After num_steps steps the payoff is read
// over [exercise, exercise + periods): max(1 - P_end - K A, 0) / N, with
// P_end and A the swap's end bond and annuity off the curve.
//
// Normals: each kernel is a template on its source. Row r of a path's
// stream is normal r of its Philox stream (philox.cuh: draw r / 4,
// component r % 4), or z[r * num_paths + path] of an injected block (one
// coalesced load per row). Rows are consumed step-major: step s for one
// factor, s * (F + 1) + f for the stoch-vol kernel (the factors, then the
// normal of V), exactly the injected variants' layout; so a PRNG launch
// equals the injected launch fed with its own stream bit for bit. The
// TPU's random bits cannot be reproduced: the two packages share the path
// arithmetic (tested on injected normals), not the stream.
//
// Arithmetic: float32, every operation written with the explicit-rounding
// intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn) and the accurate sqrtf and
// expf (no --use_fast_math), so that nvcc contracts nothing into an FMA and
// a launch reproduces the plain PyTorch version's float32 operations (ops/
// lmm_kernel.py, ops/lmm_stochvol_kernel.py) on the card bit for bit. The
// spot drift's prefix sum is a sequential running sum over the alive
// libors (the Pallas kernel's Hillis-Steele scan was a Mosaic layout
// device; its order of additions differs, so the two packages agree to
// rounding, not bitwise).
//
// What bounds it: the payoff reads the curve up to the swap's last period,
// and libor i evolves from libors j <= i only, so the libors above the
// swap's end (and above the last step's fixing) reach neither N nor the
// payoff. A launch sweeps the libors below that cut alone, `swept` of the
// curve's n, a run-time argument (ops/_swaption_paths.py::swept_libors: 30
// of 80 and 30 of 40 at the main path), and the plain versions sweep them
// all, with the same payoffs bit for bit. At 409,600 paths, e = 10, m = 20,
// that is 245 alive (step, libor) pairs a path: about 2.4k float32
// operations a path at one factor (9 an alive libor a step) and 12.2k at
// five (47 an alive libor a step), plus 744 and 3,720 for the PRNG
// variants' Philox and Box-Muller: about 0.019 and 0.097 ms at the
// published 67 TFLOP/s (which counts an FMA as two; these kernels issue
// none, so an add or a multiply issues at half that rate). The bytes are
// the 1.6 MB of payoffs, and for the injected variants the normals read
// once (16 MB and 98 MB). So they are bound by issue: every instruction
// that is not one of those operations (loads, index arithmetic, the
// divide's Newton steps and its slow-path check, branches) costs time.
//
// Design for Hopper. Both kernels: one thread a path in blocks of 128; a
// block first stages its table into shared memory with bulk asynchronous
// copies (TMA) on an mbarrier (lmm_sweep::stage), packed by the wrapper
// (ops/_swaption_paths.py::pack_table): per libor (L0, delta) or (L0,
// delta, blend L0, 0) of the K libors of the curve, and the loadings
// step-major [S][C][NP][V] (3.8 KB at the 1-factor main path, 10.8 KB at
// the stoch-vol one); the launchers refuse a table cp.async.bulk cannot
// copy. The scalars are launch arguments. Each (K, F) instantiation, K the
// libors of the curve and F the factors, is its own library built with -D
// defines at first use (ops/_swaption_paths.py::pricer_variant).
//   * One factor: the curve lives in shared memory, a column of `swept`
//     floats a thread ([swept][128], sized at launch: 15 KB at the main
//     path), swept by a rolled loop over the alive libors i = s + 1 ..
//     swept - 1, 25-28 SASS instructions an alive libor, the IEEE divide
//     most of them. K sets only the table's layout: K = the model's
//     libors, one library a model. A curve in registers, the libors
//     unrolled at compile time, was no faster at 30 libors and lost
//     24-32% at 80, where its 80 registers of curve spilled (PERF.md).
//   * Stoch vol: the curve lives in registers, float L[K], K the swept
//     libors rounded up to 8 (at most the model's; a model has a few
//     libraries, not one a swaption shape: the registers of 10 unswept
//     libors cost 12-18%), the libors unrolled at compile time and the
//     rows at or below the step or at or above `swept` skipped by
//     warp-uniform branches; F is exact, so a
//     row issues its F loadings, running sums and shocks and no predicated
//     slot; a row reads its constants and its C vectors of loadings at an
//     immediate offset. The payoff reads the register curve over
//     [exercise, exercise + periods) with warp-uniform branches too; cp
//     and ann change on the swap's rows only, so the order of operations
//     is the plain version's. Chunks of 2-8 rows with masks bought nothing
//     (each IEEE divide ends its row's code in a slow-path branch anyway),
//     and two paths a thread lost 13-44% (PERF.md).
//   * Blocks of 128 threads, at least 5 an SM (ptxas caps a thread at 102
//     registers). Only the float32 payoff / N of each path is written; the
//     wrappers take the float64 mean. The registers, spills, blocks an SM
//     and waves of each launcher are printed by
//     tools/compare_pricer_kernels.py and recorded in PERF.md.
// No tensor cores (the factor contractions have depth F <= 8 inside a
// per-path recurrence), no fast math, no FMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lmm_sweep.cuh"
#include "philox.cuh"

namespace {

constexpr int K = LMM_K;                 // libors of the curve
constexpr int F = LMM_F;
constexpr int kThreads = 128;            // threads (paths) a block
// the blocks an SM asked of ptxas: a floor of 640 resident threads, which
// caps a thread at 102 registers
constexpr int kMinBlocks = 5;
constexpr int kNP = lmm_sweep::kNP;
constexpr int kFP = lmm_sweep::kFP;
// floats of one (step, libor)'s loadings in the staged table
constexpr int kCV = lmm_sweep::kC * lmm_sweep::kV;

// Floats of a staged table with `columns` per-libor constants and S steps
// of loadings (ops/_swaption_paths.py::pack_table).
__host__ __device__ constexpr int table_width(int columns, int S) {
  return columns * kNP + S * kCV * kNP;
}

// Row r of a path's normal stream: Philox (kInjected false) or the
// injected block z [rows, num_paths] (kInjected true), consumed in order.
template <bool kInjected>
struct NormalRows {
  const float* z;
  long long num_paths;
  unsigned long long seed;
  uint32_t path;
  int row;
  float4 draw;

  __device__ __forceinline__ float next() {
    if constexpr (kInjected) {
      return z[static_cast<long long>(row++) * num_paths + path];
    } else {
      const int k = row & 3;
      if (k == 0) draw = philox::normals4(seed, path, row >> 2);
      ++row;
      return k == 0 ? draw.x : k == 1 ? draw.y : k == 2 ? draw.z : draw.w;
    }
  }
};

// The path of this thread.
__device__ __forceinline__ long long this_path() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

// max(1 - P_end - K A, 0) / N from the swap's end bond cp and annuity ann,
// NaN kept.
__device__ __forceinline__ float payoff_over_numeraire(float cp, float ann,
                                                       float strike,
                                                       float N) {
  float payoff = __fsub_rn(__fsub_rn(1.0f, cp), __fmul_rn(strike, ann));
  payoff = (payoff < 0.0f) ? 0.0f : payoff;
  return __fdiv_rn(payoff, N);
}

// One factor. Table: per libor (L0, delta), then the loadings [S][NP]; the
// curve L [swept][kThreads] follows it in shared memory.
template <bool kInjected>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lmm_swaption_paths_kernel(float* __restrict__ payoff,
                          const float* __restrict__ z, int num_paths,
                          unsigned long long seed,
                          const float* __restrict__ packed, float dt,
                          float sqrt_dt, float strike, int swept, int S,
                          int exercise, int periods) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* set = reinterpret_cast<float*>(smem_raw + 16);
  const int width = table_width(2, S);
  lmm_sweep::stage(set, packed, static_cast<unsigned>(width) * sizeof(float),
                   bar);
  const long long path = this_path();
  if (path >= num_paths) return;
  const float2* cst = reinterpret_cast<const float2*>(set);      // [kNP]
  float* L = set + width + threadIdx.x;            // L[i * kThreads]

  NormalRows<kInjected> rows{z, num_paths, seed,
                             static_cast<uint32_t>(path), 0,
                             make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int i = 0; i < swept; ++i) L[i * kThreads] = cst[i].x;
  float N = 1.0f;
  for (int s = 0; s < S; ++s) {
    const float w = __fmul_rn(sqrt_dt, rows.next());
    N = __fmul_rn(N, __fadd_rn(1.0f, __fmul_rn(cst[s].y, L[s * kThreads])));
    const float* lam_s = set + 2 * kNP + s * kNP;                // [kNP]
    float prefix = 0.0f;
    for (int i = s + 1; i < swept; ++i) {
      const float d = cst[i].y;
      const float lam = lam_s[i];
      const float Li = L[i * kThreads];
      prefix = __fadd_rn(prefix, __fdiv_rn(__fmul_rn(d, lam),
                                           __fadd_rn(1.0f, __fmul_rn(d, Li))));
      L[i * kThreads] = __fadd_rn(
          Li, __fmul_rn(lam, __fadd_rn(__fmul_rn(prefix, dt), w)));
    }
  }
  float cp = 1.0f;
  float ann = 0.0f;
  for (int i = exercise; i < exercise + periods; ++i) {
    const float d = cst[i].y;
    cp = __fmul_rn(cp, __fdiv_rn(1.0f, __fadd_rn(1.0f,
                                                 __fmul_rn(d, L[i * kThreads]))));
    ann = __fadd_rn(ann, __fmul_rn(cp, d));
  }
  payoff[path] = payoff_over_numeraire(cp, ann, strike, N);
}

// Stoch vol. Table: per libor (L0, delta, blend L0, 0), then the loadings
// [S][C][NP][V]; somega = sqrt(1 - rho^2). The curve is in registers.
template <bool kInjected>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lmm_stochvol_swaption_paths_kernel(
    float* __restrict__ payoff, const float* __restrict__ z, int num_paths,
    unsigned long long seed, const float* __restrict__ packed, float dt,
    float sqrt_dt, float strike, float blend, float nu, float rho,
    float somega, int swept, int S, int exercise, int periods) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* set = reinterpret_cast<float*>(smem_raw + 16);
  lmm_sweep::stage(set, packed,
                   static_cast<unsigned>(table_width(4, S)) * sizeof(float),
                   bar);
  const long long path = this_path();
  if (path >= num_paths) return;
  const float one_minus_blend = __fsub_rn(1.0f, blend);
  const float v_drift = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, nu), nu), dt);
  const float4* cst = reinterpret_cast<const float4*>(set);      // [kNP]
  const float* tab = set + 4 * kNP;                  // [S][kC][kNP][kV]

  NormalRows<kInjected> rows{z, num_paths, seed,
                             static_cast<uint32_t>(path), 0,
                             make_float4(0.f, 0.f, 0.f, 0.f)};
  float L[K];
#pragma unroll
  for (int r = 0; r < K; ++r) L[r] = cst[r].x;
  float N = 1.0f;
  float V = 1.0f;
  for (int s = 0; s < S; ++s) {
    // rows s * (F + 1) .. s * (F + 1) + F: the factors, then V's normal
    float w[F];
    float z0 = 0.0f, z_v = 0.0f;
#pragma unroll
    for (int f = 0; f <= F; ++f) {
      const float zf = rows.next();
      if (f == 0) z0 = zf;
      if (f < F) {
        w[f] = __fmul_rn(sqrt_dt, zf);
      } else {
        z_v = zf;
      }
    }
    N = __fmul_rn(N, __fadd_rn(1.0f, __fmul_rn(cst[s].y,
                                               lmm_sweep::libor_at(L, s))));
    const float sqrt_v = sqrtf(V);
    float run[F];                        // running sums of m_j lambda_j
#pragma unroll
    for (int f = 0; f < F; ++f) run[f] = 0.0f;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (r <= s || r >= swept) continue;                  // warp-uniform
      const float4 c = cst[r];
      float v[kFP];
      lmm_sweep::load_loadings(tab, s, r, v);
      const float Li = L[r];
      const float m = __fdiv_rn(c.y, __fadd_rn(1.0f, __fmul_rn(c.y, Li)));
      const float lf = __fmul_rn(
          __fadd_rn(__fmul_rn(one_minus_blend, Li), c.z), sqrt_v);
      float mu = 0.0f;
      float diffusion = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float lam = __fmul_rn(v[f], lf);
        run[f] = __fadd_rn(run[f], __fmul_rn(m, lam));
        mu = __fadd_rn(mu, __fmul_rn(lam, run[f]));
        diffusion = __fadd_rn(diffusion, __fmul_rn(lam, w[f]));
      }
      L[r] = lmm_sweep::clamp_keep_nan(
          __fadd_rn(__fadd_rn(Li, __fmul_rn(mu, dt)), diffusion), -1.0e3f,
          1.0e3f);
    }
    const float dw_v = __fmul_rn(
        sqrt_dt, __fadd_rn(__fmul_rn(rho, z0), __fmul_rn(somega, z_v)));
    V = lmm_sweep::min_keep_nan(
        __fmul_rn(V, expf(__fsub_rn(__fmul_rn(nu, dw_v), v_drift))), 1.0e6f);
  }
  float cp = 1.0f;
  float ann = 0.0f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (r < exercise || r >= exercise + periods) continue;  // warp-uniform
    const float d = cst[r].y;
    cp = __fmul_rn(cp, __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(d, L[r]))));
    ann = __fadd_rn(ann, __fmul_rn(cp, d));
  }
  payoff[path] = payoff_over_numeraire(cp, ann, strike, N);
}

// Checks the shape and the table, sizes shared memory (the table, then
// `curve_floats` a thread) and launches one thread a path on `stream`;
// returns the launch's error. The kernel sweeps libors 0 .. swept - 1 of
// the n = K it is given: the wrappers pass those up to the swap's last
// period and the last step's fixing (ops/_swaption_paths.py::swept_libors).
template <typename Kernel, typename... Scalars>
cudaError_t launch(Kernel kernel, int columns, int curve_floats,
                   float* payoff, const float* z, int num_paths,
                   unsigned long long seed, const float* packed, int width,
                   int n, int swept, int S, int exercise, int periods,
                   cudaStream_t stream, Scalars... scalars) {
  if (num_paths < 1 || n != K || S < 1 || swept < S || swept > n ||
      exercise < 0 || periods < 1 || exercise + periods > swept ||
      width != table_width(columns, S) ||
      !lmm_sweep::stageable(packed, width)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem =
      16 + (static_cast<size_t>(width) +
            static_cast<size_t>(curve_floats) * kThreads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (num_paths + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      payoff, z, num_paths, seed, packed, scalars..., swept, S, exercise,
      periods);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The instantiation of this library: K, F for which = 0, 1.
int lmm_swaption_paths_variant(int which) {
  const int v[2] = {K, F};
  return (which >= 0 && which < 2) ? v[which] : -1;
}

// Each launcher launches on `stream` without synchronising and returns the
// launch's error; `payoff` receives num_paths floats, `packed` is the
// staged table of `width` floats for n = K libors, of which the first
// `swept` are swept. The 1-factor launchers exist in the F = 1 builds only
// (elsewhere they refuse).
cudaError_t lmm_swaption_paths_launch(float* payoff, int num_paths,
                                      unsigned long long seed,
                                      const float* packed, int width,
                                      float dt, float sqrt_dt, float strike,
                                      int n, int swept, int S, int exercise,
                                      int periods, cudaStream_t stream) {
#if LMM_F == 1
  return launch(lmm_swaption_paths_kernel<false>, 2, swept, payoff, nullptr,
                num_paths, seed, packed, width, n, swept, S, exercise,
                periods, stream, dt, sqrt_dt, strike);
#else
  return cudaErrorInvalidValue;
#endif
}

cudaError_t lmm_swaption_paths_normals_launch(
    float* payoff, const float* z, int num_paths, const float* packed,
    int width, float dt, float sqrt_dt, float strike, int n, int swept,
    int S, int exercise, int periods, cudaStream_t stream) {
#if LMM_F == 1
  if (z == nullptr) return cudaErrorInvalidValue;
  return launch(lmm_swaption_paths_kernel<true>, 2, swept, payoff, z,
                num_paths, 0ull, packed, width, n, swept, S, exercise,
                periods, stream, dt, sqrt_dt, strike);
#else
  return cudaErrorInvalidValue;
#endif
}

cudaError_t lmm_stochvol_swaption_paths_launch(
    float* payoff, int num_paths, unsigned long long seed,
    const float* packed, int width, float dt, float sqrt_dt, float strike,
    float blend, float nu, float rho, float somega, int n, int num_factors,
    int swept, int S, int exercise, int periods, cudaStream_t stream) {
  if (num_factors != F) return cudaErrorInvalidValue;
  return launch(lmm_stochvol_swaption_paths_kernel<false>, 4, 0, payoff,
                nullptr, num_paths, seed, packed, width, n, swept, S,
                exercise, periods, stream, dt, sqrt_dt, strike, blend, nu,
                rho, somega);
}

cudaError_t lmm_stochvol_swaption_paths_normals_launch(
    float* payoff, const float* z, int num_paths, const float* packed,
    int width, float dt, float sqrt_dt, float strike, float blend, float nu,
    float rho, float somega, int n, int num_factors, int swept, int S,
    int exercise, int periods, cudaStream_t stream) {
  if (z == nullptr || num_factors != F) return cudaErrorInvalidValue;
  return launch(lmm_stochvol_swaption_paths_kernel<true>, 4, 0, payoff, z,
                num_paths, 0ull, packed, width, n, swept, S, exercise,
                periods, stream, dt, sqrt_dt, strike, blend, nu, rho,
                somega);
}

const char* lmm_swaption_paths_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
