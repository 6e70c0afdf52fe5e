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
// lmm_kernel.py, ops/lmm_stochvol_kernel.py) on the card. The spot drift's
// prefix sum is a sequential running sum over the alive libors (the Pallas
// kernel's Hillis-Steele scan was a Mosaic layout device; its order of
// additions differs, so the two packages agree to rounding, not bitwise).
//
// Design for Hopper: one thread is one path, a block kTile = 128 paths, the
// grid exactly covers num_paths (the tail masked), so no padded path enters
// the mean. Each thread's forward curve lives in shared memory as
// [n][kTile] floats (n = 80: 40 KB), thread t touching column t only (bank-
// conflict-free, no barriers); N, V, the running sums and the step's
// normals stay in registers. Only the float32 payoff / N of each path is
// written; the wrappers take the float64 mean.
//
// What bounds it: at 409,600 paths, e = 10, the 1-factor sweep is about
// 6.9k float32 operations a path (80 libors, 9 an alive libor a step) and
// the stoch-vol one about 16.8k (40 libors, 5 factors, 47 an alive libor a
// step), plus 744 and 3,720 for the PRNG variants' Philox and Box-Muller:
// about 0.047 and 0.125 ms at the published 67 TFLOP/s (which counts an FMA
// as two; these kernels issue none, so an add or a multiply issues at half
// that rate), with a strict sequential dependence through the running sums.
// The bytes are the 1.6 MB of payoffs, and for the injected variants the
// normals read once (16 MB and 98 MB). So they are bound by operations, and
// by latency at one path per thread; at n = 80 the 40 KB of shared memory a
// block allows five blocks (640 threads) an SM. Several paths per thread
// and a register-resident curve are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kMaxFactors = 8;

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

// clamp and min that keep NaN (as torch.clamp, jnp.clip, jnp.minimum do)
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  x = (x < lo) ? lo : x;
  return (x > hi) ? hi : x;
}

__device__ __forceinline__ float min_keep_nan(float x, float hi) {
  return (x > hi) ? hi : x;
}

// max(1 - P_end - K A, 0) / N over the swap periods [e, e + m), NaN kept
__device__ __forceinline__ float discounted_payoff(
    const float* L, const float* __restrict__ deltas, int e, int m,
    float strike, float N, int tid) {
  float cp = 1.0f;
  float ann = 0.0f;
  for (int i = e; i < e + m; ++i) {
    const float d = deltas[i];
    cp = __fmul_rn(cp, __fdiv_rn(1.0f,
                                 __fadd_rn(1.0f, __fmul_rn(d, L[i * kTile + tid]))));
    ann = __fadd_rn(ann, __fmul_rn(cp, d));
  }
  float payoff = __fsub_rn(__fsub_rn(1.0f, cp), __fmul_rn(strike, ann));
  payoff = (payoff < 0.0f) ? 0.0f : payoff;
  return __fdiv_rn(payoff, N);
}

template <bool kInjected>
__global__ void __launch_bounds__(kTile)
lmm_swaption_paths_kernel(float* __restrict__ payoff,
                          const float* __restrict__ z, int num_paths,
                          unsigned long long seed,
                          const float* __restrict__ volT,   // [n, S]
                          const float* __restrict__ l0,
                          const float* __restrict__ deltas, float dt,
                          float sqrt_dt, float strike, int n, int S,
                          int exercise, int periods) {
  extern __shared__ float L[];                                // [n][kTile]
  const int tid = threadIdx.x;
  const int path = blockIdx.x * kTile + tid;
  if (path >= num_paths) return;
  for (int i = 0; i < n; ++i) L[i * kTile + tid] = l0[i];
  NormalRows<kInjected> rows{z, num_paths, seed, static_cast<uint32_t>(path),
                             0, make_float4(0.f, 0.f, 0.f, 0.f)};
  float N = 1.0f;
  for (int s = 0; s < S; ++s) {
    const float w = __fmul_rn(sqrt_dt, rows.next());
    N = __fmul_rn(N, __fadd_rn(1.0f, __fmul_rn(deltas[s], L[s * kTile + tid])));
    float prefix = 0.0f;
    for (int i = s + 1; i < n; ++i) {
      const float d = deltas[i];
      const float lam = volT[i * S + s];
      const float Li = L[i * kTile + tid];
      prefix = __fadd_rn(prefix, __fdiv_rn(__fmul_rn(d, lam),
                                           __fadd_rn(1.0f, __fmul_rn(d, Li))));
      L[i * kTile + tid] = __fadd_rn(
          Li, __fmul_rn(lam, __fadd_rn(__fmul_rn(prefix, dt), w)));
    }
  }
  payoff[path] = discounted_payoff(L, deltas, exercise, periods, strike, N,
                                   tid);
}

template <bool kInjected>
__global__ void __launch_bounds__(kTile)
lmm_stochvol_swaption_paths_kernel(
    float* __restrict__ payoff, const float* __restrict__ z, int num_paths,
    unsigned long long seed, const float* __restrict__ volT,  // [F * n, S]
    const float* __restrict__ l0, const float* __restrict__ deltas, float dt,
    float sqrt_dt, float strike, float blend, float nu, float rho,
    float somega, int n, int F, int S, int exercise, int periods) {
  extern __shared__ float L[];                                // [n][kTile]
  const int tid = threadIdx.x;
  const int path = blockIdx.x * kTile + tid;
  if (path >= num_paths) return;
  for (int i = 0; i < n; ++i) L[i * kTile + tid] = l0[i];
  NormalRows<kInjected> rows{z, num_paths, seed, static_cast<uint32_t>(path),
                             0, make_float4(0.f, 0.f, 0.f, 0.f)};
  const float one_minus_blend = __fsub_rn(1.0f, blend);
  const float v_drift = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, nu), nu), dt);
  float N = 1.0f;
  float V = 1.0f;
  for (int s = 0; s < S; ++s) {
    // rows s * (F + 1) .. s * (F + 1) + F: the factors, then V's normal
    float w[kMaxFactors];
    float z0 = 0.0f, z_v = 0.0f;
#pragma unroll
    for (int f = 0; f <= kMaxFactors; ++f) {
      if (f <= F) {
        const float zf = rows.next();
        if (f == 0) z0 = zf;
        if (f < F) {
          if (f < kMaxFactors) w[f] = __fmul_rn(sqrt_dt, zf);
        } else {
          z_v = zf;
        }
      }
    }
    N = __fmul_rn(N, __fadd_rn(1.0f, __fmul_rn(deltas[s], L[s * kTile + tid])));
    const float sqrt_v = sqrtf(V);

    float run[kMaxFactors];
#pragma unroll
    for (int f = 0; f < kMaxFactors; ++f) run[f] = 0.0f;
    for (int i = s + 1; i < n; ++i) {
      const float Li = L[i * kTile + tid];
      const float d = deltas[i];
      const float mt = __fdiv_rn(d, __fadd_rn(1.0f, __fmul_rn(d, Li)));
      const float lf = __fmul_rn(
          __fadd_rn(__fmul_rn(one_minus_blend, Li), __fmul_rn(blend, l0[i])),
          sqrt_v);
      float mu = 0.0f;
      float diffusion = 0.0f;
#pragma unroll
      for (int f = 0; f < kMaxFactors; ++f) {
        if (f < F) {
          const float lam = __fmul_rn(volT[(f * n + i) * S + s], lf);
          run[f] = __fadd_rn(run[f], __fmul_rn(mt, lam));
          mu = __fadd_rn(mu, __fmul_rn(lam, run[f]));
          diffusion = __fadd_rn(diffusion, __fmul_rn(lam, w[f]));
        }
      }
      L[i * kTile + tid] = clamp_keep_nan(
          __fadd_rn(__fadd_rn(Li, __fmul_rn(mu, dt)), diffusion), -1.0e3f,
          1.0e3f);
    }
    const float dw_v = __fmul_rn(
        sqrt_dt, __fadd_rn(__fmul_rn(rho, z0), __fmul_rn(somega, z_v)));
    V = min_keep_nan(
        __fmul_rn(V, expf(__fsub_rn(__fmul_rn(nu, dw_v), v_drift))), 1.0e6f);
  }
  payoff[path] = discounted_payoff(L, deltas, exercise, periods, strike, N,
                                   tid);
}

int blocks_for(int num_paths) { return (num_paths + kTile - 1) / kTile; }

bool bad_shape(int num_paths, int n, int S, int exercise, int periods) {
  return num_paths < 1 || n < 1 || S < 1 || S > n || exercise < 0 ||
         periods < 1 || exercise + periods > n;
}

template <typename Kernel>
cudaError_t set_shared(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kInjected>
cudaError_t launch_one_factor(float* payoff, const float* z, int num_paths,
                              unsigned long long seed, const float* volT,
                              const float* l0, const float* deltas, float dt,
                              float sqrt_dt, float strike, int n, int S,
                              int exercise, int periods,
                              cudaStream_t stream) {
  if (bad_shape(num_paths, n, S, exercise, periods)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(n) * kTile * sizeof(float);
  cudaError_t err = set_shared(lmm_swaption_paths_kernel<kInjected>, smem);
  if (err != cudaSuccess) return err;
  lmm_swaption_paths_kernel<kInjected>
      <<<blocks_for(num_paths), kTile, smem, stream>>>(
          payoff, z, num_paths, seed, volT, l0, deltas, dt, sqrt_dt, strike,
          n, S, exercise, periods);
  return cudaGetLastError();
}

template <bool kInjected>
cudaError_t launch_stochvol(float* payoff, const float* z, int num_paths,
                            unsigned long long seed, const float* volT,
                            const float* l0, const float* deltas, float dt,
                            float sqrt_dt, float strike, float blend,
                            float nu, float rho, float somega, int n, int F,
                            int S, int exercise, int periods,
                            cudaStream_t stream) {
  if (bad_shape(num_paths, n, S, exercise, periods) || F < 1 ||
      F > kMaxFactors) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(n) * kTile * sizeof(float);
  cudaError_t err =
      set_shared(lmm_stochvol_swaption_paths_kernel<kInjected>, smem);
  if (err != cudaSuccess) return err;
  lmm_stochvol_swaption_paths_kernel<kInjected>
      <<<blocks_for(num_paths), kTile, smem, stream>>>(
          payoff, z, num_paths, seed, volT, l0, deltas, dt, sqrt_dt, strike,
          blend, nu, rho, somega, n, F, S, exercise, periods);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher launches on `stream` without synchronising and returns the
// launch's error; `payoff` receives num_paths floats.
cudaError_t lmm_swaption_paths_launch(float* payoff, int num_paths,
                                      unsigned long long seed,
                                      const float* volT, const float* l0,
                                      const float* deltas, float dt,
                                      float sqrt_dt, float strike, int n,
                                      int S, int exercise, int periods,
                                      cudaStream_t stream) {
  return launch_one_factor<false>(payoff, nullptr, num_paths, seed, volT, l0,
                                  deltas, dt, sqrt_dt, strike, n, S,
                                  exercise, periods, stream);
}

cudaError_t lmm_swaption_paths_normals_launch(
    float* payoff, const float* z, int num_paths, const float* volT,
    const float* l0, const float* deltas, float dt, float sqrt_dt,
    float strike, int n, int S, int exercise, int periods,
    cudaStream_t stream) {
  if (z == nullptr) return cudaErrorInvalidValue;
  return launch_one_factor<true>(payoff, z, num_paths, 0ull, volT, l0,
                                 deltas, dt, sqrt_dt, strike, n, S, exercise,
                                 periods, stream);
}

cudaError_t lmm_stochvol_swaption_paths_launch(
    float* payoff, int num_paths, unsigned long long seed, const float* volT,
    const float* l0, const float* deltas, float dt, float sqrt_dt,
    float strike, float blend, float nu, float rho, float somega, int n,
    int F, int S, int exercise, int periods, cudaStream_t stream) {
  return launch_stochvol<false>(payoff, nullptr, num_paths, seed, volT, l0,
                                deltas, dt, sqrt_dt, strike, blend, nu, rho,
                                somega, n, F, S, exercise, periods, stream);
}

cudaError_t lmm_stochvol_swaption_paths_normals_launch(
    float* payoff, const float* z, int num_paths, const float* volT,
    const float* l0, const float* deltas, float dt, float sqrt_dt,
    float strike, float blend, float nu, float rho, float somega, int n,
    int F, int S, int exercise, int periods, cudaStream_t stream) {
  if (z == nullptr) return cudaErrorInvalidValue;
  return launch_stochvol<true>(payoff, z, num_paths, 0ull, volT, l0, deltas,
                               dt, sqrt_dt, strike, blend, nu, rho, somega, n,
                               F, S, exercise, periods, stream);
}

const char* lmm_swaption_paths_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
