// Black (lognormal) implied volatilities of the stoch-vol kernel backend's
// swaption values, and the weighted residual rows built from them, in one
// launch: out[b, j] = weight[j] * (iv(values[b, j]; F_j, K_j, T_j, A_j)
// - target[j]).
//
// Replaces no Pallas kernel. The JAX package inverts inside its jitted
// residual function, where XLA fuses the Newton steps; the port's PyTorch
// composition of the same steps (models/lmm/model.py::
// _BlackImpliedVol.forward) makes about 35 float64 element-wise launches a
// step, about 2,100 a backend call, each less work on the card than its
// host dispatch. This kernel takes the whole inversion and the
// weighting after it for the backend (ops/black_residuals.py); the
// valuation engine keeps the composition, whose implicit-derivative jvp
// and vmap rule a launch cannot carry.
//
// The arithmetic is _BlackImpliedVol.forward's, step for step, in float64:
//   sigma_0 = max(sqrt(2 |ln(F/K)| / T), 1e-2)        (Manaster-Koehler)
//   v = max(sigma, 1e-8) sqrt(T),  d1 = ln(F/K) / v + v / 2,  d2 = d1 - v,
//   the out-of-the-money twin's value from erfc tails (the put if F >= K,
//   else the call) against the time value max(p - max(F - K, 0), 1e-16),
//   p = value / annuity; vega = F sqrt(T) phi(d1); the Newton step capped
//   at +-sigma / 2 and sigma clamped to [1e-8, 10]; all num_iter steps, no
//   early exit; 0 where the time value is at most 1e-12 F. Each operation
//   is the one PyTorch's CUDA kernels take: IEEE divisions, except the
//   normal density's division by the Python scalar sqrt(2 pi), which
//   PyTorch takes as a product with its reciprocal; libdevice's erfc, exp,
//   log and sqrt; clamps that keep a NaN. Built with -fmad=false
//   (ops/_products.py::SWEEP_FLAGS), so no multiply and add fuse into one
//   FMA: each operation rounds once, as each launch of the composition
//   does.
//
// What bounds it on an H100: latency. The backend's calls hold B * P
// elements (15 at B = 1, 255 for the 17 parameter sets of the FD
// Jacobian), one or a few warps on as many SMs; each runs num_iter = 60
// dependent Newton steps of two erfc, one exp, two divisions and about 20
// other float64 operations, a chain of several thousand dependent
// instructions. Even at B = 17 the launch's float64 work is about
// 255 * 60 * 250 operations, under a microsecond at the card's float64
// rate; one thread's chain sets the time: 0.075 ms a launch at both shapes
// on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 9).
//
// Design: one thread an element, 64 threads a block, every value in
// registers, no shared memory, nothing written but the output. Only the
// twin that the composition's select keeps is valued, and the twins are
// one expression with the operands swapped and negated by the product's
// side of the money, so a warp whose elements straddle F = K does not
// diverge: two erfc a step instead of the composition's four, each
// independent of the other.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr double kInvSqrt2 = 0.7071067811865475;          // 1 / sqrt(2)
constexpr double kInvSqrt2Pi = 1.0 / 2.5066282746310002;  // 1 / sqrt(2 pi)

// torch.clamp_min / torch.maximum and torch.minimum: a NaN operand wins
__device__ __forceinline__ double max_keep_nan(double a, double b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ double min_keep_nan(double a, double b) {
  return (a != a || a < b) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
black_residuals_kernel(const double* __restrict__ values,
                       const double* __restrict__ fwd,
                       const double* __restrict__ strike,
                       const double* __restrict__ texp,
                       const double* __restrict__ ann,
                       const double* __restrict__ target,
                       const double* __restrict__ weight,
                       double* __restrict__ out, int n, int P,
                       int num_iter) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int j = i % P;
  const double F = fwd[j];
  const double K = strike[j];
  const double T = texp[j];
  const double sqrt_t = sqrt(T);
  const double p = values[i] / ann[j];
  const double raw_time_value = p - max_keep_nan(F - K, 0.0);
  const double time_value = max_keep_nan(raw_time_value, 1e-16);
  const double log_fk = log(F / K);
  double sigma = max_keep_nan(sqrt(2.0 * fabs(log_fk) / T), 1e-2);

  // the twin: 0.5 (a erfc(s xa) - b erfc(s xb)); the put (a = K, xa = d2,
  // b = F, xb = d1, s = 1) if F >= K, else the call (F, d1, K, d2, s = -1)
  const bool itm = F >= K;
  const double a = itm ? K : F;
  const double b = itm ? F : K;
  const double f_sqrt_t = F * sqrt_t;
  for (int it = 0; it < num_iter; ++it) {
    const double v = max_keep_nan(sigma, 1e-8) * sqrt_t;
    const double d1 = log_fk / v + 0.5 * v;
    const double d2 = d1 - v;
    const double x1 = d1 * kInvSqrt2;
    const double x2 = d2 * kInvSqrt2;
    const double xa = itm ? x2 : -x1;
    const double xb = itm ? x1 : -x2;
    const double val = 0.5 * (a * erfc(xa) - b * erfc(xb));
    const double vega = f_sqrt_t * (exp(-0.5 * d1 * d1) * kInvSqrt2Pi);
    double step = (val - time_value) / max_keep_nan(vega, 1e-16);
    step = min_keep_nan(max_keep_nan(step, -0.5 * sigma), 0.5 * sigma);
    sigma = min_keep_nan(max_keep_nan(sigma - step, 1e-8), 10.0);
  }
  const double iv = raw_time_value <= 1e-12 * F ? 0.0 : sigma;
  out[i] = weight[j] * (iv - target[j]);
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns the launch's error.
// values and out are [B, P], the per-product rows [P], all float64 and
// contiguous.
cudaError_t black_residuals_launch(const double* values, const double* fwd,
                                   const double* strike, const double* texp,
                                   const double* ann, const double* target,
                                   const double* weight, double* out, int B,
                                   int P, int num_iter, cudaStream_t stream) {
  if (B < 1 || P < 1 || num_iter < 0) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(B) * P;
  if (n > 0x7fffffffLL - kThreads) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  black_residuals_kernel<<<blocks, kThreads, 0, stream>>>(
      values, fwd, strike, texp, ann, target, weight, out,
      static_cast<int>(n), P, num_iter);
  return cudaGetLastError();
}

const char* black_residuals_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
