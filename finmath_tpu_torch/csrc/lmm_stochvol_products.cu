// Stoch-vol path sweep of the spot-measure NORMAL LIBOR market model with
// blended local volatility: the reference's benchmark model family
// (LIBORMarketModelCalibrationTest.java:269-275).
//
// Replaces finmath_tpu/ops/lmm_stochvol_kernel.py::_sv_kernel_products (the
// Pallas kernel behind lmm_stochvol_swaptions_batch). One launch simulates
// every path of B parameter sets on one shared normal realization (common
// random numbers: residuals at B = 1, the central finite-difference Jacobian
// at B = 2 * n_params + 1), F rate factors plus the driver of the scaling
// process V, with the Euler scheme on the tenor grid:
//   lambda_{i,f}  = volT[f, i, s] * ((1 - b) L_i + b L_i(0)) * sqrt(V),
//   dL_i          = lambda_i . (sum_{j=s+1..i} m_j lambda_j) dt + lambda_i . dW,
//   m_j           = delta_j / (1 + delta_j L_j),
//   log V        += nu sqrt_dt (rho z_0 + sqrt(1 - rho^2) z_F) - nu^2 dt / 2,
// log V capped at log(1e6), the new V used from the next step on. At each
// exercise step, before that step's accrual and evolution, every product of
// the step is valued: max(1 - P_end - K * A, 0) / N with N the spot
// numeraire, P_end and A the swap's end bond and annuity off the live
// forward curve. Non-finite pathwise values are dropped and the rest summed
// in float64, as the JAX caller does with the Pallas kernel's per-path
// output.
//
// Design for Hopper:
//   * one thread is one path; a block is kTile = 128 paths; the grid is
//     (path tiles, B) and blocks are independent;
//   * each thread's forward curve L[0..n) lives in shared memory as
//     [n][kTile] floats (n = 40: 20 KB), thread t touching column t only
//     (bank-conflict-free, no barriers in the sweep); log V and N stay in
//     registers. log V is carried additively and exponentiated once per
//     step (expf, not the fast __expf; no --use_fast_math), so no float32
//     product of exponentials compounds a bias that the chaotic calibrated
//     basins would amplify;
//   * the spot drift's prefix sum over libors is one sequential pass per
//     step with the F running sums in registers: the pre-update L_i gives
//     m_i and lambda_i, the inclusive sums take them, then L_i is updated
//     in place (clamped to +-1e3, NaN kept as torch.clamp and jnp.clip keep
//     it);
//   * products arrive grouped by exercise step, periods ascending; each
//     group is valued by one running bond product over the swap periods, so
//     the benchmark's nine smile strikes at one expiry share one curve;
//   * the path reduction is deterministic: a float64 warp-shuffle sum, then
//     a fixed-order sum of the four warp partials, written per tile to
//     partials[B, tiles, P]; the wrapper sums tiles in float64. No atomics.
//     Threads past num_paths read no z and contribute 0. A per-path output
//     would be 84 MB per Jacobian launch at 81,920 paths, and its only
//     caller reduces it at once.
//
// What bounds it: per path and parameter set about 20 steps x 30 alive
// libors x (13 + 7 F) float32 operations with a strict sequential
// dependence through the running sums: compute (and latency), not bytes;
// the normals are read once, ~39 MB at 81,920 paths. At B = 1 the grid is
// 640 blocks of 128 threads, under one wave on 132 SMs; the FD batch
// (B = 17) fills the card. Several paths per thread, a register-resident
// curve and graphs of launches are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarps = kTile / 32;
constexpr int kMaxFactors = 8;
constexpr float kLogVCap = 13.815511f;   // log(1e6), the engine's cap of V

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// clamp and min that keep NaN (as torch.clamp, jnp.clip, jnp.minimum do)
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  x = (x < lo) ? lo : x;
  return (x > hi) ? hi : x;
}

__device__ __forceinline__ float min_keep_nan(float x, float hi) {
  return (x > hi) ? hi : x;
}

// false for +-inf and NaN
__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) <= 3.40282347e+38f;
}

__global__ void __launch_bounds__(kTile)
lmm_stochvol_products_kernel(const float* __restrict__ z, long long ldz,
                             const float* __restrict__ volT,
                             const float* __restrict__ scal,
                             const float* __restrict__ l0,
                             const float* __restrict__ deltas,
                             const int* __restrict__ step_first,
                             const int* __restrict__ prod_m,
                             const float* __restrict__ prod_k,
                             double* __restrict__ partials,
                             int n, int F, int S, int P, int num_paths) {
  extern __shared__ double smem[];
  double* red = smem;                                        // [kWarps][P]
  float* L = reinterpret_cast<float*>(smem + kWarps * P);    // [n][kTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const long long path = static_cast<long long>(tile) * kTile + tid;
  const bool valid = path < num_paths;
  const int rows = F + 1;                  // normals per step: F, then V's

  const float dt = scal[b * 8 + 0];
  const float sqrt_dt = scal[b * 8 + 1];
  const float blend = scal[b * 8 + 2];
  const float nu = scal[b * 8 + 3];
  const float rho = scal[b * 8 + 4];
  const float somega = scal[b * 8 + 5];
  const float one_minus_blend = 1.0f - blend;
  const float v_drift = 0.5f * nu * nu * dt;
  const float* vol = volT + static_cast<size_t>(b) * F * n * S;

  for (int r = tid; r < kWarps * P; r += kTile) red[r] = 0.0;
  for (int i = 0; i < n; ++i) L[i * kTile + tid] = l0[i];
  float N = 1.0f;
  float logV = 0.0f;
  __syncthreads();

  for (int s = 0; s <= S; ++s) {
    // collection at the START of the exercise step (engine ordering)
    int pos = s;
    float cp = 1.0f;
    float ann = 0.0f;
    for (int k = step_first[s]; k < step_first[s + 1]; ++k) {
      const int end = s + prod_m[k];
      if (end < pos) {
        pos = s;
        cp = 1.0f;
        ann = 0.0f;
      }
      for (; pos < end; ++pos) {
        const float d = deltas[pos];
        cp = cp * (1.0f / (1.0f + d * L[pos * kTile + tid]));
        ann = ann + cp * d;
      }
      float payoff = 1.0f - cp - prod_k[k] * ann;
      payoff = (payoff < 0.0f) ? 0.0f : payoff;
      const float value = payoff / N;
      const double v = warp_sum(
          (valid && is_finite(value)) ? static_cast<double>(value) : 0.0);
      if (lane == 0) red[warp * P + k] = v;
    }
    if (s == S) break;

    float zr[kMaxFactors + 1];
    float w[kMaxFactors];
#pragma unroll
    for (int f = 0; f <= kMaxFactors; ++f) {
      zr[f] = (f <= F && valid)
                  ? z[static_cast<long long>(s * rows + f) * ldz + path]
                  : 0.0f;
    }
#pragma unroll
    for (int f = 0; f < kMaxFactors; ++f) w[f] = sqrt_dt * zr[f];
    float z_v = 0.0f;                      // the V driver, row F of step s
#pragma unroll
    for (int f = 1; f <= kMaxFactors; ++f) {
      if (f == F) z_v = zr[f];
    }

    // spot account accrues period s at its fixing L_s
    N = N * (1.0f + deltas[s] * L[s * kTile + tid]);
    const float sqrt_v = expf(0.5f * logV);

    float run[kMaxFactors];
#pragma unroll
    for (int f = 0; f < kMaxFactors; ++f) run[f] = 0.0f;
    for (int i = s + 1; i < n; ++i) {
      const float Li = L[i * kTile + tid];
      const float d = deltas[i];
      const float mt = d / (1.0f + d * Li);
      const float lf = (one_minus_blend * Li + blend * l0[i]) * sqrt_v;
      float mu = 0.0f;
      float diffusion = 0.0f;
#pragma unroll
      for (int f = 0; f < kMaxFactors; ++f) {
        if (f < F) {
          const float lam = vol[(static_cast<size_t>(f) * n + i) * S + s] * lf;
          run[f] = run[f] + mt * lam;
          mu = mu + lam * run[f];
          diffusion = diffusion + lam * w[f];
        }
      }
      L[i * kTile + tid] = clamp_keep_nan(Li + mu * dt + diffusion,
                                          -1.0e3f, 1.0e3f);
    }
    const float dw_v = sqrt_dt * (rho * zr[0] + somega * z_v);
    logV = min_keep_nan(logV + nu * dw_v - v_drift, kLogVCap);
  }

  __syncthreads();
  double* out = partials + (static_cast<size_t>(b) * gridDim.x + tile) * P;
  for (int r = tid; r < P; r += kTile) {
    double acc = red[r];
    for (int wi = 1; wi < kWarps; ++wi) acc += red[wi * P + r];
    out[r] = acc;
  }
}

}  // namespace

extern "C" {

int lmm_stochvol_products_max_factors() { return kMaxFactors; }

// Launches on `stream` without synchronising; returns the launch's error.
cudaError_t lmm_stochvol_products_launch(
    const float* z, long long ldz, const float* volT, const float* scal,
    const float* l0, const float* deltas, const int* step_first,
    const int* prod_m, const float* prod_k, double* partials, int n, int F,
    int S, int P, int num_paths, int B, cudaStream_t stream) {
  if (F < 1 || F > kMaxFactors || n < 1 || S < 1 || P < 1 ||
      num_paths < 1 || B < 1) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (num_paths + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(kWarps) * P * sizeof(double) +
                      static_cast<size_t>(n) * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lmm_stochvol_products_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lmm_stochvol_products_kernel<<<dim3(tiles, B), kTile, smem, stream>>>(
      z, ldz, volT, scal, l0, deltas, step_first, prod_m, prod_k, partials,
      n, F, S, P, num_paths);
  return cudaGetLastError();
}

const char* lmm_stochvol_products_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
