// ATM-surface path sweep of the spot-measure NORMAL LIBOR market model.
//
// Replaces finmath_tpu/ops/lmm_kernel.py::_normal_lmm_kernel_products (the
// Pallas kernel behind lmm_atm_swaptions_batch). One launch simulates every
// path of B parameter sets on one shared normal realization, F factors,
// optionally displaced (lambda = vol * (L + d)), with the Euler scheme on the
// tenor grid, and collects at each exercise step, before that step's accrual
// and evolution:
//   * one row per product: sum over paths of max(1 - P_end - K * A, 0) / N,
//   * one row per exercise event: sum over paths of 1 / N,
// where N is the spot numeraire and P_end, A the swap's end bond and annuity
// read off the live forward curve.
//
// Design for Hopper:
//   * one thread is one path; a block is kTile = 128 paths; the grid is
//     (path tiles, B) and blocks are independent, so nothing carries over
//     between them;
//   * each thread's forward curve L[0..n) lives in shared memory as
//     [n][kTile] floats (n = 80: 40 KB), so thread t only ever touches
//     column t (bank-conflict-free, no barriers in the sweep);
//   * the spot drift's prefix sum over libors is one sequential pass per
//     step (running sums for up to kMaxFactors factors kept in registers):
//     c_i = delta_i lambda_i / (1 + delta_i L_i) from the pre-update L_i,
//     added to the inclusive running sum, then L_i is updated in place;
//   * products arrive grouped by exercise step (engine order); each group
//     is valued in one pass of a running bond product over the swap periods;
//   * the path reduction is deterministic: a float64 warp-shuffle sum, then
//     a fixed-order sum of the four warp partials, written per tile to
//     partials[B, tiles, P + E]; the caller sums tiles in float64. No
//     atomics. Threads past num_paths simulate on zero normals, read no z,
//     and contribute 0.
//
// What bounds it: per step each path does O(n) float32 work (one divide, a
// few FMAs per libor and factor) with L re-read from shared memory, a strict
// sequential dependence through the running sum, and a divide per libor in
// the collection. At B = 1 and 100k paths the grid is only ~782 blocks of
// 128 threads, about one wave on 132 SMs at the occupancy that 45 KB of
// shared memory per block allows; the batched FD Jacobian (B = 87) fills
// the card. Register-resident curves, several paths per thread and graphs
// of launches are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarps = kTile / 32;
constexpr int kMaxFactors = 8;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// clamp that keeps NaN (as torch.clamp and jnp.clip do)
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  x = (x < lo) ? lo : x;
  return (x > hi) ? hi : x;
}

__global__ void __launch_bounds__(kTile)
lmm_atm_products_kernel(const float* __restrict__ z, long long ldz,
                        const float* __restrict__ volT,
                        const float* __restrict__ scal,
                        const float* __restrict__ l0,
                        const float* __restrict__ deltas,
                        const int* __restrict__ step_event,
                        const int* __restrict__ step_first,
                        const int* __restrict__ prod_m,
                        const float* __restrict__ prod_k,
                        double* __restrict__ partials,
                        int n, int F, int S, int P, int E, int num_paths,
                        int displaced) {
  extern __shared__ double smem[];
  const int R = P + E;
  double* red = smem;                                        // [kWarps][R]
  float* L = reinterpret_cast<float*>(smem + kWarps * R);    // [n][kTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const long long path = static_cast<long long>(tile) * kTile + tid;
  const bool valid = path < num_paths;

  const float dt = scal[b * 8 + 0];
  const float sqrt_dt = scal[b * 8 + 1];
  const float disp = scal[b * 8 + 2];
  const float* vol = volT + static_cast<size_t>(b) * F * n * S;

  for (int r = tid; r < kWarps * R; r += kTile) red[r] = 0.0;
  for (int i = 0; i < n; ++i) L[i * kTile + tid] = l0[i];
  float N = 1.0f;
  __syncthreads();

  for (int s = 0; s <= S; ++s) {
    const int ev = step_event[s];
    if (ev >= 0) {
      // collection at the START of the exercise step (engine ordering)
      const float inv_n = 1.0f / N;
      double v = warp_sum(valid ? static_cast<double>(inv_n) : 0.0);
      if (lane == 0) red[warp * R + P + ev] = v;
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
        v = warp_sum(valid ? static_cast<double>(payoff * inv_n) : 0.0);
        if (lane == 0) red[warp * R + k] = v;
      }
    }
    if (s == S) break;

    float w[kMaxFactors];
#pragma unroll
    for (int f = 0; f < kMaxFactors; ++f) {
      w[f] = (f < F && valid)
                 ? sqrt_dt * z[static_cast<long long>(s * F + f) * ldz + path]
                 : 0.0f;
    }
    // spot account accrues period s at its fixing L_s
    N = N * (1.0f + deltas[s] * L[s * kTile + tid]);

    float run[kMaxFactors];
#pragma unroll
    for (int f = 0; f < kMaxFactors; ++f) run[f] = 0.0f;
    for (int i = s + 1; i < n; ++i) {
      const float Li = L[i * kTile + tid];
      const float d = deltas[i];
      const float mt = d / (1.0f + d * Li);
      const float lf = Li + disp;
      float mu = 0.0f;
      float diffusion = 0.0f;
#pragma unroll
      for (int f = 0; f < kMaxFactors; ++f) {
        if (f < F) {
          const float base = vol[(static_cast<size_t>(f) * n + i) * S + s];
          const float lam = displaced ? base * lf : base;
          run[f] = run[f] + mt * lam;
          mu = mu + lam * run[f];
          diffusion = diffusion + lam * w[f];
        }
      }
      L[i * kTile + tid] = clamp_keep_nan(Li + mu * dt + diffusion,
                                          -1.0e3f, 1.0e3f);
    }
  }

  __syncthreads();
  double* out = partials + (static_cast<size_t>(b) * gridDim.x + tile) * R;
  for (int r = tid; r < R; r += kTile) {
    double acc = red[r];
    for (int wi = 1; wi < kWarps; ++wi) acc += red[wi * R + r];
    out[r] = acc;
  }
}

}  // namespace

extern "C" {

int lmm_atm_products_max_factors() { return kMaxFactors; }

// Launches on `stream` without synchronising; returns the launch's error.
cudaError_t lmm_atm_products_launch(
    const float* z, long long ldz, const float* volT, const float* scal,
    const float* l0, const float* deltas, const int* step_event,
    const int* step_first, const int* prod_m, const float* prod_k,
    double* partials, int n, int F, int S, int P, int E, int num_paths,
    int B, int displaced, cudaStream_t stream) {
  if (F < 1 || F > kMaxFactors || n < 1 || S < 1 || P < 1 || E < 1 ||
      num_paths < 1 || B < 1) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (num_paths + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(kWarps) * (P + E) * sizeof(double) +
                      static_cast<size_t>(n) * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lmm_atm_products_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lmm_atm_products_kernel<<<dim3(tiles, B), kTile, smem, stream>>>(
      z, ldz, volT, scal, l0, deltas, step_event, step_first, prod_m, prod_k,
      partials, n, F, S, P, E, num_paths, displaced);
  return cudaGetLastError();
}

const char* lmm_atm_products_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
