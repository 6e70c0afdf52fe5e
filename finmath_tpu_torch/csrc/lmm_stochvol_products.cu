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
//   lambda_{i,f}  = vol[s, i, f] * ((1 - b) L_i + b L_i(0)) * sqrt(V),
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
// What bounds it on an H100: float32 issue and its latency. Per path and
// parameter set the sweep is ~590 alive (step, libor) updates of 13 + 7 F
// operations with a sequential dependence through the drift's running
// sums; the normals are ~39 MB at 81,920 paths, read once. The first design
// (one thread a path, the curve in shared memory, the loadings read from
// global memory with 64-bit index arithmetic inside a rolled libor loop
// that issued all 8 factor slots whatever F) reached 6-10% of the
// operations bound: 181 SASS instructions an alive libor, and at B = 1
// 640 blocks of 128 threads, under one wave. This design issues about 46
// an alive libor at F = 5; at B = 1 its 320 blocks are still one partial
// wave, so there one thread's sweep latency sets the time.
//
// Design (lmm_sweep.cuh has the shared pieces):
//   * one thread a path; its forward curve lives in registers, K = n
//     libors unrolled at compile time, so the curve never touches memory;
//     each (K, F, R) is its own build (LMM_K, LMM_F, LMM_R,
//     ops/_products.py::sweep_variant). Lane groups of 2, 4 and 8 lanes a
//     path (the rates split over the lanes, the running sums as shuffle
//     scans) were measured at both launch shapes and lost at both: the
//     register-resident, unrolled curve already gives one thread the
//     independent work (F loadings, the divide) that the lanes would share,
//     while each shuffle round costs a quarter-rate issue slot a factor
//     (tools/compare_products_kernels.py, PERF.md, PR 5);
//   * the drift's running sums are one addition after another over the
//     libors; N's fixing is a select of the register holding L_s;
//   * rows are swept in chunks of R: a chunk whose libors are all dead
//     (i <= s) is skipped by a warp-uniform branch, and no branch splits a
//     chunk, so the scheduler overlaps its rows' divides and loads (R = 4
//     at 5 factors);
//   * a block (256 threads, 256 paths) first stages its parameter set into
//     shared memory with bulk asynchronous copies (TMA) completed on an
//     mbarrier: the 8 scalars, (L0, delta, b L0) per libor and the
//     loadings step-major [S][C][NP][V] (F padded to 8 as two float4 a
//     libor), packed by the wrapper; 26 KB at the benchmark's shape. The
//     inner loop then reads one float4 of constants and C float4 of
//     loadings from shared memory per alive libor, with no global loads
//     and no index arithmetic beyond an immediate offset;
//   * the grid is (path tile, B) with B fastest, so the B parameter sets
//     of one tile run together and read its normals from L2;
//   * collection: per exercise step, the running bond product and annuity
//     over the periods that the step's swaps span; products visit in order
//     of their end period (the wrapper's `order`);
//   * the path reduction is deterministic: a float64 shuffle sum over the
//     paths of a warp, a fixed-order sum of the 8 warp partials, written per
//     tile to partials[B, tiles, P]; the wrapper sums tiles in float64. No
//     atomics. Paths past num_paths read no z and contribute 0.
// No tensor cores: the contractions over factors have depth F <= 8 and sit
// inside a per-path recurrence, and TF32 would break the precision contract
// (float32 path data, float64 reductions). No fast math: expf, IEEE
// division; log V is carried additively and exponentiated once a step.

#include "lmm_sweep.cuh"

namespace {

using namespace lmm_sweep;

constexpr int K = LMM_K;
constexpr int F = LMM_F;
constexpr int kRows = LMM_R;             // rows a chunk of the drift sweep
constexpr float kLogVCap = 13.815511f;   // log(1e6), the engine's cap of V

__global__ void __launch_bounds__(kThreads)
lmm_stochvol_products_kernel(const float* __restrict__ z, long long ldz,
                             const float* __restrict__ packed, int width,
                             const int* __restrict__ step_first,
                             const int* __restrict__ order,
                             const int* __restrict__ prod_m,
                             const float* __restrict__ prod_k,
                             double* __restrict__ partials, int S, int P,
                             int num_paths, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  double* red = reinterpret_cast<double*>(smem_raw + 16);       // [kWarps][P]
  float* set = reinterpret_cast<float*>(red + kWarps * P);      // [width]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x % B;
  const int tile = blockIdx.x / B;
  const long long path = static_cast<long long>(tile) * kThreads + tid;
  const bool valid = path < num_paths;

  for (int r = tid; r < kWarps * P; r += kThreads) red[r] = 0.0;
  stage(set, packed + static_cast<size_t>(b) * width,
        static_cast<unsigned>(width) * sizeof(float), bar);

  const float dt = set[0];
  const float sqrt_dt = set[1];
  const float blend = set[2];
  const float nu = set[3];
  const float rho = set[4];
  const float somega = set[5];
  const float one_minus_blend = 1.0f - blend;
  const float v_drift = 0.5f * nu * nu * dt;
  const float4* cst = reinterpret_cast<const float4*>(set + 8);  // [kNP]
  const float* tab = set + 8 + 4 * kNP;              // [S][kC][kNP][kV]

  float L[K];
#pragma unroll
  for (int r = 0; r < K; ++r) L[r] = cst[r].x;
  float N = 1.0f;
  float logV = 0.0f;

  for (int s = 0; s <= S; ++s) {
    // collection at the START of the exercise step (engine ordering)
    const int q1 = step_first[s + 1];
    int q = step_first[s];
    if (q < q1) {
      const int last = s + prod_m[order[q1 - 1]] - 1;
      int end = s + prod_m[order[q]] - 1;
      float cp = 1.0f;                   // bond product of periods s..r
      float ann = 0.0f;                  // annuity of periods s..r
#pragma unroll
      for (int r = 0; r < K; ++r) {
        if (r < s || r > last) continue;                   // warp-uniform
        const float d = cst[r].y;
        cp = cp * (1.0f / (1.0f + d * L[r]));
        ann = ann + cp * d;
        // value the products whose last period is r: payoff / N, the
        // non-finite values dropped
        for (; q < q1 && end == r;) {                      // warp-uniform
          const int k = order[q];
          float payoff = 1.0f - cp - prod_k[k] * ann;
          payoff = (payoff < 0.0f) ? 0.0f : payoff;
          const float value = payoff / N;
          const bool keep = valid && fabsf(value) <= 3.40282347e+38f;
          const double pv =
              warp_path_sum(keep ? static_cast<double>(value) : 0.0);
          if (lane == 0) red[warp * P + k] = pv;
          if (++q < q1) end = s + prod_m[order[q]] - 1;
        }
      }
    }
    if (s == S) break;

    float w[F];
    float z_v = 0.0f;                      // the V driver, row F of step s
    const float* zs = z + static_cast<long long>(s) * (F + 1) * ldz + path;
#pragma unroll
    for (int f = 0; f < F; ++f) w[f] = sqrt_dt * (valid ? zs[f * ldz] : 0.0f);
    const float z_0 = valid ? zs[0] : 0.0f;
    if (valid) z_v = zs[F * ldz];

    // spot account accrues period s at its fixing L_s
    N = N * (1.0f + cst[s].y * libor_at(L, s));
    const float sqrt_v = expf(0.5f * logV);

    float run[F];                        // running sums of m_j lambda_j
#pragma unroll
    for (int f = 0; f < F; ++f) run[f] = 0.0f;
#pragma unroll
    for (int r0 = 0; r0 < K; r0 += kRows) {
      // a chunk of kRows rows whose libors are all dead is skipped (a
      // warp-uniform branch); within a chunk no branch splits the rows, so
      // the scheduler can overlap their independent work
      if ((r0 + kRows < K ? r0 + kRows : K) - 1 <= s) continue;
#pragma unroll
      for (int r = r0; r < r0 + kRows && r < K; ++r) {
        const bool alive = r > s;
        const float4 c = cst[r];
        const float Li = L[r];
        // the divide is taken on every row of the chunk, then masked: a
        // select, not a branch that would split the chunk around the
        // divide's slow path
        const float m = c.y / (1.0f + c.y * Li);
        const float mt = alive ? m : 0.0f;
        const float lf = (one_minus_blend * Li + c.z) * sqrt_v;
        float v[kFP];
        load_loadings(tab, s, r, v);
        float mu = 0.0f;
        float diffusion = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float lam = v[f] * lf;
          run[f] = run[f] + mt * lam;
          mu = mu + lam * run[f];
          diffusion = diffusion + lam * w[f];
        }
        if (alive) {
          L[r] = clamp_keep_nan(Li + mu * dt + diffusion, -1.0e3f, 1.0e3f);
        }
      }
    }
    const float dw_v = sqrt_dt * (rho * z_0 + somega * z_v);
    logV = min_keep_nan(logV + nu * dw_v - v_drift, kLogVCap);
  }

  __syncthreads();
  double* out =
      partials + (static_cast<size_t>(b) * (gridDim.x / B) + tile) * P;
  for (int r = tid; r < P; r += kThreads) {
    double acc = red[r];
    for (int wi = 1; wi < kWarps; ++wi) acc += red[wi * P + r];
    out[r] = acc;
  }
}

}  // namespace

extern "C" {

// The instantiation of this library: K, F, R for which = 0, 1, 2.
int lmm_stochvol_products_variant(int which) {
  const int v[3] = {K, F, kRows};
  return (which >= 0 && which < 3) ? v[which] : -1;
}

// Launches on `stream` without synchronising; returns the launch's error.
cudaError_t lmm_stochvol_products_launch(
    const float* z, long long ldz, const float* packed, int width,
    const int* step_first, const int* order, const int* prod_m,
    const float* prod_k, double* partials, int n, int S, int P,
    int num_paths, int B, cudaStream_t stream) {
  if (n != K || S < 1 || S >= n || P < 1 || num_paths < 1 || B < 1 ||
      width != 8 + 4 * kNP + S * kC * kNP * kV ||
      !stageable(packed, width)) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (num_paths + kThreads - 1) / kThreads;
  if (tiles * B > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(P, width);
  cudaError_t err = cudaFuncSetAttribute(
      lmm_stochvol_products_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lmm_stochvol_products_kernel<<<static_cast<unsigned>(tiles * B), kThreads,
                                 smem, stream>>>(
      z, ldz, packed, width, step_first, order, prod_m, prod_k, partials, S,
      P, num_paths, B);
  return cudaGetLastError();
}

const char* lmm_stochvol_products_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
