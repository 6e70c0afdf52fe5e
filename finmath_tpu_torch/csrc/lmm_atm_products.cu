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
// What bounds it on an H100: float32 issue. Per path and parameter set the
// reference's ATM calibration (80 libors, 1 factor, 60 steps) is ~2,970
// alive (step, libor) updates and 11 collections of up to 78 periods for
// 144 products, all float32 with a sequential dependence through the
// running sums; the normals are read once (24 MB at 100,000 paths). The
// first design (the [n][128] curve in shared memory, 45 KB a block) ran 782
// blocks at 4-5 blocks an SM, two waves with the second mostly empty, and
// cost every alive libor 235 SASS instructions (a shared load and store,
// and all 8 factor slots of global loads with 64-bit index arithmetic,
// whatever F): 3.5-5.5% of the operations bound. This design issues 27 an
// alive libor at F = 1.
//
// Design (lmm_sweep.cuh has the shared pieces; lmm_stochvol_products.cu
// the same design with the stoch-vol local factor):
//   * one thread a path; its forward curve lives in registers, K = n
//     libors unrolled at compile time (each (K, F, R) is its own build,
//     ops/_products.py::sweep_variant), so the curve never touches memory.
//     At 80 libors that is about 120 registers, 2 blocks an SM. Lane groups
//     of 2, 4 and 8 lanes a path (the rates split over the lanes, the
//     running sums as shuffle scans) were measured and not kept: at the
//     calibration's B = 1 two lanes came within 1% of one, a gap smaller
//     than the spread between runs; at B = 87, and with 4 or 8 lanes at
//     both shapes, they lost to the shuffles' issue slots (PERF.md, PR 5);
//   * the drift's running sums are one addition after another over the
//     libors; N's fixing is a select of the register holding L_s;
//   * rows are swept in chunks of R (8 at one factor, 4 above): a chunk
//     whose libors are all dead is skipped by a warp-uniform branch, and no
//     branch splits a chunk, so the scheduler overlaps its rows' divides
//     and loads;
//   * a block (256 threads, 256 paths) stages its parameter set into
//     shared memory with bulk asynchronous copies (TMA) on an mbarrier: the
//     scalars, (L0, delta) per libor and the loadings step-major
//     [S][C][NP][V] (19 KB at the ATM shape), packed by the wrapper;
//   * the grid is (path tile, B) with B fastest, so the 87 parameter sets of
//     the FD Jacobian read one tile's normals from L2;
//   * collection: the running bond product and annuity over the periods
//     the step's swaps span, products visited in order of their end period;
//   * the deterministic float64 path reduction of lmm_sweep.cuh into
//     partials[B, tiles, P + E]; the wrapper sums tiles in float64. No
//     atomics. Paths past num_paths read no z and contribute 0.
// No tensor cores: the contractions have depth F <= 8 inside a per-path
// recurrence, and TF32 would break the precision contract (float32 path
// data, float64 reductions). No fast math: IEEE division throughout.

#include "lmm_sweep.cuh"

namespace {

using namespace lmm_sweep;

constexpr int K = LMM_K;
constexpr int F = LMM_F;
constexpr int kRows = LMM_R;             // rows a chunk of the drift sweep

__global__ void __launch_bounds__(kThreads)
lmm_atm_products_kernel(const float* __restrict__ z, long long ldz,
                        const float* __restrict__ packed, int width,
                        const int* __restrict__ step_event,
                        const int* __restrict__ step_first,
                        const int* __restrict__ order,
                        const int* __restrict__ prod_m,
                        const float* __restrict__ prod_k,
                        double* __restrict__ partials, int S, int P, int E,
                        int num_paths, int B, int displaced) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = P + E;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  double* red = reinterpret_cast<double*>(smem_raw + 16);       // [kWarps][R]
  float* set = reinterpret_cast<float*>(red + kWarps * R);      // [width]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x % B;
  const int tile = blockIdx.x / B;
  const long long path = static_cast<long long>(tile) * kThreads + tid;
  const bool valid = path < num_paths;

  for (int r = tid; r < kWarps * R; r += kThreads) red[r] = 0.0;
  stage(set, packed + static_cast<size_t>(b) * width,
        static_cast<unsigned>(width) * sizeof(float), bar);

  const float dt = set[0];
  const float sqrt_dt = set[1];
  const float disp = set[2];
  const float2* cst = reinterpret_cast<const float2*>(set + 8);  // [kNP]
  const float* tab = set + 8 + 2 * kNP;              // [S][kC][kNP][kV]

  float L[K];
#pragma unroll
  for (int r = 0; r < K; ++r) L[r] = cst[r].x;
  float N = 1.0f;

  for (int s = 0; s <= S; ++s) {
    const int ev = step_event[s];
    if (ev >= 0) {
      // collection at the START of the exercise step (engine ordering)
      const float inv_n = 1.0f / N;
      const double v = warp_path_sum(valid ? static_cast<double>(inv_n)
                                           : 0.0);
      if (lane == 0) red[warp * R + P + ev] = v;
      const int q1 = step_first[s + 1];
      int q = step_first[s];
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
        // value the products whose last period is r: payoff / N
        for (; q < q1 && end == r;) {                      // warp-uniform
          const int k = order[q];
          float payoff = 1.0f - cp - prod_k[k] * ann;
          payoff = (payoff < 0.0f) ? 0.0f : payoff;
          const double pv = warp_path_sum(
              valid ? static_cast<double>(payoff * inv_n) : 0.0);
          if (lane == 0) red[warp * R + k] = pv;
          if (++q < q1) end = s + prod_m[order[q]] - 1;
        }
      }
    }
    if (s == S) break;

    float w[F];
    const float* zs = z + static_cast<long long>(s) * F * ldz + path;
#pragma unroll
    for (int f = 0; f < F; ++f) w[f] = valid ? sqrt_dt * zs[f * ldz] : 0.0f;

    // spot account accrues period s at its fixing L_s
    N = N * (1.0f + cst[s].y * libor_at(L, s));

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
        const float d = cst[r].y;
        const float Li = L[r];
        // the divide is taken on every row of the chunk, then masked: a
        // select, not a branch that would split the chunk around the
        // divide's slow path
        const float m = d / (1.0f + d * Li);
        const float mt = alive ? m : 0.0f;
        const float lf = Li + disp;
        float v[kFP];
        load_loadings(tab, s, r, v);
        float mu = 0.0f;
        float diffusion = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float lam = displaced ? v[f] * lf : v[f];
          run[f] = run[f] + mt * lam;
          mu = mu + lam * run[f];
          diffusion = diffusion + lam * w[f];
        }
        if (alive) {
          L[r] = clamp_keep_nan(Li + mu * dt + diffusion, -1.0e3f, 1.0e3f);
        }
      }
    }
  }

  __syncthreads();
  double* out =
      partials + (static_cast<size_t>(b) * (gridDim.x / B) + tile) * R;
  for (int r = tid; r < R; r += kThreads) {
    double acc = red[r];
    for (int wi = 1; wi < kWarps; ++wi) acc += red[wi * R + r];
    out[r] = acc;
  }
}

}  // namespace

extern "C" {

// The instantiation of this library: K, F, R for which = 0, 1, 2.
int lmm_atm_products_variant(int which) {
  const int v[3] = {K, F, kRows};
  return (which >= 0 && which < 3) ? v[which] : -1;
}

// Launches on `stream` without synchronising; returns the launch's error.
cudaError_t lmm_atm_products_launch(
    const float* z, long long ldz, const float* packed, int width,
    const int* step_event, const int* step_first, const int* order,
    const int* prod_m, const float* prod_k, double* partials, int n, int S,
    int P, int E, int num_paths, int B, int displaced, cudaStream_t stream) {
  if (n != K || S < 1 || S >= n || P < 1 || E < 1 || num_paths < 1 ||
      B < 1 || width != 8 + 2 * kNP + S * kC * kNP * kV ||
      !stageable(packed, width)) {
    return cudaErrorInvalidValue;
  }
  const long long tiles = (num_paths + kThreads - 1) / kThreads;
  if (tiles * B > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(P + E, width);
  cudaError_t err = cudaFuncSetAttribute(
      lmm_atm_products_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lmm_atm_products_kernel<<<static_cast<unsigned>(tiles * B), kThreads, smem,
                            stream>>>(
      z, ldz, packed, width, step_event, step_first, order, prod_m, prod_k,
      partials, S, P, E, num_paths, B, displaced);
  return cudaGetLastError();
}

const char* lmm_atm_products_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
