// Monte-Carlo Black-Scholes path kernels: European and arithmetic-average
// Asian call payoffs, each path's normals drawn in the kernel.
//
// Replaces finmath_tpu/ops/kernels.py::_bs_kernel (the Pallas kernel behind
// bs_paths_kernel / mc_european_call_price_pallas) and ::_asian_kernel
// (asian_paths_kernel / mc_asian_call_price_pallas); the device function
// philox::normals4 (philox.cuh) replaces the helper _draw_normal_pair. Two
// check-only launchers, which no pricing path calls: philox_normals writes
// the normals the path kernels draw, and box_muller_parts the Box-Muller
// radius and angle of every value a word's top 24 bits can take, so that
// both can be held against the plain generator (ops/kernels.py) bit for
// bit.
//
// Random numbers: the Philox4x32-10 and Box-Muller stream of philox.cuh;
// step i of a path uses normal i, so a pair of steps takes the cosine and
// sine of one Box-Muller pair (both outputs used, as in the Pallas kernel)
// and an odd last step the cosine of the next. expf is the accurate library
// function (no fast math). Every float operation of the path arithmetic is
// written with the explicit-rounding intrinsics (__fadd_rn, __fmul_rn), so
// that nvcc contracts nothing into an FMA and a launch reproduces the plain
// PyTorch version on the card bit for bit.
//
// Per path, in float32: log S starts at log S0; a pair of steps adds
// (drift + drift) + vol_sqrt_dt * (z1 + z2) (kernels.py:109-111), an odd
// last step drift + vol_sqrt_dt * z1 (:119-121); the European payoff is
// max(exp(log S) - K, 0). The Asian kernel updates log S one step at a time
// and adds exp(log S) to a running sum after each (:197-216); it pays
// max(sum / n - K, 0). Each kernel writes the float32 payoff of each path,
// [num_paths]; the wrapper takes the float64 mean and the discount.
//
// Layout: one thread is one path, a block 256 paths, the grid exactly
// covers num_paths (the tail masked), so no padding enters the mean. The
// state (log S, the running sum, four normals) lives in registers; nothing
// but the payoff touches device memory. The draws of four steps run in an
// unpredicated loop, a ragged last draw after it.
//
// What bounds it, measured on an H100 (SXM, 700 W, SM clock 1980 MHz
// under the launch; tools/compare_mc_kernels.py) at 1M paths x 100 steps.
// The first design took 0.2335 ms (European) and 0.2871 ms (Asian): 311
// and 383 issue slots (a scheduler's clock) a warp's draw of four normals,
// against 251 and 317 SASS instructions on a draw's path through the loop,
// so the kernels issued on 81-83% of the clocks: bound by the issue rate,
// with fewer instructions a normal the lever. Of the 251, 19 were branches
// and reconvergence barriers and about 40 guarded the library functions'
// special cases (logf's subnormal and non-finite arguments, sqrtf's, the
// Payne-Hanek reduction that cosf and sinf keep for arguments beyond
// 105615); 17 formed the Philox key schedule anew each draw; the cosine
// and the sine each picked its polynomial's coefficients with selects.
// (The compiler already shared the two functions' fast reduction, hoisted
// the counter's products that stay fixed along a path and formed each
// multiply-high/low pair with one IMAD.WIDE.) philox.cuh now writes the
// functions out without the dead paths, evaluates both polynomials once
// and reads the key schedule from the constant bank (a kernel parameter),
// and the Asian draws run unpredicated: 160 and 203 instructions a draw,
// 0.1600 and 0.1956 ms, every payoff bit-equal to the first design's. They
// issue on about 75% of the clocks. Two draws a pass, the next draw's
// Philox beside this draw's Box-Muller, a grid of the resident blocks
// striding over the paths, and rounding the quadrant with an added 1.5 2^23
// instead of F2I (the conversion pipe) each tied or lost. The bytes are the
// 4 MB of payoffs (1.2 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using philox::normals4;

constexpr int kBlock = 256;

// log S after a pair of steps on normals z1, z2 (kernels.py:109-111)
__device__ __forceinline__ float double_step(float log_s, float drift2,
                                             float vol, float z1, float z2) {
  return __fadd_rn(__fadd_rn(log_s, drift2),
                   __fmul_rn(vol, __fadd_rn(z1, z2)));
}

// log S after one step on normal z
__device__ __forceinline__ float single_step(float log_s, float drift,
                                             float vol, float z) {
  return __fadd_rn(__fadd_rn(log_s, drift), __fmul_rn(vol, z));
}

__global__ void __launch_bounds__(kBlock)
bs_paths_kernel(float* __restrict__ payoff, int num_paths, int num_steps,
                const __grid_constant__ philox::Key key, float log_s0,
                float drift, float vol_sqrt_dt, float strike) {
  const int path = blockIdx.x * kBlock + threadIdx.x;
  if (path >= num_paths) return;
  const float drift2 = __fadd_rn(drift, drift);
  const int draws = num_steps >> 2;  // draws of four steps
  float log_s = log_s0;
  for (int d = 0; d < draws; ++d) {
    const float4 z = normals4(key, path, d);
    log_s = double_step(log_s, drift2, vol_sqrt_dt, z.x, z.y);
    log_s = double_step(log_s, drift2, vol_sqrt_dt, z.z, z.w);
  }
  const int rest = num_steps & 3;
  if (rest) {  // one, two or three steps on the first normals of a draw
    const float4 z = normals4(key, path, draws);
    if (rest == 1) {
      log_s = single_step(log_s, drift, vol_sqrt_dt, z.x);
    } else {
      log_s = double_step(log_s, drift2, vol_sqrt_dt, z.x, z.y);
      if (rest == 3) log_s = single_step(log_s, drift, vol_sqrt_dt, z.z);
    }
  }
  payoff[path] = fmaxf(__fsub_rn(expf(log_s), strike), 0.0f);
}

// One Asian step: log S moves, then exp(log S) joins the running sum.
__device__ __forceinline__ void asian_step(float& log_s, float& sum_s,
                                           float drift, float vol, float z) {
  log_s = single_step(log_s, drift, vol, z);
  sum_s = __fadd_rn(sum_s, expf(log_s));
}

__global__ void __launch_bounds__(kBlock)
asian_paths_kernel(float* __restrict__ payoff, int num_paths, int num_steps,
                   const __grid_constant__ philox::Key key, float log_s0,
                   float drift, float vol_sqrt_dt, float strike) {
  const int path = blockIdx.x * kBlock + threadIdx.x;
  if (path >= num_paths) return;
  const int draws = num_steps >> 2;  // draws of four steps
  float log_s = log_s0;
  float sum_s = 0.0f;
  for (int d = 0; d < draws; ++d) {
    const float4 z = normals4(key, path, d);
    asian_step(log_s, sum_s, drift, vol_sqrt_dt, z.x);
    asian_step(log_s, sum_s, drift, vol_sqrt_dt, z.y);
    asian_step(log_s, sum_s, drift, vol_sqrt_dt, z.z);
    asian_step(log_s, sum_s, drift, vol_sqrt_dt, z.w);
  }
  const int rest = num_steps & 3;
  if (rest) {  // one, two or three steps on the first normals of a draw
    const float4 z = normals4(key, path, draws);
    asian_step(log_s, sum_s, drift, vol_sqrt_dt, z.x);
    if (rest > 1) asian_step(log_s, sum_s, drift, vol_sqrt_dt, z.y);
    if (rest > 2) asian_step(log_s, sum_s, drift, vol_sqrt_dt, z.z);
  }
  const float avg = __fdiv_rn(sum_s, static_cast<float>(num_steps));
  payoff[path] = fmaxf(__fsub_rn(avg, strike), 0.0f);
}

__global__ void __launch_bounds__(kBlock)
philox_normals_kernel(float* __restrict__ out, int num_paths, int draws,
                      const __grid_constant__ philox::Key key) {
  const int path = blockIdx.x * kBlock + threadIdx.x;
  if (path >= num_paths) return;
  for (int d = 0; d < draws; ++d) {
    const float4 z = normals4(key, path, d);
    const size_t row = static_cast<size_t>(4) * d;
    out[(row + 0) * num_paths + path] = z.x;
    out[(row + 1) * num_paths + path] = z.y;
    out[(row + 2) * num_paths + path] = z.z;
    out[(row + 3) * num_paths + path] = z.w;
  }
}

// Check only: row 0 the radius of word m << 8, rows 1-2 the cosine and
// sine of its angle, m = i * stride for i < count (every value of w >> 8
// that a draw can see, at stride 1).
__global__ void __launch_bounds__(kBlock)
box_muller_parts_kernel(float* __restrict__ out, int count, int stride) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= count) return;
  const uint32_t w = static_cast<uint32_t>(i) * stride << 8;
  const float2 a = philox::bm_angle(w);
  out[i] = philox::bm_radius(w);
  out[count + i] = a.x;
  out[2 * static_cast<size_t>(count) + i] = a.y;
}

int blocks_for(int num_paths) { return (num_paths + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// Each launcher launches on `stream` without synchronising and returns the
// launch's error.
cudaError_t mc_bs_paths_launch(float* payoff, int num_paths, int num_steps,
                               unsigned long long seed, float log_s0,
                               float drift, float vol_sqrt_dt, float strike,
                               cudaStream_t stream) {
  if (num_paths < 1 || num_steps < 1) return cudaErrorInvalidValue;
  bs_paths_kernel<<<blocks_for(num_paths), kBlock, 0, stream>>>(
      payoff, num_paths, num_steps, philox::philox_key(seed), log_s0, drift,
      vol_sqrt_dt, strike);
  return cudaGetLastError();
}

cudaError_t mc_asian_paths_launch(float* payoff, int num_paths, int num_steps,
                                  unsigned long long seed, float log_s0,
                                  float drift, float vol_sqrt_dt,
                                  float strike, cudaStream_t stream) {
  if (num_paths < 1 || num_steps < 1) return cudaErrorInvalidValue;
  asian_paths_kernel<<<blocks_for(num_paths), kBlock, 0, stream>>>(
      payoff, num_paths, num_steps, philox::philox_key(seed), log_s0, drift,
      vol_sqrt_dt, strike);
  return cudaGetLastError();
}

cudaError_t mc_philox_normals_launch(float* out, int num_paths, int draws,
                                     unsigned long long seed,
                                     cudaStream_t stream) {
  if (num_paths < 1 || draws < 1) return cudaErrorInvalidValue;
  philox_normals_kernel<<<blocks_for(num_paths), kBlock, 0, stream>>>(
      out, num_paths, draws, philox::philox_key(seed));
  return cudaGetLastError();
}

cudaError_t mc_box_muller_parts_launch(float* out, int count, int stride,
                                       cudaStream_t stream) {
  if (count < 1 || stride < 1 ||
      static_cast<long long>(count - 1) * stride >= (1 << 24))
    return cudaErrorInvalidValue;
  box_muller_parts_kernel<<<blocks_for(count), kBlock, 0, stream>>>(
      out, count, stride);
  return cudaGetLastError();
}

const char* mc_paths_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
