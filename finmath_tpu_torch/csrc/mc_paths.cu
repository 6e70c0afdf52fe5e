// Monte-Carlo Black-Scholes path kernels: European and arithmetic-average
// Asian call payoffs, each path's normals drawn in the kernel.
//
// Replaces finmath_tpu/ops/kernels.py::_bs_kernel (the Pallas kernel behind
// bs_paths_kernel / mc_european_call_price_pallas) and ::_asian_kernel
// (asian_paths_kernel / mc_asian_call_price_pallas); the device function
// philox::normals4 (philox.cuh) replaces the helper _draw_normal_pair. A
// third launcher,
// philox_normals, writes the normals the path kernels draw, so that they
// can be checked against the plain generator (ops/kernels.py::normal_pairs)
// bit for bit. No pricing path calls it.
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
// Design for Hopper: one thread is one path, a block 256 paths, the grid
// exactly covers num_paths (the tail masked), so no padding enters the
// mean. The state (log S, the running sum, four normals) lives in
// registers; nothing but the payoff touches device memory.
//
// What bounds it: at 1M paths x 100 steps the work is 1e8 normals. Philox
// costs about 25 integer operations per normal, Box-Muller 35-40 float
// operations per normal with the accurate logf and sinf/cosf, and the Asian
// kernel's expf about 20 more per step: 6-9 G operations, about 0.1 ms at
// the 67 TFLOP/s float32 rate. The bytes are the 4 MB of payoffs, about
// 1.2 us at 3.35 TB/s. So it is bound by operations, and the issue rate of
// the transcendental pipeline and occupancy (registers per thread, paths
// per thread) are what a later change tunes; this first kernel is the
// simple, correct one.

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
                unsigned long long seed, float log_s0, float drift,
                float vol_sqrt_dt, float strike) {
  const int path = blockIdx.x * kBlock + threadIdx.x;
  if (path >= num_paths) return;
  const float drift2 = __fadd_rn(drift, drift);
  const int pairs = num_steps / 2;
  float log_s = log_s0;
  int j = 0;  // pairs done; a draw covers pairs 2d and 2d + 1
  for (; j + 1 < pairs; j += 2) {
    const float4 z = normals4(seed, path, j / 2);
    log_s = double_step(log_s, drift2, vol_sqrt_dt, z.x, z.y);
    log_s = double_step(log_s, drift2, vol_sqrt_dt, z.z, z.w);
  }
  if (j < pairs) {  // one pair left: the first half of draw j / 2
    const float4 z = normals4(seed, path, j / 2);
    log_s = double_step(log_s, drift2, vol_sqrt_dt, z.x, z.y);
    if (num_steps & 1) log_s = single_step(log_s, drift, vol_sqrt_dt, z.z);
  } else if (num_steps & 1) {
    const float4 z = normals4(seed, path, j / 2);
    log_s = single_step(log_s, drift, vol_sqrt_dt, z.x);
  }
  payoff[path] = fmaxf(__fsub_rn(expf(log_s), strike), 0.0f);
}

__global__ void __launch_bounds__(kBlock)
asian_paths_kernel(float* __restrict__ payoff, int num_paths, int num_steps,
                   unsigned long long seed, float log_s0, float drift,
                   float vol_sqrt_dt, float strike) {
  const int path = blockIdx.x * kBlock + threadIdx.x;
  if (path >= num_paths) return;
  float log_s = log_s0;
  float sum_s = 0.0f;
  for (int i = 0; i < num_steps; i += 4) {
    const float4 z4 = normals4(seed, path, i / 4);
    const float z[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < num_steps) {
        log_s = single_step(log_s, drift, vol_sqrt_dt, z[k]);
        sum_s = __fadd_rn(sum_s, expf(log_s));
      }
    }
  }
  const float avg = __fdiv_rn(sum_s, static_cast<float>(num_steps));
  payoff[path] = fmaxf(__fsub_rn(avg, strike), 0.0f);
}

__global__ void __launch_bounds__(kBlock)
philox_normals_kernel(float* __restrict__ out, int num_paths, int draws,
                      unsigned long long seed) {
  const int path = blockIdx.x * kBlock + threadIdx.x;
  if (path >= num_paths) return;
  for (int d = 0; d < draws; ++d) {
    const float4 z = normals4(seed, path, d);
    const size_t row = static_cast<size_t>(4) * d;
    out[(row + 0) * num_paths + path] = z.x;
    out[(row + 1) * num_paths + path] = z.y;
    out[(row + 2) * num_paths + path] = z.z;
    out[(row + 3) * num_paths + path] = z.w;
  }
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
      payoff, num_paths, num_steps, seed, log_s0, drift, vol_sqrt_dt, strike);
  return cudaGetLastError();
}

cudaError_t mc_asian_paths_launch(float* payoff, int num_paths, int num_steps,
                                  unsigned long long seed, float log_s0,
                                  float drift, float vol_sqrt_dt,
                                  float strike, cudaStream_t stream) {
  if (num_paths < 1 || num_steps < 1) return cudaErrorInvalidValue;
  asian_paths_kernel<<<blocks_for(num_paths), kBlock, 0, stream>>>(
      payoff, num_paths, num_steps, seed, log_s0, drift, vol_sqrt_dt, strike);
  return cudaGetLastError();
}

cudaError_t mc_philox_normals_launch(float* out, int num_paths, int draws,
                                     unsigned long long seed,
                                     cudaStream_t stream) {
  if (num_paths < 1 || draws < 1) return cudaErrorInvalidValue;
  philox_normals_kernel<<<blocks_for(num_paths), kBlock, 0, stream>>>(
      out, num_paths, draws, seed);
  return cudaGetLastError();
}

const char* mc_paths_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
