// What the two LMM products kernels (lmm_atm_products.cu,
// lmm_stochvol_products.cu) share: the staging of one parameter set into
// shared memory, the loadings' layout, the NaN-keeping clamps and the
// deterministic path reduction.
//
// One thread carries one path; its forward curve, K libors, lives in
// registers, the sweep over it unrolled at compile time. Every running sum
// over the libors is taken one addition after another from libor 0 on;
// ops/_products.py (running_sums, bond_prefix) takes the same additions in
// the same order in the plain versions. The two products sources are
// built with -fmad=false (ops/_products.py::SWEEP_FLAGS), so nvcc fuses no
// multiply and the add after it into one FMA: each operation rounds once,
// as in the plain versions, and a launch's float64 partials equal the plain
// versions' (_products.tile_partials) bit for bit.
//
// Each launch runs a library built for one instantiation: nvcc is given
// LMM_K (libors) and LMM_F (factors), and for the products kernels LMM_R
// (rows of the drift sweep a chunk), by ops/_cuda_build.py, which the
// wrappers call with what ops/_products.py::sweep_variant (products) or
// ops/_swaption_paths.py::pricer_variant (the single-swaption pricers,
// lmm_swaption_paths.cu) picks. The pricers use the helpers and the table
// layout below, not the path reduction.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#if !defined(LMM_K) || !defined(LMM_F)
#error "build with -DLMM_K and -DLMM_F"
#endif

namespace lmm_sweep {

constexpr int kThreads = 256;                 // threads (paths) a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFactors = 8;
constexpr unsigned kFull = 0xffffffffu;

static_assert(LMM_K >= 1 && LMM_K <= 128, "1 to 128 libors");
static_assert(LMM_F >= 1 && LMM_F <= kMaxFactors, "1 to 8 factors");
#ifdef LMM_R
static_assert(LMM_R >= 1, "a chunk is at least one row");
#endif

// The libors padded to a whole float4 of per-libor constants.
constexpr int kNP = (LMM_K + 3) / 4 * 4;

// The loadings of one (step, libor) are F floats padded to FP = 1, 2, 4 or
// 8, stored as C chunks of V = min(FP, 4) floats: [S][C][NP][V], so a thread
// reads its libor's loadings with C vector loads at an immediate offset.
constexpr int kFP = LMM_F == 1 ? 1 : LMM_F == 2 ? 2 : LMM_F <= 4 ? 4 : 8;
constexpr int kV = kFP < 4 ? kFP : 4;
constexpr int kC = kFP / kV;

// NaN-keeping clamp and min (as torch.clamp, jnp.clip and jnp.minimum
// keep NaN): max.NaN / min.NaN return NaN when an operand is NaN.
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(lo));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(y), "f"(hi));
  return y;
}

__device__ __forceinline__ float min_keep_nan(float x, float hi) {
  float y;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(hi));
  return y;
}

// The loadings of (step s, libor i), F floats, from the staged table.
__device__ __forceinline__ void load_loadings(const float* tab, int s, int i,
                                              float (&v)[kFP]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float* p = tab + (static_cast<size_t>(s * kC + c) * kNP + i) * kV;
    if constexpr (kV == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[4 * c] = q.x; v[4 * c + 1] = q.y; v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    } else if constexpr (kV == 2) {
      const float2 q = *reinterpret_cast<const float2*>(p);
      v[0] = q.x; v[1] = q.y;
    } else {
      v[0] = *p;
    }
  }
}

// The forward rate L[i] of the curve in registers, i known only at run time:
// a select over the unrolled rows (an indexed register array would go to
// local memory).
__device__ __forceinline__ float libor_at(const float (&L)[LMM_K], int i) {
  float v = 0.0f;
#pragma unroll
  for (int r = 0; r < LMM_K; ++r) {
    if (r == i) v = L[r];
  }
  return v;
}

// Sum over the 32 paths of a warp of one value per path, in a fixed order;
// the sum is valid in lane 0.
__device__ __forceinline__ double warp_path_sum(double v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned, which
// the launchers check) from global to shared memory with bulk asynchronous
// copies (TMA) completed on the mbarrier `bar`; every thread of the block
// returns once they landed.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      unsigned bytes, uint64_t* bar) {
  constexpr unsigned kChunk = 16384;
  const unsigned bar_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(bar));
  const unsigned dst_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar_addr), "r"(bytes)
                 : "memory");
    for (unsigned off = 0; off < bytes; off += kChunk) {
      const unsigned len = bytes - off < kChunk ? bytes - off : kChunk;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(dst_addr + off),
          "l"(reinterpret_cast<unsigned long long>(src) + off), "r"(len),
          "r"(bar_addr)
          : "memory");
    }
  }
  __syncthreads();
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar_addr)
        : "memory");
  }
}

// Whether a packed parameter table of `width` floats a set can be staged:
// the table 16-byte aligned and every set a whole number of 16-byte chunks
// (cp.async.bulk's requirement on addresses and sizes).
__host__ inline bool stageable(const float* packed, int width) {
  return reinterpret_cast<uintptr_t>(packed) % 16 == 0 && width % 4 == 0;
}

// Shared memory of a block: the mbarrier, the per-warp path sums [kWarps][R]
// (float64), then the staged parameter set (`width` floats).
__host__ __device__ inline size_t shared_bytes(int rows, int width) {
  return 16 + static_cast<size_t>(kWarps) * rows * sizeof(double) +
         static_cast<size_t>(width) * sizeof(float);
}

}  // namespace lmm_sweep
