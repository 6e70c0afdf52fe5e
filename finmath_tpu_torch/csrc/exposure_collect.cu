// One observation date of a netting set's exposure collection, in one
// launch: from the live forwards L[0 .. m-1] (forward e + k at T_e, m = n - e)
// and the spot numeraire N of every path, the netted value of the swaps, the
// sum of their positive parts, 1 / N(T_e), and each optionality
// underlying's remaining-swap value and par rate, written into the
// profile's [dates, ...] buffers at the date's row.
//
// Replaces no Pallas kernel. The JAX package's collector
// (finmath_tpu/models/lmm/exposure.py:659) is a jitted function that XLA
// fuses; the port's PyTorch composition of it (ops/exposure_collect.py::
// exposure_collect_reference) makes about 45 launches a date over
// [trades, paths] and [underlyings, paths] float64 temporaries: the bond
// curve, two annuity GEMMs, two gathers of the curve, the swap values,
// their netted and positive-part sums, the par rates, the finiteness sum,
// the buffer copies. This kernel reads the forwards once and writes each
// output once.
//
// The arithmetic, per path:
//   cp[0] = 1, cp[k] = cp[k-1] * (1 / (1 + d_{e+k-1} L[k-1]))   (collect type)
//   ann_t = sum_{k in [lo_t, hi_t)} (path type) d_{e+k} * (path type) cp[k+1]
//   raw_t = cp[lo_t] - cp[hi_t] - K_t ann_t                     (float64)
// for a swap v_t = coef_t raw_t, net = sum v_t, plus = sum max(v_t, 0); for
// an underlying und = raw, rate = (raw + K ann) / max(ann, 1e-12), rounded
// to the path type; inv = 1 / N (spot) or 1 / cp[m] (terminal). The curve
// is the composition's bit for bit: each of its operations rounds once
// (built with -fmad=false, ops/_products.py::SWEEP_FLAGS), the divisions
// are IEEE, and the running product runs in k order from 1 as
// torch.cumprod does along a non-innermost axis. A trade's [lo, hi) is its
// remaining pay range relative to e; its start bond is cp[lo] (1 unless it
// starts forward) and its end bond cp[hi]. The annuity is summed in k
// order with one fma a term; the composition's product takes the same
// terms plus exact zeros in cuBLAS's order, so the two differ in the last
// bits. Matured trades are not in the table: their rows in the
// composition are zeros, except where the curve is not finite, and there
// the kernel marks the path broken itself (below).
//
// A path is broken at a date, and zeroed in every output afterwards by the
// engine, where any output is not finite. In the composition a curve entry
// that is not finite in the path type reaches every annuity through the
// dense product's zeros (0 * inf); the kernel writes NaN to the netted
// value and false to the underlyings' flag on such a path, so both break
// the same paths. An underlying's flag is false where its value or rate is
// not finite, as the composition's sum of (v - v) + (s - s) is.
//
// What bounds it on an H100: device memory. At the exposure cell's shapes
// (1,048,576 paths, 40 libors, 160 swaps, 40 underlyings, float64) a date
// reads (m + 1) * 8 bytes a path and writes 24 + 40 * 16 + 1, about 0.85 GB
// a date and 33 GB over the 39 dates, about 10 ms at 3.35 TB/s.
//
// Design: one thread a path, 128 threads a block; the curve in shared
// memory laid out [k][thread] (consecutive threads on consecutive words:
// no bank conflicts), (m + 1) * 128 words a block, 40 KB at e = 1, so five
// blocks fit an SM. What is uniform across the block, the date's deltas
// and its table of rows sorted by (lo, hi), is staged into shared memory
// too, the table 64 rows at a time: every thread then reads a row at one
// shared address (a broadcast), where from device memory the rows and
// deltas missed the L1 that the forwards' stream thrashes. Past a block's
// 227 KB of shared memory (m > 223 with a float64 curve, m > 446 with a
// float32 one) the curve lives in a device-memory scratch [m + 1][paths]
// that the caller passes (exposure_collect_scratch_rows): the same layout
// with the paths as the threads, each thread reading back only what it
// wrote, so the arithmetic and its order are the same. The forwards
// are read, and the outputs written, with evict-first hints: each is
// touched once. The annuities are the answer to the curve's shared-memory
// traffic: rows that share a start lo share one running sum from lo,
// which the walk extends to each row's hi in turn and reads there. That
// sum IS the row's k-order sum (the same terms added in the same order
// from 0), so no row sums its range alone: about 106 terms a path and
// date at the cell's shapes, against about 1,440 for the rows one by one,
// plus two curve reads a row. No control flow depends on the path, so
// warps do not diverge.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;  // table rows staged at a time (<= kThreads)
constexpr int kMaxSharedBytes = 232448;  // 227 KB, an H100 block's most
constexpr int kDefaultSharedBytes = 48 * 1024;

// the table's row kinds (ops/exposure_collect.py: SWAP, UNDERLYING, MATURED);
// any other row is an underlying's
constexpr int kSwap = 0;
constexpr int kMatured = 2;

// torch.clamp_min: a NaN operand stays NaN
__device__ __forceinline__ double max_keep_nan(double a, double b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Shared memory of a block: the table chunk (kChunk int4, kChunk double2),
// the deltas [m] (float64) and, with kSharedCurve, the curve
// [m + 1][kThreads] (collect type).
template <typename CT, bool kSharedCurve>
constexpr long long shared_bytes(int m) {
  return kChunk * (16LL + 16LL) + 8LL * m +
         (kSharedCurve
              ? static_cast<long long>(m + 1) * kThreads * sizeof(CT)
              : 0LL);
}

// whether the curve of m periods fits a block's shared memory
template <typename CT>
constexpr bool curve_in_shared(int m) {
  return shared_bytes<CT, true>(m) <= kMaxSharedBytes;
}

// rows: [count] of (lo, hi, kind, underlying index); reals: [count] of
// (strike, coefficient), the coefficient 0 for an underlying. curve: the
// device-memory curve [m + 1][paths] without kSharedCurve, else unused.
template <typename PT, typename CT, bool kSharedCurve>
__global__ void __launch_bounds__(kThreads)
exposure_collect_kernel(const PT* __restrict__ L, long long ld,
                        const CT* __restrict__ N,
                        const double* __restrict__ deltas, int m,
                        const int4* __restrict__ rows,
                        const double2* __restrict__ reals, int count,
                        int spot, int paths, double* __restrict__ net,
                        double* __restrict__ plus, double* __restrict__ inv,
                        double* __restrict__ und, PT* __restrict__ rates,
                        uint8_t* __restrict__ und_finite,
                        CT* __restrict__ curve) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  int4* s_rows = reinterpret_cast<int4*>(shared_raw);
  double2* s_reals = reinterpret_cast<double2*>(s_rows + kChunk);
  double* s_d = reinterpret_cast<double*>(s_reals + kChunk);
  const int tid = threadIdx.x;
  const int p = blockIdx.x * kThreads + tid;
  // this path's curve, cp[k * stride]: in shared memory or device memory
  using Stride = std::conditional_t<kSharedCurve, int, long long>;
  CT* const cp = kSharedCurve ? reinterpret_cast<CT*>(s_d + m) + tid
                              : curve + p;
  const Stride stride = kSharedCurve ? kThreads : paths;
  // a thread past the last path stays for the block's barriers
  const bool active = p < paths;
  for (int j = tid; j < m; j += kThreads) s_d[j] = deltas[j];
  __syncthreads();

  // the bond curve; a path whose curve is not finite in the path type
  // breaks, as 0 * inf breaks every row of the composition's product
  CT c = CT(1);
  bool curve_ok = true;
  if (active) {
    cp[0] = c;
#pragma unroll 8
    for (int k = 0; k < m; ++k) {
      const CT d = static_cast<CT>(s_d[k]);
      const CT l = static_cast<CT>(__ldcs(L + k * ld + p));
      const CT r = CT(1) / (CT(1) + d * l);
      c = c * r;
      cp[(k + 1) * stride] = c;
      curve_ok = curve_ok && isfinite(static_cast<PT>(c));
    }
  }

  double v_net = 0.0;
  double s_plus = 0.0;
  bool und_ok = curve_ok;
  PT acc = PT(0);
  int k = 0;
  int group = -1;
  for (int base = 0; base < count; base += kChunk) {
    const int chunk = min(kChunk, count - base);
    __syncthreads();  // every thread is done with the last chunk
    if (tid < chunk) {
      s_rows[tid] = rows[base + tid];
      s_reals[tid] = reals[base + tid];
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < chunk; ++i) {
      const int4 row = s_rows[i];
      const double2 re = s_reals[i];
      if (row.z == kMatured) {
        const long long at = static_cast<long long>(row.w) * paths + p;
        __stcs(und + at, 0.0);
        __stcs(rates + at, PT(0));
        continue;
      }
      if (row.x != group) {  // a new start: a new running sum from lo
        group = row.x;
        k = row.x;
        acc = PT(0);
      }
      for (; k < row.y; ++k) {
        acc = fma_t(static_cast<PT>(s_d[k]),
                    static_cast<PT>(cp[(k + 1) * stride]), acc);
      }
      const double ann = static_cast<double>(acc);
      const double raw = (static_cast<double>(cp[row.x * stride]) -
                          static_cast<double>(cp[row.y * stride])) -
                         re.x * ann;
      if (row.z == kSwap) {
        const double v = re.y * raw;
        v_net += v;
        s_plus += max_keep_nan(v, 0.0);
      } else {
        const double rate = (raw + re.x * ann) / max_keep_nan(ann, 1e-12);
        const long long at = static_cast<long long>(row.w) * paths + p;
        __stcs(und + at, raw);
        __stcs(rates + at, static_cast<PT>(rate));
        und_ok = und_ok && isfinite(raw) && isfinite(rate);
      }
    }
  }
  if (!active) return;
  __stcs(net + p,
         curve_ok ? v_net : __longlong_as_double(0x7ff8000000000000LL));
  __stcs(plus + p, s_plus);
  __stcs(inv + p,
         1.0 / (spot ? static_cast<double>(N[p]) : static_cast<double>(c)));
  if (und_finite != nullptr) und_finite[p] = und_ok ? 1 : 0;
}

template <typename PT, typename CT, bool kSharedCurve>
cudaError_t launch(const void* L, long long ld, const void* N,
                   const double* deltas, int m, const int* rows,
                   const double* reals, int count, int spot, int paths,
                   double* net, double* plus, double* inv, double* und,
                   void* rates, uint8_t* und_finite, void* curve,
                   cudaStream_t stream) {
  const long long shared = shared_bytes<CT, kSharedCurve>(m);
  if (shared > kMaxSharedBytes) return cudaErrorInvalidValue;
  auto kernel = exposure_collect_kernel<PT, CT, kSharedCurve>;
  if (shared > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((paths + kThreads - 1) /
                                                kThreads);
  kernel<<<blocks, kThreads, static_cast<size_t>(shared), stream>>>(
      static_cast<const PT*>(L), ld, static_cast<const CT*>(N), deltas, m,
      reinterpret_cast<const int4*>(rows),
      reinterpret_cast<const double2*>(reals), count, spot, paths, net,
      plus, inv, und, static_cast<PT*>(rates), und_finite,
      static_cast<CT*>(curve));
  return cudaGetLastError();
}

// the curve in shared memory where it fits, else in the caller's scratch
template <typename PT, typename CT>
cudaError_t launch_curve(const void* L, long long ld, const void* N,
                         const double* deltas, int m, const int* rows,
                         const double* reals, int count, int spot, int paths,
                         double* net, double* plus, double* inv, double* und,
                         void* rates, uint8_t* und_finite, void* curve,
                         cudaStream_t stream) {
  if (curve_in_shared<CT>(m)) {
    return launch<PT, CT, true>(L, ld, N, deltas, m, rows, reals, count,
                                spot, paths, net, plus, inv, und, rates,
                                und_finite, nullptr, stream);
  }
  if (curve == nullptr) return cudaErrorInvalidValue;
  return launch<PT, CT, false>(L, ld, N, deltas, m, rows, reals, count,
                               spot, paths, net, plus, inv, und, rates,
                               und_finite, curve, stream);
}

}  // namespace

extern "C" {

// Launches one date on `stream` without synchronising; returns the
// launch's error. path_bytes / collect_bytes: 4 (float32) or 8 (float64),
// the pairs (4, 8), (8, 8) and (4, 4). L: [m, paths] in the path type, row
// stride ld elements, paths contiguous; N: [paths] in the collect type;
// deltas: [m] float64 from forward e on; rows int32 [count, 4] and reals
// float64 [count, 2], 16-byte aligned; net, plus, inv: [paths] float64; und
// (float64), rates (path type): [K, paths]; und_finite: [paths] bytes; the
// last three null when the table holds no underlying; curve: a [rows][paths]
// scratch in the collect type where exposure_collect_scratch_rows gives
// rows > 0, else null.
cudaError_t exposure_collect_launch(int path_bytes, int collect_bytes,
                                    const void* L, long long ld,
                                    const void* N, const double* deltas,
                                    int m, const int* rows,
                                    const double* reals, int count, int spot,
                                    int paths, double* net, double* plus,
                                    double* inv, double* und, void* rates,
                                    uint8_t* und_finite, void* curve,
                                    cudaStream_t stream) {
  if (m < 1 || count < 0 || paths < 1 || ld < paths ||
      paths > 0x7fffffff - kThreads) {
    return cudaErrorInvalidValue;
  }
  if (path_bytes == 4 && collect_bytes == 8) {
    return launch_curve<float, double>(
        L, ld, N, deltas, m, rows, reals, count, spot, paths, net, plus, inv,
        und, rates, und_finite, curve, stream);
  }
  if (path_bytes == 8 && collect_bytes == 8) {
    return launch_curve<double, double>(
        L, ld, N, deltas, m, rows, reals, count, spot, paths, net, plus, inv,
        und, rates, und_finite, curve, stream);
  }
  if (path_bytes == 4 && collect_bytes == 4) {
    return launch_curve<float, float>(
        L, ld, N, deltas, m, rows, reals, count, spot, paths, net, plus, inv,
        und, rates, und_finite, curve, stream);
  }
  return cudaErrorInvalidValue;
}

// The rows of the device-memory curve that a launch of m periods needs: m + 1
// where the curve does not fit a block's shared memory, else 0.
int exposure_collect_scratch_rows(int collect_bytes, int m) {
  const bool shared = collect_bytes == 4 ? curve_in_shared<float>(m)
                                         : curve_in_shared<double>(m);
  return shared ? 0 : m + 1;
}

const char* exposure_collect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
