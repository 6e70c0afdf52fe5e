"""ctypes wrapper around the native host RNG (see host_rng.cpp).

Counterpart of ``finmath_tpu.native.host_rng``, copied: the module is
framework-free, and the port keeps its own copy. The library is built with
g++ at first use into the package's ``_build/`` directory (listed in
``.gitignore``), not beside the source.

Provides MT19937 / java.util.Random-LCG uniforms and inverse-CDF normals
for the CPU baseline Brownian legs. 'mersenne' is the canonical 32-bit
MT19937 with genrand_res53 doubles (finmath's MersenneTwister is the same
reference generator). When no C++ toolchain is available, a vectorized
NumPy implementation of the SAME generator takes over (bit-identical
uniform stream and the same AS241 normals).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("finmath_tpu_torch.native")

_SRC = Path(__file__).with_name("host_rng.cpp")
_LIB_PATH = Path(__file__).resolve().parent.parent / "_build" / "_host_rng.so"
_lock = threading.Lock()
_lib = None
_build_failed = False

ALGORITHM_MERSENNE = 0
ALGORITHM_JAVA_LCG = 1
ALGORITHM_FINMATH_MERSENNE = 2


class _CM3MersenneTwister:
    """commons-math3 MersenneTwister word/double stream — the generator
    behind finmath-lib's ``net.finmath.randomnumbers.MersenneTwister`` (a
    wrapper around org.apache.commons.math3.random.MersenneTwister), i.e.
    the exact uniform stream of the reference benchmarks'
    ``BrownianMotionFromMersenneRandomNumbers``.

    Seeding: a long seed becomes canonical ``init_by_array`` with the
    two-word key ``[(seed >> 32) & 0xffffffff, seed & 0xffffffff]``
    (commons-math3 ``setSeed(long)``). NumPy's legacy ``RandomState``
    seeded with that key array runs the canonical init_by_array + twist
    (verified in-tree against the published mt19937ar.out test vector), so
    the raw words come from numpy — vectorized AND ground-truth-canonical.

    Doubles: ``(next(26) << 26 | next(26)) * 2^-52`` (commons-math3
    BitsStreamGenerator.nextDouble()) — NOT genrand_res53.
    """

    def __init__(self, seed: int):
        key = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                       dtype=np.uint32)
        self._rs = np.random.RandomState(key)

    def words(self, n: int) -> np.ndarray:
        return self._rs.randint(0, 2 ** 32, n, dtype=np.uint32)

    def random(self, n: int) -> np.ndarray:
        """n commons-math3 nextDouble() values in [0, 1)."""
        w = self.words(2 * n).astype(np.uint64)
        hi = (w[0::2] >> np.uint64(6)) << np.uint64(26)
        lo = w[1::2] >> np.uint64(6)
        return (hi | lo).astype(np.float64) * 2.0 ** -52


# AS241 (Wichura PPND16) inverse normal CDF, vectorized. Bit-identical to
# the scalar C++ implementation in host_rng.cpp (same coefficients, same
# Horner evaluation order, all IEEE f64 ops) and to finmath-lib's
# NormalDistribution.inverseCumulativeDistribution, which implements the
# same algorithm.
def inverse_normal_cdf_as241(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    q = p - 0.5
    out = np.empty_like(p)

    central = np.abs(q) <= 0.425
    r = 0.180625 - q[central] * q[central]
    # association matters for bit-exactness: C/Java `q * num / den`
    # parses as `(q * num) / den`
    out[central] = (q[central] *
        (((((((2.5090809287301226727e+3 * r + 3.3430575583588128105e+4) * r +
              6.7265770927008700853e+4) * r + 4.5921953931549871457e+4) * r +
            1.3731693765509461125e+4) * r + 1.9715909503065514427e+3) * r +
          1.3314166789178437745e+2) * r + 3.3871328727963666080e+0)) / \
        (((((((5.2264952788528545610e+3 * r + 2.8729085735721942674e+4) * r +
              3.9307895800092710610e+4) * r + 2.1213794301586595867e+4) * r +
            5.3941960214247511077e+3) * r + 6.8718700749205790830e+2) * r +
          4.2313330701600911252e+1) * r + 1.0)

    tail = ~central
    if np.any(tail):
        qt = q[tail]
        pt = p[tail]
        rt = np.where(qt < 0.0, pt, 1.0 - pt)
        # scalar libm log, NOT np.log: numpy's SIMD log differs from the
        # platform libm by 1 ULP on rare inputs, and the native C++ path
        # uses libm — this keeps native and fallback BIT-identical.
        # p in {0, 1} maps to +-inf like the scalar implementation.
        import math

        rt = np.fromiter(
            (math.log(x) if x > 0.0 else -math.inf for x in rt),
            dtype=np.float64, count=len(rt))
        rt = np.sqrt(-rt)
        near = rt <= 5.0
        v = np.empty_like(rt)
        r1 = rt[near] - 1.6
        v[near] = (
            (((((((7.74545014278341407640e-4 * r1 + 2.27238449892691845833e-2) * r1 +
                  2.41780725177450611770e-1) * r1 + 1.27045825245236838258e+0) * r1 +
                3.64784832476320460504e+0) * r1 + 5.76949722146069140550e+0) * r1 +
              4.63033784615654529590e+0) * r1 + 1.42343711074968357734e+0) /
            (((((((1.05075007164441684324e-9 * r1 + 5.47593808499534494600e-4) * r1 +
                  1.51986665636164571966e-2) * r1 + 1.48103976427480074590e-1) * r1 +
                6.89767334985100004550e-1) * r1 + 1.67638483018380384940e+0) * r1 +
              2.05319162663775882187e+0) * r1 + 1.0))
        r2 = rt[~near] - 5.0
        v[~near] = (
            (((((((2.01033439929228813265e-7 * r2 + 2.71155556874348757815e-5) * r2 +
                  1.24266094738807843860e-3) * r2 + 2.65321895265761230930e-2) * r2 +
                2.96560571828504891230e-1) * r2 + 1.78482653991729133580e+0) * r2 +
              5.46378491116411436990e+0) * r2 + 6.65790464350110377720e+0) /
            (((((((2.04426310338993978564e-15 * r2 + 1.42151175831644588870e-7) * r2 +
                  1.84631831751005468180e-5) * r2 + 7.86869131145613259100e-4) * r2 +
                1.48753612908506148525e-2) * r2 + 1.36929880922735805310e-1) * r2 +
              5.99832206555887937690e-1) * r2 + 1.0))
        v[np.isinf(rt)] = np.inf
        out[tail] = np.where(qt < 0.0, -v, v)
    return out


class _MT19937Res53:
    """Canonical 32-bit MT19937 (init_genrand seeding, genrand_res53
    doubles) vectorized in NumPy — BIT-IDENTICAL to the native C++
    'mersenne' generator (std::mt19937 + res53), so the fallback produces
    the same stream as the native path instead of a different generator
    under the same name."""

    _N, _M = 624, 397
    _MATRIX_A = np.uint32(0x9908B0DF)
    _UPPER = np.uint32(0x80000000)
    _LOWER = np.uint32(0x7FFFFFFF)

    def __init__(self, seed: int):
        mt = np.empty(self._N, dtype=np.uint32)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self._N):
            prev = int(mt[i - 1])
            mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
        self._mt = mt
        self._buf = np.empty(0, dtype=np.uint32)

    def _twist(self) -> np.ndarray:
        """One full twist + tempering: 624 fresh 32-bit outputs."""
        mt, N, M = self._mt, self._N, self._M
        new = np.empty(N, dtype=np.uint32)
        # the reference C loop reads updated entries for i >= N-M, so the
        # vectorization happens in the same three chunks it uses
        y = (mt[: N - M] & self._UPPER) | (mt[1 : N - M + 1] & self._LOWER)
        new[: N - M] = mt[M:] ^ (y >> np.uint32(1)) \
            ^ np.where(y & np.uint32(1), self._MATRIX_A, np.uint32(0))
        # second chunk reads new[kk - (N-M)] — a sequential dependency at
        # lag N-M — so it is vectorized in lag-sized sub-chunks whose
        # sources were fully written by the preceding sub-chunk
        lag = N - M
        for lo in range(N - M, N - 1, lag):
            hi = min(lo + lag, N - 1)
            y = (mt[lo:hi] & self._UPPER) | (mt[lo + 1 : hi + 1] & self._LOWER)
            new[lo:hi] = new[lo - lag : hi - lag] ^ (y >> np.uint32(1)) \
                ^ np.where(y & np.uint32(1), self._MATRIX_A, np.uint32(0))
        y = (mt[N - 1] & self._UPPER) | (new[0] & self._LOWER)
        new[N - 1] = new[M - 1] ^ (y >> np.uint32(1)) \
            ^ (self._MATRIX_A if y & np.uint32(1) else np.uint32(0))
        self._mt = new
        out = new.copy()
        out ^= out >> np.uint32(11)
        out ^= (out << np.uint32(7)) & np.uint32(0x9D2C5680)
        out ^= (out << np.uint32(15)) & np.uint32(0xEFC60000)
        out ^= out >> np.uint32(18)
        return out

    def _words(self, n: int) -> np.ndarray:
        chunks = [self._buf]
        have = len(self._buf)
        while have < n:
            w = self._twist()
            chunks.append(w)
            have += len(w)
        all_w = np.concatenate(chunks)
        self._buf = all_w[n:]
        return all_w[:n]

    def random(self, n: int) -> np.ndarray:
        """n genrand_res53 doubles in [0, 1)."""
        w = self._words(2 * n)
        a = (w[0::2] >> np.uint32(5)).astype(np.float64)   # 27 bits
        b = (w[1::2] >> np.uint32(6)).astype(np.float64)   # 26 bits
        return (a * 67108864.0 + b) * (1.0 / 9007199254740992.0)


def _load() -> ctypes.CDLL | None:
    """Compile (once) and load the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
                # -ffp-contract=off: no FMA fusion in the AS241 Horner
                # chains — each multiply/add rounds individually, exactly
                # like Java double arithmetic (and the NumPy fallback), so
                # native and fallback normals are BIT-identical. This is
                # the same bit-parity lever as the reference's
                # `nvcc -fmad false` (JCudaUtils.java:69-70).
                # built under a private name and renamed into place, so
                # processes that build at once never load a partial file
                _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
                tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
                cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off",
                       "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                os.replace(tmp, _LIB_PATH)
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.rng_create.restype = ctypes.c_void_p
            lib.rng_create.argtypes = [ctypes.c_int, ctypes.c_uint64]
            lib.rng_destroy.argtypes = [ctypes.c_void_p]
            lib.rng_fill_uniform.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
            lib.rng_fill_normal.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_size_t, ctypes.c_double]
            lib.rng_fill_uniform_f64.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_size_t]
            lib.rng_fill_normal_f64.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_size_t, ctypes.c_double]
            lib.rng_inverse_normal_cdf.restype = ctypes.c_double
            lib.rng_inverse_normal_cdf.argtypes = [ctypes.c_double]
            _lib = lib
        except Exception as exc:  # toolchain missing, compile error, ...
            logger.warning("native host RNG unavailable (%s); using NumPy fallback", exc)
            _build_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


class HostRandomGenerator:
    """Sequential host RNG with finmath-compatible algorithms.

    algorithm: "mersenne" (MT19937, the BrownianMotionLazyInit leg),
    "java" (java.util.Random 48-bit LCG, the BrownianMotionJavaRandom leg),
    or "finmath_mersenne" (commons-math3 MT19937 + 26|26-bit doubles — the
    bit-exact uniform stream of finmath-lib's MersenneTwister, hence of the
    reference benchmarks' BrownianMotionFromMersenneRandomNumbers).
    """

    def __init__(self, seed: int, algorithm: str = "mersenne"):
        self.seed = int(seed)
        self.algorithm = algorithm
        algo_id = {"mersenne": ALGORITHM_MERSENNE,
                   "java": ALGORITHM_JAVA_LCG,
                   "finmath_mersenne": ALGORITHM_FINMATH_MERSENNE}[algorithm]
        lib = _load()
        if lib is not None:
            self._lib = lib
            self._handle = lib.rng_create(algo_id, ctypes.c_uint64(self.seed))
            self._numpy = None
        else:
            if algorithm == "java":
                # the NumPy fallback cannot reproduce java.util.Random's
                # LCG; refusing beats silently returning a different stream
                raise RuntimeError(
                    "algorithm='java' requires the native host RNG "
                    "(g++ unavailable or build failed); use "
                    "algorithm='mersenne' or install a C++ toolchain"
                )
            self._lib = None
            self._handle = None
            # bit-identical to the corresponding native stream — NOT
            # numpy's SeedSequence-seeded MT19937, whose stream would
            # differ under the same name
            if algorithm == "finmath_mersenne":
                self._numpy = _CM3MersenneTwister(self.seed)
            else:
                self._numpy = _MT19937Res53(self.seed)

    def __del__(self):
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.rng_destroy(handle)
            self._handle = None

    def normals(self, n: int, stddev: float = 1.0) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        if self._lib is not None:
            self._lib.rng_fill_normal(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n, float(stddev),
            )
        else:
            # same uniform stream AND same AS241 ICDF as the native path
            # (bit-identical). Clamp the 2^-53-probability exact 0 away
            # from -inf like the native path does.
            u = np.maximum(self._numpy.random(n), 2.0 ** -54)
            out[:] = (inverse_normal_cdf_as241(u) * stddev).astype(np.float32)
        return out

    def normals_f64(self, n: int, stddev: float = 1.0) -> np.ndarray:
        """Double-precision normals — the exact values finmath's Brownian
        generation computes before any factory float cast."""
        out = np.empty(n, dtype=np.float64)
        if self._lib is not None:
            self._lib.rng_fill_normal_f64(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                n, float(stddev),
            )
        else:
            u = np.maximum(self._numpy.random(n), 2.0 ** -54)
            out[:] = inverse_normal_cdf_as241(u) * stddev
        return out

    def uniforms(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        if self._lib is not None:
            self._lib.rng_fill_uniform(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
            )
        else:
            out[:] = self._numpy.random(n).astype(np.float32)
        return out

    def uniforms_f64(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        if self._lib is not None:
            self._lib.rng_fill_uniform_f64(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n
            )
        else:
            out[:] = self._numpy.random(n)
        return out


def inverse_normal_cdf(p: float) -> float:
    """AS241 inverse normal CDF: the native library if available, else the
    bit-identical NumPy version above."""
    lib = _load()
    if lib is None:
        return float(inverse_normal_cdf_as241(np.asarray([float(p)]))[0])
    return float(lib.rng_inverse_normal_cdf(float(p)))
