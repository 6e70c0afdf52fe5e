"""Brownian increments from the reference benchmarks' own random stream.

Counterpart of ``finmath_tpu.models.brownian_motion``. This slice ports
only ``finmath_mersenne_increments``: the bit-exact realization of
finmath-lib's ``BrownianMotionFromMersenneRandomNumbers``, which the
stoch-vol benchmark calibration injects into the valuation engine. The
Brownian-motion classes (device, device-RNG-to-host and host LCG/MT
drivers) come with the vector-engine slice.
"""

from __future__ import annotations

import numpy as np

from ..native.host_rng import HostRandomGenerator


def finmath_mersenne_increments(dts: np.ndarray, num_factors: int,
                                num_paths: int, seed: int,
                                dtype=np.float32) -> np.ndarray:
    """Bit-exact reconstruction of finmath-lib's
    ``BrownianMotionFromMersenneRandomNumbers`` increment realization:
    ``[steps, factors, paths]`` Brownian increments, increment
    ``(t, f, p) = AS241_icdf(u) * sqrt(dt_t)`` where the uniforms ``u``
    come from ONE sequential commons-math3 MersenneTwister stream consumed
    in finmath's loop order — path OUTER, then time, then factor
    (``doGenerateBrownianMotion()``; the reference injects this Brownian
    at LIBORMarketModelCalibrationTest.java:267). Because paths are
    independent subsequences of the stream, the first k paths of an
    n-path realization equal the k-path realization exactly.

    Generation is in float64 like finmath's; ``dtype=float32`` (default)
    reproduces what the device factory stores, ``float64`` the host leg.
    """
    dts = np.asarray(dts, dtype=np.float64)
    steps = len(dts)
    gen = HostRandomGenerator(seed, "finmath_mersenne")
    # one sequential stream, path-major: normals[p, t, f]
    z = gen.normals_f64(num_paths * steps * num_factors).reshape(
        num_paths, steps, num_factors)
    z *= np.sqrt(dts)[None, :, None]
    return np.ascontiguousarray(z.transpose(1, 2, 0)).astype(dtype)
