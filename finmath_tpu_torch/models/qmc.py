"""Quasi-Monte-Carlo Brownian increments: Sobol low-discrepancy points +
Brownian-bridge path construction.

Beyond-reference capability (the reference samples pseudo-random XORWOW,
BrownianMotionCudaWithRandomVariableCuda.java:159): the documented
bottleneck of the stoch-vol benchmark basin is heavy-tailed Monte-Carlo
noise — a single tail path can dominate a low-strike smile quote
(BENCHMARKS.md seed-bootstrap study: one seed's rms19 blew up 1000x
through exactly that mechanism). Low-discrepancy sequences attack the
noise itself: Sobol points stratify the unit cube, and the Brownian
bridge routes the best-stratified (lowest-index) dimensions to the
COARSE structure of each path — terminal level first, then recursive
midpoints — so the payoff-relevant degrees of freedom converge at
near-QMC rate while the fine wiggles ride the higher dimensions.

Generation is host-side (scipy's Sobol direction numbers, up to 21,201
dimensions) and feeds the engines through the injected-increments mode
(`LMMValuationEngine(increments=...)`), which composes with the float64
parity engine. Owen scrambling
(``scramble=True``, the default) makes the estimator unbiased and gives
independent randomizations per seed — the honest way to measure a
QMC seed spread. ``antithetic=True`` mirrors scrambled points pairwise
at generation time.

Counterpart of ``finmath_tpu.models.qmc``, copied: host NumPy and scipy,
no framework. The normals come from the port's own
``native.host_rng.inverse_normal_cdf_as241``; the output equals the JAX
module's bit for bit (``tests/test_torch_qmc.py``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["sobol_brownian_increments", "brownian_bridge_plan"]


def brownian_bridge_plan(times: np.ndarray):
    """Construction plan for a Brownian bridge over absolute times
    ``times[0..S]`` with ``times[0] == 0``.

    Returns a list of construction steps. The first entry sets the
    terminal value: ``(S, None, None, 0.0, 0.0, sqrt(T))``. Each later
    entry ``(j, lo, hi, a, b, c)`` sets
    ``W[j] = a * W[lo] + b * W[hi] + c * z`` for a fresh standard normal
    ``z`` — the classic bisection order (terminal first, then breadth-
    first midpoints), which consumes Sobol dimensions in decreasing
    importance."""
    S = len(times) - 1
    plan = [(S, None, None, 0.0, 0.0, float(np.sqrt(times[S] - times[0])))]
    queue = [(0, S)]
    while queue:
        lo, hi = queue.pop(0)
        if hi - lo < 2:
            continue
        j = (lo + hi) // 2
        t_lo, t_j, t_hi = times[lo], times[j], times[hi]
        denom = t_hi - t_lo
        a = (t_hi - t_j) / denom
        b = (t_j - t_lo) / denom
        c = float(np.sqrt((t_j - t_lo) * (t_hi - t_j) / denom))
        plan.append((j, lo, hi, float(a), float(b), c))
        queue.append((lo, j))
        queue.append((j, hi))
    return plan


def sobol_brownian_increments(dts, num_factors: int, num_paths: int,
                              seed: int = 0, scramble: bool = True,
                              bridge: bool = True,
                              antithetic: bool = False,
                              dtype=np.float32) -> np.ndarray:
    """``[steps, factors, paths]`` Brownian increments from a Sobol
    sequence in dimension ``steps * factors``.

    Dimension allocation: bridge-construction level major, factor minor —
    level l (0 = terminal value, then midpoints in bisection order) of
    factor f consumes Sobol dimension ``l * factors + f``, so all
    factors' coarse structure gets the well-stratified leading
    dimensions. ``bridge=False`` maps dimensions to time steps in plain
    order (still QMC, much weaker for path-dependent payoffs).

    ``antithetic``: generate ``paths/2`` Sobol points and mirror each
    pairwise — adjacent positions ``[z, -z]`` along the path axis, so a
    path-prefix slice (the multistart's reduced-path sweep engine) keeps
    complete mirror pairs.
    """
    from scipy.stats import qmc

    dts = np.asarray(dts, dtype=np.float64)
    S = len(dts)
    d = S * num_factors
    n_points = num_paths // 2 if antithetic else num_paths
    if antithetic and num_paths % 2:
        raise ValueError("antithetic requires an even num_paths")

    sob = qmc.Sobol(d=d, scramble=scramble, seed=seed)
    import warnings

    with warnings.catch_warnings():
        # scipy warns that balance properties need 2^m points; MC path
        # counts are what they are — the scrambled estimator stays
        # unbiased at any n
        warnings.simplefilter("ignore")
        u = sob.random(n_points)                       # [n, d]
    # clamp away from the ICDF poles: the unscrambled sequence starts at
    # the all-zero point, and Owen-scrambled coordinates are dyadic
    # rationals that CAN round to exactly 0.0 (observed at 81,920 x 240
    # draws), which would inject a -inf increment into the simulation
    u = np.clip(u, 2.0 ** -53, 1.0 - 2.0 ** -53)

    from ..native.host_rng import inverse_normal_cdf_as241

    z = inverse_normal_cdf_as241(u)                    # [n, d]
    if antithetic:
        pair = np.empty((num_paths, d), dtype=np.float64)
        pair[0::2] = z
        pair[1::2] = -z
        z = pair
    # -> [levels, factors, paths]
    z = np.ascontiguousarray(z.reshape(num_paths, S, num_factors)
                             .transpose(1, 2, 0))

    times = np.concatenate([[0.0], np.cumsum(dts)])
    if not bridge:
        inc = z * np.sqrt(dts)[:, None, None]
        return inc.astype(dtype)

    plan = brownian_bridge_plan(times)
    W = np.zeros((S + 1, num_factors, num_paths), dtype=np.float64)
    for level, (j, lo, hi, a, b, c) in enumerate(plan):
        if lo is None:
            W[j] = c * z[level]
        else:
            W[j] = a * W[lo] + b * W[hi] + c * z[level]
    return np.diff(W, axis=0).astype(dtype)
