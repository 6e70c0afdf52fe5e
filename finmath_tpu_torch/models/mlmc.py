"""Multilevel Monte Carlo (Giles 2008) for the floating-strike lookback
call, with the coupled two-resolution path loop on the device.

Counterpart of ``finmath_tpu.models.mlmc``. Levels l = 0..L simulate the
SAME Brownian path at two resolutions (fine: m0 2^l steps; coarse: half,
the coarse increment the sum of the two fine ones) and estimate the
telescoping corrections Y_l = P_fine - P_coarse; the sample sizes follow
Giles' allocation N_l ~ sqrt(V_l / C_l). The adaptive loop is the JAX
package's: the pilot on levels 0-2, the allocation, the bias check, at
most 2,000,000 new samples a level and call, and ``max_level``.

Each level call is a float32 loop over the coarse steps (two fine updates
and one coarse update a step, running minima in float32) that returns the
float64 ``[4]`` sums; its normals come from a ``torch.Generator`` of the
device seeded from ``(seed, level, draw)``, or are injected with
``normals=(z1, z2)``, each ``[coarse_steps, n]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from ..utils.config import select_device

#: the Broadie-Glasserman-Kou constant -zeta(1/2)/sqrt(2 pi)
BGK_BETA1 = 0.5825971579390107


def _lookback_level_kernel(n: int, coarse_steps: int, level0: bool, s0, r,
                           sig, maturity, *, generator=None, normals=None,
                           device=None):
    """Coupled-level sums for the floating-strike lookback call payoff
    P = S_T - min S (undiscounted); the fine grid is twice the coarse grid
    (``level0``: Y is the coarse payoff alone). ``s0``, ``r``, ``sig``,
    ``maturity`` are float32 values (NumPy float32 scalars). The normals
    are drawn a step at a time from ``generator`` (z1 then z2 a step), or
    read from ``normals=(z1, z2)``. Returns float64 [sum_Y, sum_Y2,
    sum_Pf, sum_Pf2]."""
    f32 = np.float32
    dt_f = f32(maturity) / f32(2 * coarse_steps)
    vol_f = f32(sig) * np.sqrt(dt_f)
    drift_f = (f32(r) - f32(0.5) * sig * sig) * dt_f
    drift_c = f32(2.0) * drift_f
    if normals is not None:
        z1s, z2s = (torch.as_tensor(z).to(dtype=FLOAT_DTYPE) for z in normals)
        device = z1s.device
        if tuple(z1s.shape) != (coarse_steps, n) or z2s.shape != z1s.shape:
            raise ValueError(f"normals must be two [{coarse_steps}, {n}] "
                             f"blocks")
    lf = torch.zeros(n, dtype=FLOAT_DTYPE, device=device)
    mf, lc, mc = lf.clone(), lf.clone(), lf.clone()
    for k in range(coarse_steps):
        if normals is not None:
            z1, z2 = z1s[k], z2s[k]
        else:
            z1 = torch.randn(n, generator=generator, dtype=FLOAT_DTYPE,
                             device=device)
            z2 = torch.randn(n, generator=generator, dtype=FLOAT_DTYPE,
                             device=device)
        lf1 = lf + float(drift_f) + float(vol_f) * z1
        mf = torch.minimum(mf, lf1)
        lf = lf1 + float(drift_f) + float(vol_f) * z2
        mf = torch.minimum(mf, lf)
        # exact coupling: the coarse increment is the SUM of the fine ones
        lc = lc + float(drift_c) + float(vol_f) * (z1 + z2)
        mc = torch.minimum(mc, lc)
    # Giles' lookback treatment: shift the discrete minimum by the BGK
    # beta1 sigma sqrt(dt) of its own grid, so level l's coarse payoff and
    # level l-1's fine payoff share one definition
    shift_f = float(f32(BGK_BETA1) * vol_f)
    shift_c = float(f32(BGK_BETA1) * vol_f * f32(math.sqrt(2.0)))
    s0 = float(f32(s0))
    p_f = s0 * (torch.exp(lf.to(ACC_DTYPE))
                - torch.exp((torch.clamp_max(mf, 0.0) - shift_f)
                            .to(ACC_DTYPE)))
    p_c = s0 * (torch.exp(lc.to(ACC_DTYPE))
                - torch.exp((torch.clamp_max(mc, 0.0) - shift_c)
                            .to(ACC_DTYPE)))
    y = p_c if level0 else p_f - p_c
    return torch.stack([torch.sum(y), torch.sum(y * y),
                        torch.sum(p_f), torch.sum(p_f * p_f)])


def _level_generator(seed: int, level: int, draw: int,
                     device) -> torch.Generator:
    """The generator of ``device`` for one (level, draw) of a run: its seed
    is NumPy's ``SeedSequence`` of (seed, level, draw)."""
    state = np.random.SeedSequence([int(seed), int(level), int(draw)])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def _level_sums(level: int, n: int, draw: int, seed: int, m0: int, s0, r,
                sig, maturity, device) -> np.ndarray:
    """One level call of the adaptive loop: [4] float64 sums on the host."""
    coarse = m0 * 2 ** max(level - 1, 0)
    return _lookback_level_kernel(
        int(n), int(coarse), level == 0, s0, r, sig, maturity,
        generator=_level_generator(seed, level, draw, device),
        device=device).cpu().numpy()


@dataclass
class MLMCResult:
    value: float
    stderr: float
    levels: List[int]
    samples: List[int]
    level_means: List[float]
    level_vars: List[float]
    total_fine_steps: float          #: cost proxy: sum N_l * steps_l
    bias_estimate: float


def mlmc_lookback_call(initial_value: float, risk_free_rate: float,
                       volatility: float, maturity: float,
                       eps: float = 0.02, m0: int = 4,
                       max_level: int = 9, n_pilot: int = 20_000,
                       seed: int = 1234, device=None) -> MLMCResult:
    """Continuously monitored floating-strike lookback call by MLMC, to
    target RMS accuracy ``eps`` (same units as the price). The closed-form
    oracle is ``analytic.lookback_floating_strike_value``. ``device``
    defaults to ``select_device()``.

    Giles' adaptive loop: pilot-estimate V_l, allocate
    N_l = ceil(2 eps^-2 sqrt(V_l/C_l) sum_k sqrt(V_k C_k)), add levels
    until the weak-error (bias) estimate |Y_L| / (2^gamma - 1) < eps/2
    with the post-BGK-shift weak rate gamma = 1."""
    device = torch.device(device) if device is not None else select_device()
    f32 = np.float32
    s0, rr = f32(initial_value), f32(risk_free_rate)
    sg, tt = f32(volatility), f32(maturity)
    df = math.exp(-risk_free_rate * maturity)

    sums: Dict[int, np.ndarray] = {}
    counts: Dict[int, int] = {}
    draws: Dict[int, int] = {}

    def add_samples(level: int, n: int):
        if n <= 0:
            return
        d = draws.get(level, 0)
        out = _level_sums(level, n, d, seed, m0, s0, rr, sg, tt, device)
        draws[level] = d + 1
        sums[level] = sums.get(level, np.zeros(4)) + out
        counts[level] = counts.get(level, 0) + n

    def stats(level: int):
        s = sums[level]
        n = counts[level]
        mean = s[0] / n
        var = max(s[1] / n - mean * mean, 1e-30)
        return mean, var

    # pilot
    levels = [0, 1, 2]
    for lv in levels:
        add_samples(lv, n_pilot)

    gamma = 1.0                      # weak rate after the BGK shift
    for _ in range(50):              # adaptive refinement
        # optimal allocation (cost C_l ~ fine steps of the level)
        cost = [m0 * 2 ** max(lv, 0) for lv in levels]
        vs = [stats(lv)[1] for lv in levels]
        lam = sum(math.sqrt(v * c) for v, c in zip(vs, cost))
        targets = [int(math.ceil(2.0 * eps ** -2 * df * df
                                 * math.sqrt(v / c) * lam))
                   for v, c in zip(vs, cost)]
        extra = [max(t - counts[lv], 0) for t, lv in zip(targets, levels)]
        for lv, e in zip(levels, extra):
            add_samples(lv, min(e, 2_000_000))
        # bias check on the finest level
        mean_l, _ = stats(levels[-1])
        bias = abs(mean_l) / (2.0 ** gamma - 1.0) * df
        converged_n = all(counts[lv] >= 0.95 * t
                          for lv, t in zip(levels, targets))
        if bias > eps / math.sqrt(2.0) and len(levels) <= max_level:
            levels.append(levels[-1] + 1)
            add_samples(levels[-1], n_pilot)
        elif converged_n:
            break

    value = df * sum(stats(lv)[0] for lv in levels)
    stderr = df * math.sqrt(sum(stats(lv)[1] / counts[lv]
                                for lv in levels))
    return MLMCResult(
        value=float(value), stderr=float(stderr), levels=list(levels),
        samples=[counts[lv] for lv in levels],
        level_means=[float(stats(lv)[0]) for lv in levels],
        level_vars=[float(stats(lv)[1]) for lv in levels],
        total_fine_steps=float(sum(
            counts[lv] * m0 * 2 ** max(lv, 0) for lv in levels)),
        bias_estimate=float(abs(stats(levels[-1])[0]) * df))
