"""Importance sampling for deep out-of-the-money options: exponential
tilting of the terminal Brownian draw with the exact likelihood-ratio
weight.

Counterpart of ``finmath_tpu.models.importance_sampling``. Under Q the
terminal draw is Z ~ N(0,1); sample instead Z ~ N(mu, 1) and weight each
path by exp(-mu Z + mu^2/2). The variance-optimal tilt for a call puts the
sampling mean at the strike,

    mu* = (ln(K/S0) - (r - sigma^2/2) T) / (sigma sqrt(T)),

clamped at 0 so the estimator never tilts away from the payoff region.
The estimator is unbiased for any mu.

The normals are one ``[num_paths]`` float32 draw from a ``torch.Generator``
of the device seeded with ``seed`` (or injected with ``normals=``); the
path arithmetic is float32 as in the JAX function, with the weight
entering in log space so extreme tilts stay finite, and the mean and
standard error are float64.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from ..utils.config import select_device
from .brownian_motion import key_for_seed


def _is_kernel(normals, s0, r, sigma, maturity, strike, mu,
               is_call: bool):
    """``normals`` [paths] float32; the parameters float32 values (NumPy
    float32 scalars). Returns [2] float64 (mean, stderr)."""
    f32 = np.float32
    z = normals + float(mu)
    sq = float(sigma * np.sqrt(maturity))
    # log S0 as a float32 0-dim tensor on the device: the device's log
    log_s0 = torch.log(torch.full((), float(s0), dtype=FLOAT_DTYPE,
                                  device=normals.device))
    drift = float((r - f32(0.5) * sigma * sigma) * maturity)
    log_st = (log_s0 + drift) + sq * z
    sign = 1.0 if is_call else -1.0
    s_t = torch.exp(log_st)
    itm = sign * (s_t - float(strike)) > 0.0
    # payoff * likelihood ratio assembled in log space: the weight
    # exp(-mu z + mu^2/2) under/overflows float32 alone at |mu| ~ 10, but
    # log(payoff) + log(weight) stays in range wherever the payoff is
    # nonzero
    log_pay = torch.where(
        itm,
        torch.log(torch.abs(s_t - float(strike)) + 1e-38)
        - float(mu) * z + float(f32(0.5) * mu * mu),
        -math.inf)
    pay = torch.where(itm, torch.exp(log_pay), 0.0).to(ACC_DTYPE)
    pv = pay * math.exp(-float(r) * float(maturity))
    n = pv.shape[0]
    mean = torch.sum(pv) / n
    var = torch.sum((pv - mean) ** 2) / (n - 1)
    return torch.stack([mean, torch.sqrt(var / n)])


def mc_european_price_importance_sampled(
        seed: int, num_paths: int, initial_value: float,
        risk_free_rate: float, volatility: float, maturity: float,
        strike: float, is_call: bool = True,
        drift_shift: Optional[float] = None, device=None,
        normals=None) -> tuple:
    """(price, stderr) of a European option by exponentially tilted
    exact-terminal sampling. ``drift_shift=None`` uses the variance-optimal
    mu* (clamped toward the money); 0.0 is plain Monte Carlo on the same
    stream. ``device`` defaults to ``select_device()``; ``normals``
    (``[num_paths]`` float32) replaces the draw from ``seed``."""
    if drift_shift is None:
        mu = (math.log(strike / initial_value)
              - (risk_free_rate - 0.5 * volatility**2) * maturity) \
            / (volatility * math.sqrt(maturity))
        # never tilt AWAY from the payoff region
        mu = max(mu, 0.0) if is_call else min(mu, 0.0)
    else:
        mu = float(drift_shift)
    device = torch.device(device) if device is not None else select_device()
    num_paths = int(num_paths)
    if normals is None:
        normals = torch.randn(num_paths, generator=key_for_seed(seed, device),
                              dtype=FLOAT_DTYPE, device=device)
    else:
        normals = torch.as_tensor(normals).to(device=device,
                                               dtype=FLOAT_DTYPE)
        if tuple(normals.shape) != (num_paths,):
            raise ValueError(f"normals must be [{num_paths}], got "
                             f"{tuple(normals.shape)}")
    f32 = np.float32
    out = _is_kernel(normals, f32(initial_value), f32(risk_free_rate),
                     f32(volatility), f32(maturity), f32(strike), f32(mu),
                     bool(is_call)).cpu().numpy()
    return float(out[0]), float(out[1])
