"""Bachelier (normal) equity model and the displaced-lognormal smile model:
exact Monte-Carlo engines and closed-form pricers.

Counterpart of ``finmath_tpu.models.bachelier`` (finmath-lib's
``BachelierModel`` and ``DisplacedLognormalModel``). Conventions:

* Bachelier dynamics are the finmath SDE ``dS = r S dt + sigma dW``: S_T
  is Gaussian with mean S0 e^{rT} and variance
  ``sigma^2 (e^{2rT} - 1) / (2r)`` (-> sigma^2 T as r -> 0); the closed
  form is the Bachelier formula on the forward with that exact variance.
* The displaced model is shifted Black under the T-forward measure:
  ``call = df * Black(F + d, K + d, sigma, T)``, and the Monte-Carlo
  simulates the shifted GBM exactly.

Each engine is one exact terminal draw on the device, with no step loop:
``normals=`` (``[num_paths]`` float32, ``num_paths / 2`` mirrored
``[z, -z]`` when antithetic) injects it; without it, a
``torch.Generator`` of the device seeded with ``seed``. The strike vector
and the discounted forward come back in one float64 tensor and one host
copy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.config import select_device
from ._draws import draws, pack_prices, terminal_mean
from .analytic import bachelier_formula, black_formula


# ---------------------------------------------------------------------------
# Bachelier
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BachelierParams:
    initial_value: float
    risk_free_rate: float
    volatility: float       # ABSOLUTE (normal) volatility, units of S

    def __post_init__(self):
        if self.volatility <= 0:
            raise ValueError("volatility must be positive")


def bachelier_terminal_std(params: BachelierParams, maturity: float) -> float:
    """Exact std of S_T: sigma * sqrt((e^{2rT} - 1) / (2r))."""
    r = params.risk_free_rate
    if abs(r) < 1e-12:
        return params.volatility * math.sqrt(maturity)
    return params.volatility * math.sqrt(math.expm1(2.0 * r * maturity)
                                         / (2.0 * r))


def bachelier_analytic_price(params: BachelierParams, maturity: float,
                             strikes, is_call: bool = True) -> np.ndarray:
    """Exact European price: Bachelier formula on the forward
    S0 e^{rT} with the exact terminal std (strikes may be negative)."""
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    fwd = params.initial_value * math.exp(params.risk_free_rate * maturity)
    df = math.exp(-params.risk_free_rate * maturity)
    s_t = bachelier_terminal_std(params, maturity)
    vol = s_t / math.sqrt(maturity)
    call = np.array([bachelier_formula(fwd, k, vol, maturity,
                                       payoff_unit=df) for k in strikes])
    if is_call:
        return call
    return call - df * (fwd - strikes)


def _terminal_normals(normals, num_paths: int, antithetic: bool, seed: int,
                      device) -> torch.Tensor:
    """The engine's one mirrored ``[num_paths]`` block of normals."""
    half = num_paths // 2 if antithetic else num_paths
    return draws(None if normals is None else (normals,), ("normal",),
                 (half,), antithetic, seed, device, ("normals",))[0]


def _mc_bachelier_kernel(z: torch.Tensor, fwd: float, std: float,
                         df: float, strikes) -> np.ndarray:
    """Exact terminal sampling S_T = fwd + std * Z -> ``[1 + K]``:
    ``[E[S_T] df, call prices...]``."""
    st = float(np.float32(fwd)) + float(np.float32(std)) * z
    return pack_prices(st, strikes, df, (terminal_mean(st, df),))


def mc_bachelier_european_prices(params: BachelierParams, maturity: float,
                                 strikes, num_paths: int = 100_000,
                                 seed: int = 3141,
                                 antithetic: bool = False, *, device=None,
                                 normals=None):
    """Exact-terminal MC on ``device`` (default ``select_device()``):
    ``(prices [K], discounted_forward)`` (one normal per path — the
    Gaussian solution of the linear SDE). ``normals=`` injects them."""
    if antithetic and num_paths % 2:
        raise ValueError("antithetic needs an even num_paths")
    device = torch.device(device) if device is not None else select_device()
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    z = _terminal_normals(normals, int(num_paths), antithetic, seed, device)
    fwd = params.initial_value * math.exp(params.risk_free_rate * maturity)
    out = _mc_bachelier_kernel(
        z, fwd, bachelier_terminal_std(params, maturity),
        math.exp(-params.risk_free_rate * maturity), strikes)
    return out[1:], float(out[0])


# ---------------------------------------------------------------------------
# displaced lognormal (shifted Black)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DisplacedLognormalParams:
    """Shifted-Black smile model under the T-forward measure:
    F_t + displacement is a driftless lognormal with volatility
    ``volatility``; ``displacement > -min(F)`` keeps it positive.
    ``displacement -> 0`` recovers Black-Scholes; large displacement
    approaches the normal (Bachelier) smile with absolute vol
    ``volatility * displacement``."""

    initial_value: float
    risk_free_rate: float
    volatility: float
    displacement: float

    def __post_init__(self):
        if self.volatility <= 0:
            raise ValueError("volatility must be positive")
        if self.initial_value + self.displacement <= 0:
            raise ValueError("initial_value + displacement must be "
                             "positive (the shifted asset is lognormal)")


def displaced_analytic_price(params: DisplacedLognormalParams,
                             maturity: float, strikes,
                             is_call: bool = True) -> np.ndarray:
    """call = df * Black(F + d, K + d, sigma, T); exact (strikes above
    ``-displacement``)."""
    p = params
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    if np.any(strikes + p.displacement <= 0):
        raise ValueError("strikes must exceed -displacement")
    fwd = p.initial_value * math.exp(p.risk_free_rate * maturity)
    df = math.exp(-p.risk_free_rate * maturity)
    call = np.array([
        black_formula(fwd + p.displacement, k + p.displacement,
                      p.volatility, maturity, payoff_unit=df)
        for k in strikes])
    if is_call:
        return call
    return call - df * (fwd - strikes)


def _mc_displaced_kernel(z: torch.Tensor, fwd_shifted: float, disp: float,
                         sigma: float, maturity: float, df: float,
                         strikes) -> np.ndarray:
    """Exact shifted GBM F_T = (F + d) exp(-sigma^2 T / 2 + sigma sqrt(T)
    Z) - d in float32 -> ``[1 + K]``: ``[E[F_T] df, call prices...]``."""
    f = np.float32
    sig, t32 = f(sigma), f(maturity)
    sq = f(math.sqrt(maturity))
    x = torch.exp(float(f(-0.5) * sig * sig * t32) + float(sig * sq) * z)
    ft = float(f(fwd_shifted)) * x - float(f(disp))
    return pack_prices(ft, strikes, df, (terminal_mean(ft, df),))


def mc_displaced_european_prices(params: DisplacedLognormalParams,
                                 maturity: float, strikes,
                                 num_paths: int = 100_000,
                                 seed: int = 3141,
                                 antithetic: bool = False, *, device=None,
                                 normals=None):
    """Exact-terminal MC of the shifted GBM on ``device`` (default
    ``select_device()``): ``(prices [K], discounted_forward)``.
    ``normals=`` injects the draws."""
    if antithetic and num_paths % 2:
        raise ValueError("antithetic needs an even num_paths")
    p = params
    device = torch.device(device) if device is not None else select_device()
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    z = _terminal_normals(normals, int(num_paths), antithetic, seed, device)
    fwd = p.initial_value * math.exp(p.risk_free_rate * maturity)
    out = _mc_displaced_kernel(
        z, fwd + p.displacement, p.displacement, p.volatility,
        float(maturity), math.exp(-p.risk_free_rate * maturity), strikes)
    return out[1:], float(out[0])
