"""Variance-Gamma (Madan-Carr-Chang 1998) pure-jump equity model: a
gamma-subordinated Monte-Carlo engine and calibration against the generic
Fourier pricer.

Counterpart of ``finmath_tpu.models.variance_gamma`` (finmath-lib's
``VarianceGammaModel`` and ``VarianceGammaProcess``; the characteristic
function is ``fourier.variance_gamma_cf``).

Model: S_t = S0 exp((r + omega) t + X(t)), X(t) = theta G(t) +
sigma W(G(t)) with a gamma clock of unit mean rate and variance nu,
G(t + dt) - G(t) ~ Gamma(shape dt/nu, scale nu), and omega =
ln(1 - theta nu - sigma^2 nu / 2)/nu making e^{-rt} S a martingale. The
time-changed representation is exact in distribution at every grid point.

``mc_vg_european_prices`` is a Python loop over the steps on ``[paths]``
tensors of the device. The clock: ``torch._standard_gamma`` of shape
``dt / nu`` (float32) from a ``torch.Generator`` of the device seeded with
``seed``, times ``nu``; or the caller's ``gammas=`` (the standard
Gamma(dt / nu) draws, ``[steps, paths]`` float32) with ``normals=``.
``jax.random.gamma`` and ``torch._standard_gamma`` are different rejection
samplers, so only injected draws cross the packages. Antithetic mirroring
flips only the Brownian leg; the clock is shared between the halves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.random_variable import FLOAT_DTYPE
from ..utils.config import select_device
from ._draws import draw_block, injected_block, mirror, pack_prices, \
    terminal_mean
from .fourier import european_call_from_cf, variance_gamma_cf
from .heston import _central_difference_jacobian


@dataclass(frozen=True)
class VarianceGammaParams:
    """sigma: diffusion scale of the subordinated Brownian; theta: its
    drift (skew, typically negative); nu: variance rate of the gamma
    clock (excess kurtosis)."""

    initial_value: float
    risk_free_rate: float
    sigma: float
    theta: float
    nu: float

    def __post_init__(self):
        if self.initial_value <= 0:
            raise ValueError("initial_value must be positive")
        if self.sigma <= 0 or self.nu <= 0:
            raise ValueError("sigma and nu must be positive")
        if self.theta * self.nu + 0.5 * self.sigma ** 2 * self.nu >= 1.0:
            raise ValueError("inadmissible VG parameters: need "
                             "theta*nu + sigma^2*nu/2 < 1")

    @property
    def omega(self) -> float:
        return math.log(1.0 - self.theta * self.nu
                        - 0.5 * self.sigma ** 2 * self.nu) / self.nu


def vg_analytic_prices(params: VarianceGammaParams, maturity: float,
                       strikes, is_call: bool = True,
                       num_nodes: int = 512) -> np.ndarray:
    """European prices via the generic Gil-Pelaez pricer on the VG
    characteristic function — the calibration oracle and the MC
    regression net."""
    p = params
    cf = variance_gamma_cf(p.initial_value, p.risk_free_rate, p.sigma,
                           p.theta, p.nu, maturity)
    return european_call_from_cf(cf, p.risk_free_rate, maturity, strikes,
                                 is_call=is_call, num_nodes=num_nodes,
                                 initial_value=p.initial_value)


def _mc_vg_kernel(gammas, normals, num_paths: int, num_steps: int, s0, r,
                  sigma, theta, nu, omega, maturity, strikes,
                  device) -> np.ndarray:
    """The step loop on the mirrored clock and normals -> strike-vector
    payoffs -> float64 means. Returns ``[1 + K]``: ``[E[S_T] e^{-rT},
    call prices...]`` in one host copy."""
    f = np.float32
    dt = maturity / num_steps
    drift = float(f((r + omega) * dt))
    th, sg, nu_f = float(f(theta)), float(f(sigma)), float(f(nu))
    log_s = torch.full((num_paths,), float(np.log(f(s0))),
                       dtype=FLOAT_DTYPE, device=device)
    for i in range(num_steps):
        g = gammas[i] * nu_f
        log_s = log_s + drift + th * g + sg * torch.sqrt(g) * normals[i]
    st = torch.exp(log_s)
    df = math.exp(-r * maturity)
    return pack_prices(st, strikes, df, (terminal_mean(st, df),))


def mc_vg_european_prices(params: VarianceGammaParams, maturity: float,
                          strikes, num_paths: int = 100_000,
                          num_steps: int = 16, seed: int = 3141,
                          antithetic: bool = False, *, device=None,
                          gammas=None, normals=None):
    """European call prices for a strike vector from one simulation on
    ``device`` (default ``select_device()``). Returns ``(prices [K],
    discounted_forward)`` — the forward must equal S0 up to MC error.

    ``gammas=`` (standard Gamma(dt / nu) draws) and ``normals=`` inject
    the draws, each ``[num_steps, num_paths]`` float32 (``num_paths / 2``
    when antithetic)."""
    if antithetic and num_paths % 2:
        raise ValueError("antithetic needs an even num_paths")
    device = torch.device(device) if device is not None else select_device()
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    half = num_paths // 2 if antithetic else num_paths
    shape = (int(num_steps), half)
    p = params
    if gammas is None and normals is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        alpha = float(np.float32(maturity / num_steps / p.nu))
        g = torch._standard_gamma(
            torch.full(shape, alpha, dtype=FLOAT_DTYPE, device=device),
            generator=gen)
        z = draw_block(gen, "normal", shape, device)
    elif gammas is None or normals is None:
        raise ValueError("inject both gammas= and normals=")
    else:
        g = injected_block(gammas, shape, device, "gammas")
        z = injected_block(normals, shape, device, "normals")
    out = _mc_vg_kernel(
        mirror(g, "gamma", antithetic), mirror(z, "normal", antithetic),
        int(num_paths), int(num_steps), p.initial_value, p.risk_free_rate,
        p.sigma, p.theta, p.nu, p.omega, float(maturity), strikes, device)
    return out[1:], float(out[0])


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VarianceGammaCalibrationResult:
    params: VarianceGammaParams
    rms_price_error: float
    iterations: int
    converged: bool


def calibrate_variance_gamma(s0: float, r: float,
                             maturities: Sequence[float],
                             strikes: Sequence[Sequence[float]],
                             target_prices: Sequence[Sequence[float]],
                             x0: Optional[VarianceGammaParams] = None,
                             max_iterations: int = 200,
                             accuracy: float = 1e-9
                             ) -> VarianceGammaCalibrationResult:
    """Calibrate (sigma, theta, nu) to a European call surface by
    Levenberg-Marquardt on the Fourier pricer (host float64). sigma/nu in
    log; theta mapped through the admissibility bound
    theta < (1 - sigma^2 nu/2)/nu, so LM never leaves the admissible
    region."""
    from .calibration import LevenbergMarquardt

    if len(maturities) != len(strikes) or len(strikes) != len(target_prices):
        raise ValueError("maturities, strikes, target_prices must align")
    targets = np.concatenate(
        [np.asarray(t, dtype=np.float64) for t in target_prices])

    def from_y(y: np.ndarray) -> VarianceGammaParams:
        y = np.clip(y, -30.0, 30.0)
        sigma = math.exp(y[0])
        nu = math.exp(y[2])
        bound = (1.0 - 0.5 * sigma * sigma * nu) / nu
        # theta = bound - exp(y1): any real y1 stays admissible
        theta = bound - math.exp(np.clip(y[1], -30.0, 30.0))
        return VarianceGammaParams(s0, r, sigma, theta, nu)

    def to_y(p: VarianceGammaParams) -> np.ndarray:
        bound = (1.0 - 0.5 * p.sigma ** 2 * p.nu) / p.nu
        return np.array([math.log(p.sigma), math.log(bound - p.theta),
                         math.log(p.nu)])

    def residuals(y: np.ndarray) -> np.ndarray:
        p = from_y(y)
        rows = [vg_analytic_prices(p, t, k)
                for t, k in zip(maturities, strikes)]
        return np.concatenate(rows) - targets

    start = x0 or VarianceGammaParams(s0, r, sigma=0.2, theta=-0.15,
                                      nu=0.2)
    lm = LevenbergMarquardt(residuals, _central_difference_jacobian(residuals),
                            max_iterations=max_iterations,
                            accuracy=accuracy,
                            lower_bound=-np.inf, upper_bound=np.inf)
    res = lm.run(to_y(start))
    p = from_y(res.parameters)
    rms = float(np.sqrt(np.mean(residuals(res.parameters) ** 2)))
    return VarianceGammaCalibrationResult(params=p, rms_price_error=rms,
                                          iterations=res.iterations,
                                          converged=res.converged)
