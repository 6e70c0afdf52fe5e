"""Generic Fourier (characteristic-function) pricing of European options
and the characteristic functions of the equity model families.

Counterpart of ``finmath_tpu.models.fourier`` (finmath-lib's
``net.finmath.fouriermethod``: the ``CharacteristicFunction`` of the
Black-Scholes, Heston, Merton and Variance-Gamma models priced by
complex-plane integration). Host NumPy ``complex128``, copied unchanged:
one Gil-Pelaez pricer by Gauss-Legendre quadrature over any log-price
characteristic function, the calibration oracle of the Monte-Carlo
engines.

Pricing identity (Gil-Pelaez inversion on the two measure-probabilities):

  call = S0 * P1 - K e^{-rT} * P2
  P2 = 1/2 + (1/pi) int_0^inf Re[ e^{-iu ln K} phi(u) / (iu) ] du
  P1 = 1/2 + (1/pi) int_0^inf Re[ e^{-iu ln K} phi(u-i) / (iu phi(-i)) ] du

with phi the CF of ln S_T under the pricing measure; phi(-i) = E[S_T]
= S0 e^{rT} for a martingale model (asserted when ``initial_value`` is
given)."""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

CharacteristicFunction = Callable[[np.ndarray], np.ndarray]
"""phi(u) = E[exp(i u ln S_T)] for complex u (vectorized)."""


def european_call_from_cf(cf: CharacteristicFunction, risk_free_rate: float,
                          maturity: float, strikes, is_call: bool = True,
                          num_nodes: int = 512, upper: float = 400.0,
                          initial_value: Optional[float] = None,
                          forward_tol: float = 1e-6) -> np.ndarray:
    """European option prices from the characteristic function of
    ln S_T by Gauss-Legendre Gil-Pelaez inversion on (0, ``upper``].
    Puts via put-call parity (exact). The forward is read off the CF
    itself (``phi(-i)``) and must be real positive; pass
    ``initial_value`` to ALSO assert the martingale identity
    ``phi(-i) = S0 e^{rT}`` to ``forward_tol`` relative — the check
    that catches a mis-drifted characteristic function."""
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    if maturity <= 0:
        raise ValueError("maturity must be positive")
    if np.any(strikes <= 0):
        raise ValueError("strikes must be positive")
    nodes, weights = np.polynomial.legendre.leggauss(int(num_nodes))
    u = (0.5 * (nodes + 1.0) * upper).astype(np.complex128)
    w = 0.5 * upper * weights

    fwd = cf(np.array([-1j]))[0]
    if abs(fwd.imag) > forward_tol * abs(fwd) or fwd.real <= 0:
        raise ValueError(f"cf(-i) = {fwd} is not a positive forward")
    fwd = fwd.real
    if initial_value is not None:
        want = initial_value * math.exp(risk_free_rate * maturity)
        if abs(fwd - want) > forward_tol * want:
            raise ValueError(
                f"cf(-i) = {fwd:.10g} does not match the forward "
                f"S0 e^(rT) = {want:.10g}: the characteristic function "
                "is not a martingale at this drift")
    s0 = fwd * math.exp(-risk_free_rate * maturity)

    lnk = np.log(strikes)                               # [K]
    phase = np.exp(-1j * np.outer(lnk, u))              # [K, Q]
    p2 = 0.5 + (np.real(phase * (cf(u) / (1j * u))[None, :]) @ w) / np.pi
    p1 = 0.5 + (np.real(phase * (cf(u - 1j) / (1j * u * fwd))[None, :])
                @ w) / np.pi
    df = math.exp(-risk_free_rate * maturity)
    call = s0 * p1 - strikes * df * p2
    if is_call:
        return call
    return call - s0 + strikes * df


# ---------------------------------------------------------------------------
# characteristic functions of the framework's model families
# (each returns phi(u) = E[e^{i u ln S_T}] under the risk-neutral measure)
# ---------------------------------------------------------------------------

def black_scholes_cf(initial_value: float, risk_free_rate: float,
                     volatility: float,
                     maturity: float) -> CharacteristicFunction:
    """ln S_T ~ Normal(ln S0 + (r - s^2/2)T, s^2 T)."""
    mu = (math.log(initial_value)
          + (risk_free_rate - 0.5 * volatility ** 2) * maturity)
    v = volatility ** 2 * maturity

    def cf(u):
        u = np.asarray(u, dtype=np.complex128)
        return np.exp(1j * u * mu - 0.5 * v * u * u)
    return cf


def merton_cf(params, maturity: float) -> CharacteristicFunction:
    """Merton jump-diffusion (``MertonParams``): Levy exponent of the
    compound-Poisson + Brownian log dynamics."""
    p = params
    a, b, lam = p.jump_size_mean, p.jump_size_std, p.jump_intensity
    kappa = p.jump_compensator
    mu = (math.log(p.initial_value)
          + (p.risk_free_rate - 0.5 * p.volatility ** 2 - lam * kappa)
          * maturity)
    v = p.volatility ** 2 * maturity

    def cf(u):
        u = np.asarray(u, dtype=np.complex128)
        jump = lam * maturity * (np.exp(1j * u * a - 0.5 * b * b * u * u)
                                 - 1.0)
        return np.exp(1j * u * mu - 0.5 * v * u * u + jump)
    return cf


def heston_cf(params, maturity: float) -> CharacteristicFunction:
    """Heston (``HestonParams``) in the Albrecher et al. 'little trap'
    branch-stable form (same algebra as the dedicated pricer in
    ``models/heston.py`` — this one is the generic-CF route, used to
    cross-check the two)."""
    p = params

    def cf(u):
        u = np.asarray(u, dtype=np.complex128)
        xi2 = p.xi * p.xi
        beta = p.kappa - 1j * p.rho * p.xi * u
        d = np.sqrt(beta * beta + xi2 * (u * u + 1j * u))
        g = (beta - d) / (beta + d)
        e_dt = np.exp(-d * maturity)
        big_c = (p.kappa * p.theta / xi2
                 * ((beta - d) * maturity
                    - 2.0 * np.log((1.0 - g * e_dt) / (1.0 - g))))
        big_d = (beta - d) / xi2 * (1.0 - e_dt) / (1.0 - g * e_dt)
        mu = math.log(p.initial_value) + p.risk_free_rate * maturity
        return np.exp(1j * u * mu + big_c + big_d * p.v0)
    return cf


def variance_gamma_cf(initial_value: float, risk_free_rate: float,
                      sigma: float, theta: float, nu: float,
                      maturity: float) -> CharacteristicFunction:
    """Variance-Gamma (Madan-Carr-Chang): ln S_T = ln S0 + (r + omega)T
    + X_T with X a VG process, phi_X(u) = (1 - i u theta nu
    + sigma^2 nu u^2 / 2)^{-T/nu} and the martingale correction
    omega = ln(1 - theta nu - sigma^2 nu / 2) / nu (requires the
    argument positive — the standard VG admissibility condition)."""
    root = 1.0 - theta * nu - 0.5 * sigma * sigma * nu
    if root <= 0:
        raise ValueError("VG martingale correction undefined: need "
                         "theta*nu + sigma^2*nu/2 < 1")
    omega = math.log(root) / nu
    mu = math.log(initial_value) + (risk_free_rate + omega) * maturity

    def cf(u):
        u = np.asarray(u, dtype=np.complex128)
        base = 1.0 - 1j * u * theta * nu + 0.5 * sigma * sigma * nu * u * u
        # Re(base) >= 1 for real u, so the principal branch is safe
        return np.exp(1j * u * mu) * np.exp(
            (-maturity / nu) * np.log(base))
    return cf
