"""Closed-form valuation formulas (Black-Scholes, Black'76, Bachelier) and
implied-volatility inversion.

Equivalents of the finmath-lib ``AnalyticFormulas`` the reference tests
compare against (e.g. MonteCarloBlackScholesModelTest asserts
|MC - analytic| < 0.005, MonteCarloBlackScholesModelTest.java:146-156; the
swaption calibration targets are produced from
Black/Bachelier vols, LIBORMarketModelCalibrationATMTest.java:188-269).

Counterpart of ``finmath_tpu.models.analytic``. All formulas are plain
float64 host math (they price scalars, not paths), copied unchanged; the
JAX package's ``*_jnp`` variants become the ``*_torch`` functions, which
take tensors (float64 in the calibration losses) on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _norm_cdf(x):
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def black_scholes_option_value(initial_value: float, risk_free_rate: float,
                               volatility: float, maturity: float,
                               strike: float, is_call: bool = True) -> float:
    """European option under Black-Scholes."""
    if maturity <= 0 or volatility <= 0:
        fwd = initial_value * math.exp(risk_free_rate * maturity)
        intrinsic = max(fwd - strike, 0.0) if is_call else max(strike - fwd, 0.0)
        return math.exp(-risk_free_rate * maturity) * intrinsic
    sqrt_t = math.sqrt(maturity)
    d1 = (
        math.log(initial_value / strike)
        + (risk_free_rate + 0.5 * volatility * volatility) * maturity
    ) / (volatility * sqrt_t)
    d2 = d1 - volatility * sqrt_t
    if is_call:
        return initial_value * _norm_cdf(d1) - strike * math.exp(
            -risk_free_rate * maturity
        ) * _norm_cdf(d2)
    return strike * math.exp(-risk_free_rate * maturity) * _norm_cdf(
        -d2
    ) - initial_value * _norm_cdf(-d1)


def black_formula(forward: float, strike: float, volatility: float,
                  maturity: float, payoff_unit: float = 1.0) -> float:
    """Black'76: undiscounted lognormal option value times payoffUnit
    (the swaption annuity). Used for lognormal swaption quoting."""
    if maturity <= 0 or volatility <= 0:
        return payoff_unit * max(forward - strike, 0.0)
    sqrt_t = math.sqrt(maturity)
    d1 = (math.log(forward / strike) + 0.5 * volatility**2 * maturity) / (
        volatility * sqrt_t
    )
    d2 = d1 - volatility * sqrt_t
    return payoff_unit * (forward * _norm_cdf(d1) - strike * _norm_cdf(d2))


def bachelier_formula(forward: float, strike: float, volatility: float,
                      maturity: float, payoff_unit: float = 1.0) -> float:
    """Bachelier (normal) model option value times payoffUnit. ATM swaption
    vols in the calibration test are normal vols
    (ref. LIBORMarketModelCalibrationATMTest.java:188-236)."""
    if maturity <= 0:
        return payoff_unit * max(forward - strike, 0.0)
    if volatility <= 0:
        return payoff_unit * max(forward - strike, 0.0)
    sqrt_t = math.sqrt(maturity)
    d = (forward - strike) / (volatility * sqrt_t)
    return payoff_unit * (
        (forward - strike) * _norm_cdf(d)
        + volatility * sqrt_t * math.exp(-0.5 * d * d) / math.sqrt(2.0 * math.pi)
    )


def black_implied_volatility(forward: float, strike: float, maturity: float,
                             value: float, payoff_unit: float = 1.0,
                             tol: float = 1e-12, max_iter: int = 200) -> float:
    """Invert Black'76 by bisection (robust for calibration error
    reporting; the differentiable Newton inverter lives in
    models.lmm.model.black_implied_vol_jnp)."""
    target = value / payoff_unit
    intrinsic = max(forward - strike, 0.0)
    if target <= intrinsic + 1e-16:
        return 0.0
    lo, hi = 1e-8, 5.0
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        v = black_formula(forward, strike, mid, maturity)
        if v < target:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


def bachelier_implied_volatility(forward: float, strike: float, maturity: float,
                                 value: float, payoff_unit: float = 1.0,
                                 tol: float = 1e-12, max_iter: int = 200) -> float:
    """Invert the Bachelier formula by bisection."""
    target = value / payoff_unit
    intrinsic = max(forward - strike, 0.0)
    if target <= intrinsic + 1e-16:
        return 0.0
    lo, hi = 1e-10, 2.0
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        v = bachelier_formula(forward, strike, mid, maturity)
        if v < target:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# torch variants for use inside calibration losses (tensors, any device)
# ---------------------------------------------------------------------------

def _float64_tensors(*args):
    """The arguments as broadcast float64 tensors on the device of the first
    tensor among them (the CPU if none is)."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  None)
    return torch.broadcast_tensors(
        *(torch.as_tensor(a, dtype=torch.float64, device=device)
          for a in args))


def torch_norm_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def black_formula_torch(forward, strike, volatility, maturity, payoff_unit=1.0):
    forward, strike, volatility, maturity = _float64_tensors(
        forward, strike, volatility, maturity)
    sqrt_t = torch.sqrt(torch.clamp_min(maturity, 1e-16))
    vol = torch.clamp_min(volatility, 1e-12)
    d1 = (torch.log(forward / strike) + 0.5 * vol**2 * maturity) / (vol * sqrt_t)
    d2 = d1 - vol * sqrt_t
    value = forward * torch_norm_cdf(d1) - strike * torch_norm_cdf(d2)
    intrinsic = torch.clamp_min(forward - strike, 0.0)
    return payoff_unit * torch.where(
        (maturity <= 0) | (volatility <= 0), intrinsic, value
    )


def bachelier_formula_torch(forward, strike, volatility, maturity, payoff_unit=1.0):
    forward, strike, volatility, maturity = _float64_tensors(
        forward, strike, volatility, maturity)
    sqrt_t = torch.sqrt(torch.clamp_min(maturity, 1e-16))
    vol = torch.clamp_min(volatility, 1e-12)
    d = (forward - strike) / (vol * sqrt_t)
    value = (forward - strike) * torch_norm_cdf(d) + vol * sqrt_t * torch.exp(
        -0.5 * d * d
    ) / math.sqrt(2.0 * math.pi)
    intrinsic = torch.clamp_min(forward - strike, 0.0)
    return payoff_unit * torch.where(maturity <= 0, intrinsic, value)


# ---------------------------------------------------------------------------
# Exotic-payoff closed forms (oracles for the equity product zoo,
# finmath_tpu/models/equity_products.py). finmath-lib exposes the same
# family through net.finmath.functions.AnalyticFormulas
# (blackScholesDigitalOptionValue etc.); the reference workloads only
# exercise the vanilla formula, these widen the oracle set. Host f64
# scalar math throughout.
# ---------------------------------------------------------------------------

def digital_option_value(initial_value: float, risk_free_rate: float,
                         volatility: float, maturity: float, strike: float,
                         is_call: bool = True) -> float:
    """Cash-or-nothing digital paying 1 at maturity if ITM
    (finmath AnalyticFormulas.blackScholesDigitalOptionValue)."""
    df = math.exp(-risk_free_rate * maturity)
    if maturity <= 0 or volatility <= 0:
        fwd = initial_value * math.exp(risk_free_rate * maturity)
        itm = fwd > strike if is_call else fwd < strike
        return df * (1.0 if itm else 0.0)
    d2 = (
        math.log(initial_value / strike)
        + (risk_free_rate - 0.5 * volatility**2) * maturity
    ) / (volatility * math.sqrt(maturity))
    return df * (_norm_cdf(d2) if is_call else _norm_cdf(-d2))


def geometric_asian_option_value(initial_value: float, risk_free_rate: float,
                                 volatility: float, averaging_times,
                                 strike: float, is_call: bool = True,
                                 payment_time: float | None = None) -> float:
    """Discrete geometric-average Asian option, paid at ``payment_time``
    (default: the last averaging date). The geometric average of
    lognormals is lognormal, so the price is exact:
    ln A ~ N(m, v) with m = ln S0 + (r - sigma^2/2) * mean(t_i) and
    v = sigma^2 / n^2 * sum_ij min(t_i, t_j)."""
    t = np.asarray(sorted(float(x) for x in averaging_times), dtype=np.float64)
    if t.size == 0 or (t <= 0).any():
        raise ValueError("averaging_times must be positive")
    n = t.size
    pay_t = float(payment_time if payment_time is not None else t[-1])
    m = math.log(initial_value) + (
        risk_free_rate - 0.5 * volatility**2) * float(t.mean())
    v = volatility**2 * float(np.minimum.outer(t, t).sum()) / n**2
    df = math.exp(-risk_free_rate * pay_t)
    if v <= 0:
        a = math.exp(m)
        intr = max(a - strike, 0.0) if is_call else max(strike - a, 0.0)
        return df * intr
    sv = math.sqrt(v)
    d1 = (m - math.log(strike) + v) / sv
    d2 = d1 - sv
    fwd = math.exp(m + 0.5 * v)
    if is_call:
        return df * (fwd * _norm_cdf(d1) - strike * _norm_cdf(d2))
    return df * (strike * _norm_cdf(-d2) - fwd * _norm_cdf(-d1))


def barrier_option_value(initial_value: float, risk_free_rate: float,
                         volatility: float, maturity: float, strike: float,
                         barrier: float, barrier_type: str,
                         is_call: bool = True) -> float:
    """Continuously monitored single-barrier option (zero rebate),
    standard Reiner-Rubinstein (1991) composition with cost-of-carry
    b = r (no dividends, matching the framework's BlackScholesModel).
    barrier_type in {'up-out','down-out','up-in','down-in'}; the out
    prices come from in-out parity (exact at zero rebate)."""
    s, r, sig, t, k, b = (initial_value, risk_free_rate, volatility,
                          maturity, strike, barrier)
    if barrier_type not in ("up-out", "down-out", "up-in", "down-in"):
        raise ValueError(f"unknown barrier_type {barrier_type!r}")
    up = barrier_type.startswith("up")
    # an option already beyond its barrier is knocked (in: vanilla)
    if (up and s >= b) or (not up and s <= b):
        vanilla = black_scholes_option_value(s, r, sig, t, k, is_call)
        return vanilla if barrier_type.endswith("in") else 0.0
    sq = sig * math.sqrt(t)
    mu = r / sig**2 - 0.5
    phi = 1.0 if is_call else -1.0
    eta = -1.0 if up else 1.0
    df = math.exp(-r * t)
    hs = b / s

    def ab(x):
        return phi * (s * _norm_cdf(phi * x)
                      - k * df * _norm_cdf(phi * (x - sq)))

    def cd(y):
        return phi * (s * hs ** (2.0 * (mu + 1.0)) * _norm_cdf(eta * y)
                      - k * df * hs ** (2.0 * mu)
                      * _norm_cdf(eta * (y - sq)))

    x1 = math.log(s / k) / sq + (1.0 + mu) * sq
    x2 = math.log(s / b) / sq + (1.0 + mu) * sq
    y1 = math.log(b * b / (s * k)) / sq + (1.0 + mu) * sq
    y2 = math.log(b / s) / sq + (1.0 + mu) * sq
    a_, b_, c_, d_ = ab(x1), ab(x2), cd(y1), cd(y2)

    if is_call:
        if up:            # up-in call
            in_value = a_ if k >= b else b_ - c_ + d_
        else:             # down-in call
            in_value = c_ if k >= b else a_ - b_ + d_
    else:
        if up:            # up-in put
            in_value = a_ - b_ + d_ if k >= b else c_
        else:             # down-in put
            in_value = b_ - c_ + d_ if k >= b else a_
    if barrier_type.endswith("in"):
        return max(in_value, 0.0)
    vanilla = black_scholes_option_value(s, r, sig, t, k, is_call)
    return max(vanilla - in_value, 0.0)


def lookback_floating_strike_value(initial_value: float,
                                   risk_free_rate: float, volatility: float,
                                   maturity: float, is_call: bool = True,
                                   extremum_so_far: float | None = None
                                   ) -> float:
    """Continuously monitored floating-strike lookback
    (Goldman-Sosin-Gatto 1979), b = r, r != 0. A fresh call pays
    S_T - min S; a fresh put pays max S - S_T. ``extremum_so_far``
    seeds the running min (call) / max (put) for seasoned options."""
    s, r, sig, t = (float(initial_value), float(risk_free_rate),
                    float(volatility), float(maturity))
    e = s if extremum_so_far is None else float(extremum_so_far)
    if is_call and e > s or (not is_call and e < s):
        raise ValueError("extremum_so_far on the wrong side of spot")
    if r == 0.0:
        raise ValueError("GSG closed form needs r != 0 (k2 = 2r/sig^2)")
    sq = sig * math.sqrt(t)
    df = math.exp(-r * t)
    k2 = 2.0 * r / sig**2
    a1 = (math.log(s / e) + (r + 0.5 * sig**2) * t) / sq
    a2 = a1 - sq
    if is_call:                       # e = running minimum <= s
        tail = ((s / e) ** (-k2) * _norm_cdf(-a1 + k2 * sq)
                - math.exp(r * t) * _norm_cdf(-a1))
        return s * _norm_cdf(a1) - e * df * _norm_cdf(a2) + s * df / k2 * tail
    tail = (-(s / e) ** (-k2) * _norm_cdf(a1 - k2 * sq)
            + math.exp(r * t) * _norm_cdf(a1))
    return e * df * _norm_cdf(-a2) - s * _norm_cdf(-a1) + s * df / k2 * tail


def lookback_fixed_strike_value(initial_value: float, risk_free_rate: float,
                                volatility: float, maturity: float,
                                strike: float, is_call: bool = True) -> float:
    """Continuously monitored fixed-strike lookback
    (Conze-Viswanathan 1991), fresh option (running extremum = spot),
    b = r, r != 0. Call pays (max S - K)+, put pays (K - min S)+."""
    s, r, sig, t, k = (float(initial_value), float(risk_free_rate),
                       float(volatility), float(maturity), float(strike))
    if r == 0.0:
        raise ValueError("CV closed form needs r != 0 (k2 = 2r/sig^2)")
    sq = sig * math.sqrt(t)
    df = math.exp(-r * t)
    k2 = 2.0 * r / sig**2
    if is_call:
        if k > s:
            d1 = (math.log(s / k) + (r + 0.5 * sig**2) * t) / sq
            d2 = d1 - sq
            tail = (-(s / k) ** (-k2) * _norm_cdf(d1 - k2 * sq)
                    + math.exp(r * t) * _norm_cdf(d1))
            return s * _norm_cdf(d1) - k * df * _norm_cdf(d2) \
                + s * df / k2 * tail
        # K <= spot: max >= S0 > K always, so payoff = max - K and
        # df E[max] = floating_put + df E[S_T] = floating_put + S0
        # (martingale) => value = S0 - K df + floating_put
        return s - k * df + lookback_floating_strike_value(
            s, r, sig, t, is_call=False)
    if k < s:
        d1 = (math.log(s / k) + (r + 0.5 * sig**2) * t) / sq
        d2 = d1 - sq
        tail = ((s / k) ** (-k2) * _norm_cdf(-d1 + k2 * sq)
                - math.exp(r * t) * _norm_cdf(-d1))
        return k * df * _norm_cdf(-d2) - s * _norm_cdf(-d1) \
            + s * df / k2 * tail
    # K >= spot: payoff = K - min and df E[min] = S0 - floating_call
    # => value = K df - S0 + floating_call
    return k * df - s + lookback_floating_strike_value(
        s, r, sig, t, is_call=True)
