"""Discount/forward curves and the par-swap bootstrap.

Equivalents of finmath-lib's marketdata layer as used by the reference's
ATM calibration test (LIBORMarketModelCalibrationATMTest.java:525-663),
copied unchanged from ``finmath_tpu.models.curves`` (host-side NumPy; the
tests hold the two bit for bit):
a discount curve interpolated log-linearly in the discount factors
(InterpolationMethod.LINEAR on InterpolationEntity.LOG_OF_VALUE, constant
extrapolation — ref. :607-616), a forward curve derived from it
(ForwardCurveFromDiscountCurve, ref. :583), and a bootstrap that calibrates
the pillar discount factors so a strip of par swaps (annual fixed vs
semiannual float, single-curve — ref. :526-536) price to zero.

Curves are host-side float64 objects (they parameterize models; per-path
arithmetic never touches them), with vectorized NumPy accessors.
Schedules are idealized year fractions — the
reference itself rounds everything onto an idealized 0.25/0.5 grid for the
LMM (ref. :246-248).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class DiscountCurve:
    """Discount factors, log-linear interpolation; beyond the last pillar
    the LOG discount factor is held constant (df(t) = df(t_last), i.e.
    zero forward rates past the grid) — finmath's CONSTANT extrapolation
    on LOG_OF_VALUE, NOT constant-zero-rate extrapolation."""

    def __init__(self, pillar_times: Sequence[float], discount_factors: Sequence[float],
                 name: str = "discountCurve"):
        t = np.asarray(pillar_times, dtype=np.float64)
        v = np.asarray(discount_factors, dtype=np.float64)
        order = np.argsort(t)
        self.times = t[order]
        self.factors = v[order]
        self.name = name
        if self.times[0] > 0.0:
            self.times = np.concatenate([[0.0], self.times])
            self.factors = np.concatenate([[1.0], self.factors])
        self._log_factors = np.log(self.factors)

    def get_discount_factor(self, time) -> np.ndarray:
        """df(t); vectorized over t (float64 host math)."""
        t = np.asarray(time, dtype=np.float64)
        log_df = np.interp(t, self.times, self._log_factors)
        # constant extrapolation of log df beyond last pillar would freeze
        # df; finmath's CONSTANT extrapolation on LOG_OF_VALUE does exactly
        # that (value held constant), so np.interp's edge behavior matches.
        return np.exp(log_df)

    def get_zero_rate(self, time) -> np.ndarray:
        t = np.maximum(np.asarray(time, dtype=np.float64), 1e-10)
        return -np.log(self.get_discount_factor(t)) / t

    getDiscountFactor = get_discount_factor

    def __repr__(self):
        return f"DiscountCurve({self.name}, pillars={len(self.times)})"


class ForwardCurve:
    """Simply-compounded forward rates L(t; t, t+tenor) read off a discount
    curve (ForwardCurveFromDiscountCurve semantics)."""

    def __init__(self, discount_curve: DiscountCurve, payment_offset: float = 0.5,
                 name: str = None):
        self.discount_curve = discount_curve
        self.payment_offset = float(payment_offset)
        self.name = name or f"ForwardCurveFromDiscountCurve({discount_curve.name},{payment_offset})"

    def get_forward(self, fixing_time) -> np.ndarray:
        t = np.asarray(fixing_time, dtype=np.float64)
        df0 = self.discount_curve.get_discount_factor(t)
        df1 = self.discount_curve.get_discount_factor(t + self.payment_offset)
        return (df0 / df1 - 1.0) / self.payment_offset

    getForward = get_forward

    def __repr__(self):
        return f"ForwardCurve({self.name})"


class ForwardCurveFromForwards:
    """Forward curve interpolated from given (fixing, forward) pairs —
    finmath's ForwardCurveInterpolation.createForwardCurveFromForwards as
    used by the benchmark test (LIBORMarketModelCalibrationTest.java:
    195-215: 100 semiannual fixings to 50Y). Linear interpolation in the
    fixing time, constant extrapolation."""

    def __init__(self, fixing_times, forwards, payment_offset: float = 0.5,
                 name: str = "forwardCurve"):
        self.fixing_times = np.asarray(fixing_times, dtype=np.float64)
        self.forwards = np.asarray(forwards, dtype=np.float64)
        self.payment_offset = float(payment_offset)
        self.name = name

    def get_forward(self, fixing_time) -> np.ndarray:
        t = np.asarray(fixing_time, dtype=np.float64)
        return np.interp(t, self.fixing_times, self.forwards)

    getForward = get_forward


class DiscountCurveFromForwardCurve(DiscountCurve):
    """Discount factors implied by a forward curve in the single-curve
    setup: df(T_{j+1}) = df(T_j) / (1 + delta * f(T_j)) — finmath's
    DiscountCurveFromForwardCurve (benchmark test :216, ATM test :355)."""

    def __init__(self, forward_curve, horizon: float = 50.0,
                 name: str = "discountCurveFromForwardCurve"):
        delta = forward_curve.payment_offset
        n = int(round(horizon / delta))
        times = [0.0]
        factors = [1.0]
        for j in range(n):
            t = j * delta
            f = float(forward_curve.get_forward(t))
            factors.append(factors[-1] / (1.0 + delta * f))
            times.append(t + delta)
        super().__init__(times, factors, name)


# ---------------------------------------------------------------------------
# swap analytics on curves (host, float64)
# ---------------------------------------------------------------------------

def swap_annuity(discount_curve: DiscountCurve, payment_times: Sequence[float],
                 period_lengths: Sequence[float] = None) -> float:
    """Sum_k delta_k * df(t_k) over the fixed-leg payment times."""
    pay = np.asarray(payment_times, dtype=np.float64)
    if period_lengths is None:
        starts = np.concatenate([[0.0], pay[:-1]]) if len(pay) else pay
        deltas = pay - starts
    else:
        deltas = np.asarray(period_lengths, dtype=np.float64)
    return float(np.sum(deltas * discount_curve.get_discount_factor(pay)))


def par_swap_rate(forward_curve: ForwardCurve, discount_curve: DiscountCurve,
                  swap_tenor: Sequence[float]) -> float:
    """Forward-starting par swap rate on the tenor grid [T_0, ..., T_n]
    (fixed and float legs on the same grid, like the reference's
    getParSwaprate, ATM test :667-669)."""
    tenor = np.asarray(swap_tenor, dtype=np.float64)
    starts, ends = tenor[:-1], tenor[1:]
    deltas = ends - starts
    df_pay = discount_curve.get_discount_factor(ends)
    annuity = float(np.sum(deltas * df_pay))
    floating = float(
        np.sum(deltas * forward_curve.get_forward(starts) * df_pay)
    )
    return floating / annuity


# ---------------------------------------------------------------------------
# bootstrap
# ---------------------------------------------------------------------------

def bootstrap_discount_curve(maturities: Sequence[float], swap_rates: Sequence[float],
                             fixed_frequency: float = 1.0,
                             float_frequency: float = 0.5,
                             name: str = "discountCurve-EUR") -> DiscountCurve:
    """Sequential bootstrap of pillar discount factors from par swap rates.

    Single-curve setup (forwards read off the same discount curve, ref. ATM
    test :577-583), idealized schedules: fixed leg pays every
    ``fixed_frequency`` years, float leg every ``float_frequency``. In the
    single-curve case the float leg telescopes to df(0) - df(T), so each
    pillar is a 1-D root-find over the new discount factor (interpolated
    pillars in between are log-linear in the curve).
    """
    mats = np.asarray(maturities, dtype=np.float64)
    rates = np.asarray(swap_rates, dtype=np.float64)
    order = np.argsort(mats)
    mats, rates = mats[order], rates[order]

    pillar_times = [0.0]
    pillar_factors = [1.0]

    for maturity, rate in zip(mats, rates):
        n_fixed = max(int(round(maturity / fixed_frequency)), 1)
        if maturity < fixed_frequency:  # short stub (e.g. the 6M swap)
            fixed_times = np.asarray([maturity])
            fixed_deltas = np.asarray([maturity])
        else:
            fixed_times = fixed_frequency * np.arange(1, n_fixed + 1)
            fixed_deltas = np.full(n_fixed, fixed_frequency)
            fixed_times[-1] = maturity

        def objective(df_new):
            curve = DiscountCurve(
                pillar_times + [maturity], pillar_factors + [df_new], name
            )
            fixed_leg = rate * float(
                np.sum(fixed_deltas * curve.get_discount_factor(fixed_times))
            )
            float_leg = 1.0 - df_new  # telescoped single-curve float leg
            return fixed_leg - float_leg

        # bisection: df in (1e-4, 2.0); par objective is monotone in df_new
        lo, hi = 1e-4, 2.0
        f_lo, f_hi = objective(lo), objective(hi)
        if f_lo * f_hi > 0:
            raise ValueError(f"bootstrap failed to bracket at maturity {maturity}")
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            f_mid = objective(mid)
            if f_lo * f_mid <= 0:
                hi, f_hi = mid, f_mid
            else:
                lo, f_lo = mid, f_mid
            if hi - lo < 1e-14:
                break
        pillar_times.append(float(maturity))
        pillar_factors.append(0.5 * (lo + hi))

    return DiscountCurve(pillar_times, pillar_factors, name)


# The reference test's EUR market data snapshot (2016-09-30), ATM test
# :527-536 — par swap rates for the bootstrap.
EUR_SWAP_MATURITIES = np.asarray(
    [0.5, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 15, 20, 25, 30, 35, 40, 45, 50],
    dtype=np.float64,
)
EUR_SWAP_RATES = np.asarray(
    [-0.00216, -0.00208, -0.00222, -0.00216, -0.0019, -0.0014, -0.00072,
     0.00011, 0.00103, 0.00196, 0.00285, 0.00367, 0.0044, 0.00604, 0.00733,
     0.00767, 0.00773, 0.00765, 0.00752, 0.007138, 0.007],
    dtype=np.float64,
)


def get_calibrated_eur_curve() -> DiscountCurve:
    """The bootstrapped EUR discount curve of the reference's ATM test."""
    return bootstrap_discount_curve(EUR_SWAP_MATURITIES, EUR_SWAP_RATES)
