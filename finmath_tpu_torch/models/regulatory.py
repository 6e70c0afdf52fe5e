"""Regulatory counterparty-credit measures on exposure profiles:
SA-CCR EAD (BCBS 279), capital profiles, and KVA.

Counterpart of ``finmath_tpu.models.regulatory``, copied whole: host NumPy
float64 on a handful of dates and trades, so the same inputs give the same
bits in both packages. The exposure workloads (finmath-lib
``ExposureEstimator``; the port's ``NettingSetExposureEngine``) feed these
downstream measures: EAD under the standardized approach for counterparty
credit risk, the default-risk and CVA-risk capital they imply, and the
capital valuation adjustment (KVA) that prices holding that capital over
the netting set's life. A profile is read through its ``times`` and
``forward_value`` (``models/lmm/exposure.py``'s ``ExposureProfile``).

Implemented per the Basel texts:

* SA-CCR (BCBS 279, March 2014): replacement cost, the interest-rate
  add-on with its supervisory duration / maturity-bucket correlation
  aggregation, the PFE multiplier with its exp() dampening on negative
  MtM, supervisory option deltas (Black with the 50% supervisory IR
  vol), alpha = 1.4.
* Default-risk capital: K = 8% x RW x EAD (standardized risk weight).
* CVA-risk capital: the Basel III standardized CVA charge for a single
  counterparty (the sqrt-formula with rho = 0.5 degenerates to
  K = 2.33 x sqrt(h) x 0.5 ... see ``cva_capital``), with the
  discounted effective-maturity convention.
* KVA: the cost-of-capital integral of the capital profile against the
  joint survival — the same rectangle-rule convention as
  ``fva_from_profile`` / ``mva_from_im_profile``.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Optional, Sequence

import numpy as np

#: SA-CCR constants for the interest-rate asset class (BCBS 279)
ALPHA = 1.4                      # EAD = alpha * (RC + multiplier * AddOn)
IR_SUPERVISORY_FACTOR = 0.005    # 0.50%
IR_SUPERVISORY_VOL = 0.50        # supervisory option volatility
MULTIPLIER_FLOOR = 0.05
#: maturity-bucket correlation aggregation weights (para 166):
#: EN^2 = D1^2 + D2^2 + D3^2 + 1.4 D1 D2 + 1.4 D2 D3 + 0.6 D1 D3
_BUCKET_CROSS = {(0, 1): 1.4, (1, 2): 1.4, (0, 2): 0.6}

_PHI = NormalDist().cdf


@dataclass(frozen=True)
class SACCRTrade:
    """One interest-rate derivative as SA-CCR sees it.

    ``notional``: trade notional (currency units, positive).
    ``start`` / ``end``: S and E of the interest-rate leg in YEARS from
    today (S = 0 for a running swap; S > 0 forward-starting / the
    underlying of an unexercised option).
    ``delta``: supervisory delta — +-1 for linear trades (+1 long the
    primary risk factor = payer swap, -1 receiver); options use
    ``supervisory_option_delta``.
    ``hedging_set``: currency key — add-ons aggregate WITHIN a hedging
    set and sum ACROSS sets (no cross-currency offset).
    """

    notional: float
    start: float
    end: float
    delta: float = 1.0
    hedging_set: str = "USD"

    def __post_init__(self):
        if self.notional < 0:
            raise ValueError("notional must be >= 0 (direction via delta)")
        if not (0.0 <= self.start < self.end):
            raise ValueError("need 0 <= start < end (years)")


def supervisory_option_delta(forward: float, strike: float, expiry: float,
                             call: bool = True, long: bool = True,
                             vol: float = IR_SUPERVISORY_VOL) -> float:
    """SA-CCR supervisory delta of an option (BCBS 279 para 159): the
    Black delta at the supervisory volatility,
    ``+-Phi(+-(ln(F/K) + 0.5 sigma^2 T) / (sigma sqrt(T)))`` — sign from
    bought/sold x call/put. For a payer swaption, ``call=True`` on the
    forward par rate."""
    if forward <= 0 or strike <= 0:
        raise ValueError("supervisory delta needs positive forward/strike "
                         "(shift the rates first for negative-rate markets)")
    if expiry <= 0:
        raise ValueError("expiry must be positive")
    d1 = (np.log(forward / strike) + 0.5 * vol * vol * expiry) \
        / (vol * np.sqrt(expiry))
    delta = _PHI(d1) if call else -_PHI(-d1)
    return float(delta if long else -delta)


def _supervisory_duration(start: float, end: float) -> float:
    """SD_i = (exp(-0.05 S) - exp(-0.05 E)) / 0.05 (para 157)."""
    return (np.exp(-0.05 * start) - np.exp(-0.05 * end)) / 0.05


def _maturity_factor(maturity: float, margined: bool,
                     mpor_years: float) -> float:
    """MF (paras 164-165): unmargined sqrt(min(M, 1y) / 1y), margined
    1.5 sqrt(MPOR / 1y)."""
    if margined:
        return 1.5 * np.sqrt(mpor_years)
    return np.sqrt(min(max(maturity, 10.0 / 250.0), 1.0))


def _bucket(end: float) -> int:
    """Maturity buckets on the END date (para 166): <1y, 1-5y, >5y."""
    if end < 1.0:
        return 0
    if end <= 5.0:
        return 1
    return 2


def saccr_addon(trades: Sequence[SACCRTrade], margined: bool = False,
                mpor_years: float = 10.0 / 250.0) -> float:
    """Aggregate SA-CCR interest-rate add-on of a netting set: per
    hedging set (currency), per maturity bucket, the effective notional
    ``D_jk = sum_i delta_i x N_i x SD_i x MF_i``; buckets aggregate with
    the 1.4 / 0.6 cross terms; hedging sets sum; times the 0.5%
    supervisory factor."""
    if not trades:
        raise ValueError("need at least one trade")
    sets: dict = {}
    for tr in trades:
        d = sets.setdefault(tr.hedging_set, np.zeros(3))
        eff = (tr.delta * tr.notional
               * _supervisory_duration(tr.start, tr.end)
               * _maturity_factor(tr.end, margined, mpor_years))
        d[_bucket(tr.end)] += eff
    addon = 0.0
    for d in sets.values():
        en2 = float(np.sum(d * d))
        for (i, j), w in _BUCKET_CROSS.items():
            en2 += w * d[i] * d[j]
        addon += IR_SUPERVISORY_FACTOR * np.sqrt(max(en2, 0.0))
    return float(addon)


def saccr_multiplier(value: float, collateral: float,
                     addon: float) -> float:
    """PFE multiplier (para 149): 1 when uncollateralized MtM >= 0,
    exp-dampened towards the 5% floor as V - C goes negative."""
    if addon <= 0.0:
        return 1.0
    x = value - collateral
    if x >= 0.0:
        return 1.0
    return float(min(1.0, MULTIPLIER_FLOOR + (1.0 - MULTIPLIER_FLOOR)
                     * np.exp(x / (2.0 * (1.0 - MULTIPLIER_FLOOR) * addon))))


def saccr_ead(value: float, trades: Sequence[SACCRTrade],
              collateral: float = 0.0, margined: bool = False,
              threshold: float = 0.0, mta: float = 0.0,
              nica: float = 0.0,
              mpor_years: float = 10.0 / 250.0) -> float:
    """SA-CCR exposure at default of one netting set:
    ``EAD = 1.4 x (RC + multiplier x AddOn)`` with
    RC = max(V - C, 0) unmargined, max(V - C, TH + MTA - NICA, 0)
    margined (paras 144-147)."""
    rc = max(value - collateral, 0.0)
    if margined:
        rc = max(rc, threshold + mta - nica)
    addon = saccr_addon(trades, margined, mpor_years)
    m = saccr_multiplier(value, collateral, addon)
    return float(ALPHA * (rc + m * addon))


def _age_trades(trades: Sequence[SACCRTrade], t: float):
    """The netting set as SA-CCR sees it at future time t: starts/ends
    roll down, matured trades drop out."""
    aged = []
    for tr in trades:
        if tr.end - t <= 0.0:
            continue
        aged.append(SACCRTrade(tr.notional, max(tr.start - t, 0.0),
                               tr.end - t, tr.delta, tr.hedging_set))
    return aged


def saccr_ead_profile(profile, trades: Sequence[SACCRTrade],
                      margined: bool = False,
                      mpor_years: float = 10.0 / 250.0) -> np.ndarray:
    """Forward EAD profile: SA-CCR re-evaluated at every observation
    date of an ``ExposureProfile`` with the trades AGED to that date and
    the expected forward value as the MtM (the standard forward-capital
    approximation for KVA — re-simulating SA-CCR pathwise is possible
    but the convexity of RC in V is second-order against the add-on for
    rate netting sets). Returns one EAD per observation date (0 once
    everything matured)."""
    out = np.zeros(len(profile.times))
    for i, t in enumerate(profile.times):
        aged = _age_trades(trades, float(t))
        if not aged:
            continue
        out[i] = saccr_ead(float(profile.forward_value[i]), aged,
                           margined=margined, mpor_years=mpor_years)
    return out


def ccr_capital_profile(ead: np.ndarray, risk_weight: float = 1.0,
                        capital_ratio: float = 0.08) -> np.ndarray:
    """Default-risk capital per date: K = capital_ratio x RW x EAD
    (standardized credit risk; RW = 1 for an unrated corporate, 0.2/0.5
    for banks by rating)."""
    if risk_weight < 0 or capital_ratio < 0:
        raise ValueError("risk weight / capital ratio must be >= 0")
    return capital_ratio * risk_weight * np.asarray(ead, dtype=np.float64)


def cva_capital(ead: float, effective_maturity: float,
                counterparty_weight: float = 0.01,
                horizon: float = 1.0) -> float:
    """Basel III standardized CVA risk charge, one counterparty, no
    hedges: the general formula
    ``K = 2.33 sqrt(h) sqrt((0.5 w M EAD_disc)^2 + 0.75 (w M EAD_disc)^2)``
    with the discounted EAD convention
    ``EAD_disc = EAD x (1 - exp(-0.05 M)) / (0.05 M)``; ``w`` is the
    rating weight (0.7%-10%; 1% = single-A)."""
    if effective_maturity <= 0:
        raise ValueError("effective maturity must be positive")
    m = effective_maturity
    ead_d = ead * (1.0 - np.exp(-0.05 * m)) / (0.05 * m)
    s = counterparty_weight * m * ead_d
    return float(2.33 * np.sqrt(horizon) * np.sqrt(0.25 * s * s
                                                   + 0.75 * s * s))


def cva_capital_profile(ead: np.ndarray, times: np.ndarray,
                        maturity: float,
                        counterparty_weight: float = 0.01) -> np.ndarray:
    """CVA-risk capital per observation date: the standardized charge
    re-evaluated with the REMAINING effective maturity (zero once the
    set matures)."""
    times = np.asarray(times, dtype=np.float64)
    out = np.zeros_like(times)
    for i, t in enumerate(times):
        m = maturity - t
        if m <= 0 or ead[i] <= 0:
            continue
        out[i] = cva_capital(float(ead[i]), float(m), counterparty_weight)
    return out


def kva_from_capital_profile(times: np.ndarray, capital: np.ndarray,
                             cost_of_capital: float = 0.10,
                             counterparty_hazard_rate: float = 0.0,
                             own_hazard_rate: float = 0.0,
                             discount_rate: float = 0.0) -> float:
    """Capital valuation adjustment: the cost of holding the capital
    profile over the netting set's life,

    ``KVA = sum_i cc x K(t_i) x S(t_i) x df(t_i) x dt_i``

    (rectangle rule; ``S`` the joint survival — capital is released at
    the first default — and ``df`` a flat funding discount). The same
    grid conventions as ``fva_from_profile``."""
    times = np.asarray(times, dtype=np.float64)
    capital = np.asarray(capital, dtype=np.float64)
    if times.shape != capital.shape:
        raise ValueError("times and capital must align")
    dt = np.diff(np.concatenate([[0.0], times]))
    h = counterparty_hazard_rate + own_hazard_rate
    surv = np.exp(-h * times)
    df = np.exp(-discount_rate * times)
    return float(np.sum(cost_of_capital * capital * surv * df * dt))


def kva(profile, trades: Sequence[SACCRTrade],
        cost_of_capital: float = 0.10, risk_weight: float = 1.0,
        counterparty_weight: float = 0.01,
        include_cva_capital: bool = True,
        counterparty_hazard_rate: float = 0.0,
        own_hazard_rate: float = 0.0,
        discount_rate: float = 0.0, margined: bool = False) -> float:
    """One-call KVA of a netting set: SA-CCR EAD profile from the
    exposure profile's forward values -> default-risk (+ optionally
    CVA-risk) capital -> cost-of-capital integral."""
    ead = saccr_ead_profile(profile, trades, margined=margined)
    cap = ccr_capital_profile(ead, risk_weight)
    if include_cva_capital:
        maturity = max(tr.end for tr in trades)
        cap = cap + cva_capital_profile(ead, profile.times, maturity,
                                        counterparty_weight)
    return kva_from_capital_profile(
        profile.times, cap, cost_of_capital,
        counterparty_hazard_rate, own_hazard_rate, discount_rate)
