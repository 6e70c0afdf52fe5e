"""Cap/floor analytics on curves and caplet-volatility stripping.

Counterpart of ``finmath_tpu.models.caps`` (finmath-lib's
``net.finmath.marketdata.products.Cap`` with ``CapletVolatilities``):
caps priced through a caplet volatility curve, and that curve bootstrapped
from quoted cap prices or flat volatilities per maturity.

* :func:`cap_value`: a cap as the sum of Black'76 / Bachelier caplets on
  the curves;
* :func:`implied_flat_cap_volatility`: the one flat volatility that
  reprices a cap (the market's quoting convention);
* :func:`strip_caplet_volatilities`: sequential bootstrap of a
  piecewise-constant (in fixing time) caplet volatility curve from
  flat-vol or price quotes at increasing maturities;
* :func:`strip_caplet_surface`: the same per strike column of a
  (maturity x strike) quote matrix;
* :class:`LIBORVolatilityModelFromCapletCurve`: the stripped curve as an
  LMM volatility model (the covariance API of ``lmm/covariance.py``).
  Under the lognormal state space sigma_i(t) = sigma_caplet(T_i)
  reproduces every caplet price by construction, so Monte-Carlo cap
  prices on the valuation engine tie out against :func:`cap_value`.

Everything but the volatility model's table is host NumPy float64 with
the JAX module's arithmetic: a chain of scalar root-finds, one flat
segment per quoted maturity, with no path axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .analytic import bachelier_formula, black_formula
from .curves import DiscountCurve, ForwardCurve
from .lmm.covariance import _DeviceTables

__all__ = [
    "make_cap_schedule",
    "cap_value",
    "implied_flat_cap_volatility",
    "CapletVolatilityCurve",
    "strip_caplet_volatilities",
    "strip_caplet_surface",
    "LIBORVolatilityModelFromCapletCurve",
]


def make_cap_schedule(maturity: float, period: float,
                      first_fixing: Optional[float] = None) -> np.ndarray:
    """Fixing times of a standard cap: the first caplet fixes at
    ``first_fixing`` (default: one period, the spot-starting period being
    already fixed), the last pays at ``maturity``. Payments are
    ``fixings + period``."""
    if period <= 0.0:
        raise ValueError("need period > 0")
    start = period if first_fixing is None else float(first_fixing)
    n = int(round((maturity - start) / period))
    if n < 1 or abs(start + n * period - maturity) > 1e-9:
        raise ValueError(
            f"maturity {maturity} not reachable from first fixing {start} "
            f"in steps of {period}")
    return start + period * np.arange(n, dtype=np.float64)


def _caplet_values(discount_curve: DiscountCurve, forward_curve: ForwardCurve,
                   fixings: np.ndarray, period: float, strike: float,
                   vols: np.ndarray, convention: str,
                   displacement: float) -> np.ndarray:
    """Per-caplet formula value times delta times df(payment)."""
    fixings = np.asarray(fixings, dtype=np.float64)
    vols = np.broadcast_to(np.asarray(vols, dtype=np.float64), fixings.shape)
    dfs = discount_curve.get_discount_factor(fixings + period)
    fwds = np.asarray(forward_curve.get_forward(fixings), dtype=np.float64)
    out = np.empty_like(fixings)
    for j, (t, f, v, df) in enumerate(zip(fixings, fwds, vols, dfs)):
        unit = period * float(df)
        if convention == "lognormal":
            out[j] = black_formula(f + displacement, strike + displacement,
                                   float(v), float(t), payoff_unit=unit)
        elif convention == "normal":
            out[j] = bachelier_formula(f, strike, float(v), float(t),
                                       payoff_unit=unit)
        else:
            raise ValueError(f"unknown convention {convention!r}")
    return out


def cap_value(discount_curve: DiscountCurve, forward_curve: ForwardCurve,
              fixings: Sequence[float], period: float, strike: float,
              caplet_volatilities, convention: str = "lognormal",
              displacement: float = 0.0, is_cap: bool = True) -> float:
    """Value of a cap (or floor, by parity per caplet) as the sum of its
    caplets, each with its own volatility (a scalar is flat).

    ``convention``: "lognormal" (Black'76, optionally displaced) or
    "normal" (Bachelier). Floorlet = caplet - delta (F - K) df."""
    fixings = np.asarray(fixings, dtype=np.float64)
    caps = _caplet_values(discount_curve, forward_curve, fixings, period,
                          strike, caplet_volatilities, convention,
                          displacement)
    if is_cap:
        return float(np.sum(caps))
    fwds = np.asarray(forward_curve.get_forward(fixings), dtype=np.float64)
    dfs = discount_curve.get_discount_factor(fixings + period)
    intrinsic = period * (fwds - strike) * dfs
    return float(np.sum(caps - intrinsic))


def implied_flat_cap_volatility(price: float, discount_curve: DiscountCurve,
                                forward_curve: ForwardCurve,
                                fixings: Sequence[float], period: float,
                                strike: float,
                                convention: str = "lognormal",
                                displacement: float = 0.0,
                                tol: float = 1e-12) -> float:
    """The single volatility that reprices the cap, by bisection (the
    value is monotone in the volatility)."""

    def f(v):
        return cap_value(discount_curve, forward_curve, fixings, period,
                         strike, v, convention, displacement) - price

    lo, hi = 1e-9, 5.0 if convention == "lognormal" else 1.0
    flo, fhi = f(lo), f(hi)
    if flo > 0.0:
        raise ValueError(
            f"cap price {price} below intrinsic value {price - flo:.10g}")
    if fhi < 0.0:
        raise ValueError(f"cap price {price} above the vol={hi} value")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) < 0.0:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


class CapletVolatilityCurve:
    """Piecewise-constant caplet volatility in fixing time: vol(t) =
    sigma_k for t in [M_{k-1}, M_k) with M_0 = 0, constant past the last
    stripped maturity. A fixing AT a cap maturity pays one period later,
    so it belongs to the longer cap: boundaries belong to the right
    segment."""

    def __init__(self, segment_ends: Sequence[float], volatilities: Sequence[float],
                 convention: str = "lognormal", displacement: float = 0.0,
                 strike: Optional[float] = None):
        ends = np.asarray(segment_ends, dtype=np.float64)
        vols = np.asarray(volatilities, dtype=np.float64)
        if ends.shape != vols.shape or ends.ndim != 1 or len(ends) == 0:
            raise ValueError("need matching 1-d segment_ends/volatilities")
        if np.any(np.diff(ends) <= 0.0):
            raise ValueError("segment ends must be strictly increasing")
        self.segment_ends = ends
        self.volatilities = vols
        self.convention = convention
        self.displacement = float(displacement)
        self.strike = strike

    def get_caplet_volatility(self, fixing_time) -> np.ndarray:
        """Vectorized piecewise-constant lookup."""
        t = np.asarray(fixing_time, dtype=np.float64)
        idx = np.minimum(np.searchsorted(self.segment_ends, t, side="right"),
                         len(self.segment_ends) - 1)
        return self.volatilities[idx]

    getCapletVolatility = get_caplet_volatility

    def __repr__(self):
        return (f"CapletVolatilityCurve({self.convention}, "
                f"segments={len(self.segment_ends)})")


def strip_caplet_volatilities(discount_curve: DiscountCurve,
                              forward_curve: ForwardCurve,
                              cap_maturities: Sequence[float],
                              quotes: Sequence[float],
                              strike: float, period: float,
                              convention: str = "lognormal",
                              quote_type: str = "flat_volatility",
                              displacement: float = 0.0,
                              first_fixing: Optional[float] = None,
                              ) -> CapletVolatilityCurve:
    """Bootstrap piecewise-constant caplet volatilities from co-terminal
    cap quotes at increasing maturities, all at one strike.

    Cap k holds every caplet of cap k-1 plus the fixings in (M_{k-1},
    M_k]; its price less the stripped front caplets leaves a monotone 1-d
    root-find for the new segment's volatility. ``quote_type``:
    "flat_volatility" (converted to prices first) or "price"."""
    mats = np.asarray(cap_maturities, dtype=np.float64)
    q = np.asarray(quotes, dtype=np.float64)
    if mats.shape != q.shape or mats.ndim != 1 or len(mats) == 0:
        raise ValueError("need matching 1-d maturities/quotes")
    if np.any(np.diff(mats) <= 0.0):
        raise ValueError("cap maturities must be strictly increasing")
    if quote_type not in ("flat_volatility", "price"):
        raise ValueError(f"unknown quote_type {quote_type!r}")

    all_fixings = make_cap_schedule(float(mats[-1]), period, first_fixing)
    seg_vols = []
    prev_end = 0.0
    front_value = 0.0
    for m, quote in zip(mats, q):
        fixings_k = all_fixings[all_fixings + period <= m + 1e-9]
        if quote_type == "flat_volatility":
            target = cap_value(discount_curve, forward_curve, fixings_k,
                               period, strike, float(quote), convention,
                               displacement)
        else:
            target = float(quote)
        new = fixings_k[fixings_k > prev_end + 1e-9]
        if len(new) == 0:
            raise ValueError(
                f"cap maturity {m} adds no new caplet past {prev_end}")
        residual = target - front_value

        def seg_value(v):
            return cap_value(discount_curve, forward_curve, new, period,
                             strike, v, convention, displacement)

        lo, hi = 1e-9, 5.0 if convention == "lognormal" else 1.0
        if seg_value(lo) > residual + 1e-15:
            raise ValueError(
                f"cap quote at maturity {m} is below the value already "
                f"locked in by shorter maturities (residual {residual:.6g} "
                f"< intrinsic {seg_value(lo):.6g}): quotes not "
                f"arbitrage-consistent")
        if seg_value(hi) < residual:
            raise ValueError(
                f"cap quote at maturity {m} needs segment vol > {hi}")
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if seg_value(mid) < residual:
                lo = mid
            else:
                hi = mid
            if hi - lo < 1e-13:
                break
        v_seg = 0.5 * (lo + hi)
        seg_vols.append(v_seg)
        front_value += seg_value(v_seg)
        prev_end = float(new[-1])
    return CapletVolatilityCurve(mats, seg_vols, convention, displacement,
                                 strike)


def strip_caplet_surface(discount_curve: DiscountCurve,
                         forward_curve: ForwardCurve,
                         cap_maturities: Sequence[float],
                         strikes: Sequence[float],
                         quote_matrix, period: float,
                         convention: str = "lognormal",
                         quote_type: str = "flat_volatility",
                         displacement: float = 0.0) -> list:
    """Strip a (maturity x strike) cap quote matrix column by column: one
    :func:`strip_caplet_volatilities` per strike. Returns one
    :class:`CapletVolatilityCurve` per strike."""
    quote_matrix = np.asarray(quote_matrix, dtype=np.float64)
    if quote_matrix.shape != (len(cap_maturities), len(strikes)):
        raise ValueError("quote_matrix must be [maturities, strikes]")
    return [
        strip_caplet_volatilities(discount_curve, forward_curve,
                                  cap_maturities, quote_matrix[:, j],
                                  float(K), period, convention, quote_type,
                                  displacement)
        for j, K in enumerate(strikes)
    ]


class LIBORVolatilityModelFromCapletCurve:
    """LMM volatility model pinned to a stripped caplet curve, with no
    parameters: sigma_i(t) = sigma_caplet(T_i) for every simulation time
    t < T_i. Under the lognormal state space caplet i depends on its own
    total variance sigma_i^2 T_i only, so the Monte-Carlo engine
    reproduces every stripped caplet price by construction (finmath's
    ``LIBORVolatilityModelFromGivenMatrix`` over a bootstrapped surface).

    The interface of ``LIBORVolatilityModelPiecewiseConstant``:
    ``n_params = 0``, and ``vol_table(params)`` returns the constant
    ``[steps, libors]`` float64 table (0 where the forward is already
    fixed) on the device of ``params``, the engine's."""

    def __init__(self, simulation_td, libor_td,
                 caplet_curve: CapletVolatilityCurve):
        if caplet_curve.convention != "lognormal":
            raise ValueError(
                "LMM lognormal state space needs lognormal caplet vols; "
                "convert normal quotes first")
        self.simulation_td = simulation_td
        self.libor_td = libor_td
        self.caplet_curve = caplet_curve
        n_steps = simulation_td.get_number_of_time_steps()
        n_libor = libor_td.get_number_of_time_steps()
        table = np.zeros((n_steps, n_libor), dtype=np.float64)
        for m in range(n_steps):
            t = simulation_td.get_time(m)
            for i in range(n_libor):
                T_i = libor_td.get_time(i)
                if T_i - t > 0.0:
                    table[m, i] = caplet_curve.get_caplet_volatility(T_i)
        self.n_params = 0
        self.initial_parameters = np.zeros(0, dtype=np.float64)
        self._tables = _DeviceTables(table=table)

    def vol_table(self, params: torch.Tensor) -> torch.Tensor:
        return self._tables.on(params.device)["table"]
