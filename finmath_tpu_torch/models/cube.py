"""Swaption volatility cube (SABR per cell) and CMS replication pricing
under a linear terminal-swap-rate (TSR) annuity mapping.

Counterpart of ``finmath_tpu.models.cube`` (finmath-lib's
``net.finmath.singleswaprate``: ``SABRVolatilityCube``, the annuity
mappings and ``CmsOptionReplicationProduct``), host NumPy float64 with
the JAX module's arithmetic: prices are scalars and the quadrature takes
microseconds.

* Each cube cell holds a SABR fit of one smile (``sabr.calibrate_sabr``);
  queries interpolate the cells' VOLS at the requested strike
  bilinearly in (expiry, tenor) (not the SABR parameters, whose map is
  not convex).
* Annuity mapping: the Hunt-Kennedy linear swap-rate model
  alpha(S) = a S + b with b = 1 / sum(delta_i) and
  a = (P(0,Tp)/A(0) - b) / S0 (martingale consistency
  E^A[alpha(S_T)] = P(0,Tp)/A(0), exact for a linear alpha).
* Replication: with c(K) = E^A[(S-K)+] the undiscounted smile call and
  E[((S-K)+)^2] = 2 int_K^inf c(x) dx,

      CMS caplet  = A0 ( b c(K) + a (2 int_K^inf c + K c(K)) )
      CMS floorlet= A0 ( b p(K) + a (K p(K) - 2 int_lb^K p) )
      CMS rate    = (a E[S^2] + b S0) / (a S0 + b),
      E[S^2]      = 2 int_lb^inf c(x) dx  (lb = -displacement)

  by 256-point Gauss-Legendre quadrature on the SABR smile. For a flat
  lognormal smile the convexity adjustment has the closed form
  a S0^2 (e^{sigma^2 T} - 1) / (a S0 + b).
* CMS spread options: a Gaussian copula over the legs' replication-implied
  marginals (:class:`CMSSpreadOptionPricer`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .analytic import black_formula
from .curves import DiscountCurve, swap_annuity
from .sabr import (
    SABRParams,
    calibrate_sabr,
    sabr_lognormal_implied_volatility,
)

_GL_X, _GL_W = np.polynomial.legendre.leggauss(256)


@dataclass(frozen=True)
class SwaptionSmile:
    """One cube cell: the par swap rate (annuity-measure martingale),
    the option expiry and the SABR fit of the smile."""
    forward: float
    expiry: float
    params: SABRParams

    def volatility(self, strike: float) -> float:
        return sabr_lognormal_implied_volatility(
            self.params, self.forward, strike, self.expiry)

    def call(self, strike) -> np.ndarray:
        """Undiscounted E^A[(S - K)+], vectorized over strikes; the
        displaced-Black value on the fitted smile."""
        d = self.params.displacement
        ks = np.atleast_1d(np.asarray(strike, dtype=np.float64))
        out = np.empty_like(ks)
        for i, k in enumerate(ks):
            if k <= -d:
                # payoff is (S - k) a.s.: S >= -d > k
                out[i] = self.forward - k
                continue
            vol = self.volatility(float(k))
            out[i] = black_formula(self.forward + d, k + d, vol,
                                   self.expiry)
        return out if out.size > 1 else float(out[0])

    def put(self, strike) -> np.ndarray:
        """E^A[(K - S)+] by put-call parity on the martingale S."""
        ks = np.atleast_1d(np.asarray(strike, dtype=np.float64))
        calls = np.atleast_1d(np.asarray(self.call(ks)))
        out = calls - (self.forward - ks)
        return out if out.size > 1 else float(out[0])


class SwaptionCube:
    """SABR smile per (expiry, tenor) cell
    (finmath SABRVolatilityCube). Build with ``add_smile`` /
    ``calibrate_cell``; query vols at any (expiry, tenor, strike) by
    bilinear interpolation of the neighboring cells' smile vols."""

    def __init__(self):
        self._cells: Dict[Tuple[float, float], SwaptionSmile] = {}

    def add_smile(self, expiry: float, tenor: float,
                  smile: SwaptionSmile) -> None:
        self._cells[(float(expiry), float(tenor))] = smile

    def calibrate_cell(self, expiry: float, tenor: float, forward: float,
                       strikes, vols, beta: float = 0.5,
                       displacement: float = 0.0) -> SwaptionSmile:
        fit = calibrate_sabr(forward, expiry, strikes, vols,
                             quote_type="lognormal", beta=beta,
                             displacement=displacement)
        smile = SwaptionSmile(forward=float(forward),
                              expiry=float(expiry), params=fit.params)
        self.add_smile(expiry, tenor, smile)
        return smile

    def get_smile(self, expiry: float, tenor: float) -> SwaptionSmile:
        key = (float(expiry), float(tenor))
        if key not in self._cells:
            raise KeyError(f"no smile at expiry={expiry}, tenor={tenor}")
        return self._cells[key]

    def get_volatility(self, expiry: float, tenor: float,
                       strike: float) -> float:
        """Bilinear interpolation in (expiry, tenor) of the cell vols
        evaluated at the strike; exact on a stored cell."""
        if not self._cells:
            raise ValueError("empty cube")
        es = sorted({e for e, _ in self._cells})
        ts = sorted({t for _, t in self._cells})

        def bracket(grid, x):
            if x <= grid[0]:
                return [(grid[0], 1.0)]
            if x >= grid[-1]:
                return [(grid[-1], 1.0)]
            hi = next(i for i, g in enumerate(grid) if g >= x)
            lo = hi - 1
            w = (x - grid[lo]) / (grid[hi] - grid[lo])
            return [(grid[lo], 1.0 - w), (grid[hi], w)]

        out, wsum = 0.0, 0.0
        for e, we in bracket(es, float(expiry)):
            for t, wt in bracket(ts, float(tenor)):
                if (e, t) not in self._cells:
                    raise KeyError(
                        f"cube grid not rectangular: missing ({e}, {t})")
                out += we * wt * self._cells[(e, t)].volatility(strike)
                wsum += we * wt
        return out / wsum

    def expiries(self):
        return sorted({e for e, _ in self._cells})

    def tenors(self):
        return sorted({t for _, t in self._cells})


@dataclass(frozen=True)
class LinearTSRAnnuityMapping:
    """Hunt-Kennedy linear swap-rate model for P(T, Tp)/A(T) = a S + b
    (finmath's annuity-mapping role): b = 1/sum(delta_i) from the
    normalization over the annuity's own payment dates, a from
    E^A[alpha(S_T)] = P(0, Tp)/A(0)."""
    a: float
    b: float

    @classmethod
    def from_curve(cls, discount_curve: DiscountCurve, forward: float,
                   swap_payment_times: Sequence[float],
                   payment_time: float,
                   period_length: float = 0.5
                   ) -> "LinearTSRAnnuityMapping":
        times = [float(t) for t in swap_payment_times]
        a0 = swap_annuity(discount_curve, times,
                          [period_length] * len(times))
        p0p = float(discount_curve.get_discount_factor(payment_time))
        b = 1.0 / (period_length * len(times))
        a = (p0p / a0 - b) / float(forward)
        return cls(a=a, b=b)

    def __call__(self, s):
        return self.a * np.asarray(s, dtype=np.float64) + self.b


class CMSReplicationPricer:
    """Static replication of CMS payoffs against one smile under a
    linear TSR annuity mapping (finmath CmsOptionReplicationProduct).
    All expectations are under the annuity measure; values are
    converted with A(0) and quoted as paid at ``payment_time``."""

    def __init__(self, smile: SwaptionSmile,
                 mapping: LinearTSRAnnuityMapping, annuity0: float,
                 strike_stddevs: float = 8.0):
        self.smile = smile
        self.map = mapping
        self.a0 = float(annuity0)
        d = smile.params.displacement
        f = smile.forward
        atm_vol = smile.volatility(f)
        self.lb = -d
        # upper integration bound: +stddevs lognormal moves of F + d
        self.ub = (f + d) * math.exp(
            strike_stddevs * atm_vol * math.sqrt(smile.expiry)) - d

    def _int_call(self, lo: float, hi: float) -> float:
        """int_lo^hi c(x) dx by 256-pt Gauss-Legendre."""
        if hi <= lo:
            return 0.0
        x = 0.5 * (hi - lo) * (_GL_X + 1.0) + lo
        return 0.5 * (hi - lo) * float(
            (_GL_W * np.asarray(self.smile.call(x))).sum())

    def _int_put(self, lo: float, hi: float) -> float:
        if hi <= lo:
            return 0.0
        x = 0.5 * (hi - lo) * (_GL_X + 1.0) + lo
        return 0.5 * (hi - lo) * float(
            (_GL_W * np.asarray(self.smile.put(x))).sum())

    def second_moment(self) -> float:
        """E^A[S^2] = lb^2 + 2 lb (S0 - lb) + 2 int_lb^inf c(x) dx
        (exact for S >= lb; reduces to 2 int_0^inf c for lb = 0)."""
        lb = self.lb
        s0 = self.smile.forward
        return lb * lb + 2.0 * lb * (s0 - lb) \
            + 2.0 * self._int_call(lb, self.ub)

    def cms_rate(self) -> float:
        """Convexity-adjusted CMS rate E^{Tp}[S_T]
        = E^A[S alpha(S)] / E^A[alpha(S)]."""
        a, b = self.map.a, self.map.b
        s0 = self.smile.forward
        return (a * self.second_moment() + b * s0) / (a * s0 + b)

    def convexity_adjustment(self) -> float:
        return self.cms_rate() - self.smile.forward

    def caplet_value(self, strike: float) -> float:
        """Value at t=0 of the CMS caplet paying (S_T - K)+ at Tp:
        A0 E^A[(S-K)+ (a S + b)] with
        E[(S-K)+ S] = 2 int_K c + K c(K)."""
        a, b = self.map.a, self.map.b
        k = float(strike)
        ck = float(self.smile.call(k))
        return self.a0 * (b * ck
                          + a * (2.0 * self._int_call(k, self.ub)
                                 + k * ck))

    def floorlet_value(self, strike: float) -> float:
        """A0 E^A[(K-S)+ (a S + b)] with
        E[(K-S)+ S] = K p(K) - 2 int_lb^K p."""
        a, b = self.map.a, self.map.b
        k = float(strike)
        pk = float(self.smile.put(k))
        return self.a0 * (b * pk
                          + a * (k * pk - 2.0 * self._int_put(self.lb, k)))

    def swaplet_value(self, strike: float = 0.0) -> float:
        """A0 E^A[(S - K) (a S + b)] — the exact linear leg; caplet -
        floorlet must reproduce it (parity test)."""
        a, b = self.map.a, self.map.b
        s0 = self.smile.forward
        k = float(strike)
        return self.a0 * (a * self.second_moment() + b * s0
                          - k * (a * s0 + b))


def flat_lognormal_convexity_adjustment(forward: float, volatility: float,
                                        expiry: float,
                                        mapping: LinearTSRAnnuityMapping
                                        ) -> float:
    """EXACT convexity adjustment for a flat lognormal smile under the
    linear TSR mapping: E[S^2] = S0^2 e^{sigma^2 T} makes
    adj = a S0^2 (e^{sigma^2 T} - 1) / (a S0 + b) closed-form — the
    quadrature oracle (also Hagan 2003 eq. 2.19a's model instance)."""
    a, b = mapping.a, mapping.b
    var = forward * forward * (math.exp(volatility * volatility * expiry)
                               - 1.0)
    return a * var / (a * forward + b)


# ---------------------------------------------------------------------------
# CMS spread options: Gaussian copula over the replication-implied marginals
# ---------------------------------------------------------------------------

def _norm_cdf_np(x):
    from math import sqrt
    try:
        from scipy.special import erf  # pragma: no cover
    except ImportError:
        erf = np.vectorize(math.erf)
    return 0.5 * (1.0 + erf(np.asarray(x, dtype=np.float64) / sqrt(2.0)))


class CMSSpreadOptionPricer:
    """(S1(T) - S2(T) - K)^+ paid at ``payment_time`` — the market-
    standard construction (Berrahoui-style): each leg's FULL
    Tp-forward-measure marginal distribution is implied from its CMS
    replication pricer (digital = -d/dK of the CMS caplet, so the TSR
    annuity mapping and the whole SABR smile are inherited, not
    re-approximated), and the legs are joined with a Gaussian copula at
    ``correlation``. Valuation = 2-d Gauss-Hermite quadrature over the
    copula normals against the numerically-inverted marginal CDFs —
    deterministic microsecond host math.

    ``normal_approximation_value`` is the dealer quick quote (Bachelier
    on the spread of the convexity-adjusted forwards) kept as a sanity
    oracle; the copula value converges to it for near-Gaussian smiles
    and corrects it for skew.
    """

    def __init__(self, leg1: CMSReplicationPricer, leg2: CMSReplicationPricer,
                 correlation: float, discount_factor: float,
                 grid_size: int = 512, quad_points: int = 96):
        if not -1.0 < float(correlation) < 1.0:
            raise ValueError("need -1 < correlation < 1")
        if leg1.smile.expiry != leg2.smile.expiry:
            raise ValueError("legs must share the fixing date")
        self.rho = float(correlation)
        self.df = float(discount_factor)
        self.legs = (leg1, leg2)
        self._z, self._w = np.polynomial.hermite_e.hermegauss(quad_points)
        self._w = self._w / math.sqrt(2.0 * math.pi)
        # per-leg quantile tables X_i(u): CDF under the Tp measure by
        # central-difference digitals of the caplet replication, inverted
        # on a monotone grid
        self._quantiles = [self._quantile_table(leg, grid_size)
                           for leg in self.legs]

    def _quantile_table(self, leg: CMSReplicationPricer, m: int):
        lo, hi = leg.lb, leg.ub
        h = (hi - lo) / (8.0 * m)
        ks = np.linspace(lo + 2 * h, hi - 2 * h, m)
        # value of 1{S>k} paid at Tp = -d/dK caplet; CDF = 1 - digital/df
        dig = -(np.asarray([leg.caplet_value(float(k) + h) for k in ks])
                - np.asarray([leg.caplet_value(float(k) - h) for k in ks])
                ) / (2.0 * h)
        cdf = 1.0 - dig / self.df
        cdf = np.clip(cdf, 0.0, 1.0)
        cdf = np.maximum.accumulate(cdf)
        # deduplicate flat segments for a well-defined inverse
        keep = np.concatenate([[True], np.diff(cdf) > 1e-12])
        return cdf[keep], ks[keep]

    def _inverse_cdf(self, leg_index: int, u):
        cdf, ks = self._quantiles[leg_index]
        return np.interp(u, cdf, ks)

    def spread_option_value(self, strike: float, is_cap: bool = True) -> float:
        """Copula value of the CMS spread cap/floorlet paid at Tp."""
        z1 = self._z[:, None]
        z2 = self.rho * z1 + math.sqrt(1.0 - self.rho * self.rho) \
            * self._z[None, :]
        x1 = self._inverse_cdf(0, _norm_cdf_np(z1 * np.ones_like(z2)))
        x2 = self._inverse_cdf(1, _norm_cdf_np(z2))
        spread = x1 - x2 - float(strike)
        pay = np.maximum(spread, 0.0) if is_cap else np.maximum(-spread, 0.0)
        w2 = self._w[:, None] * self._w[None, :]
        return self.df * float(np.sum(w2 * pay))

    def forwards(self):
        """Copula-grid expectations of each leg (diagnostic: must match
        the replication cms_rate to quadrature accuracy)."""
        u = _norm_cdf_np(self._z)
        e1 = float(np.sum(self._w * self._inverse_cdf(0, u)))
        e2 = float(np.sum(self._w * self._inverse_cdf(1, u)))
        return e1, e2

    def normal_approximation_value(self, strike: float,
                                   is_cap: bool = True) -> float:
        """Bachelier on the spread: convexity-adjusted forwards, normal-
        equivalent ATM vols, sigma_spread^2 = s1^2 + s2^2 - 2 rho s1 s2."""
        from .analytic import bachelier_formula

        t = self.legs[0].smile.expiry
        f = [leg.cms_rate() for leg in self.legs]
        # normal-equivalent ATM vol from the smile's ATM price
        s = []
        for leg in self.legs:
            atm = float(leg.smile.call(leg.smile.forward))
            s.append(atm / math.sqrt(t / (2.0 * math.pi)))
        var = s[0] ** 2 + s[1] ** 2 - 2.0 * self.rho * s[0] * s[1]
        spread_f = f[0] - f[1]
        if not is_cap:
            # floor via parity on the Bachelier value
            cap = bachelier_formula(spread_f, float(strike),
                                    math.sqrt(max(var, 1e-18)), t,
                                    payoff_unit=self.df)
            return cap - self.df * (spread_f - float(strike))
        return bachelier_formula(spread_f, float(strike),
                                 math.sqrt(max(var, 1e-18)), t,
                                 payoff_unit=self.df)
