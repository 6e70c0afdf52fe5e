"""Inflation: the Jarrow-Yildirim model, nominal and real Hull-White
economies with a lognormal CPI index, i.e. the cross-currency model
(``models/cross_currency.py``) with the real economy as "foreign" and the
CPI as the "FX rate".

Counterpart of ``finmath_tpu.models.inflation``: zero-coupon inflation
swaps, year-on-year swaps with their convexity correction, and
year-on-year caplets and floorlets, each with an exact analytic price and
an exact-in-distribution Monte-Carlo cross-check.

The analytic layer is host NumPy float64, the JAX module's arithmetic:
every payoff is exp-affine in the Gaussian state s = (x_n, Y_n, x_r, Y_r,
Z_I), so the exact first two moments of s are propagated across the grid,
s_{k+1} = A_k s_k + b_k + shock_k with the simulation's closed-form 5x5
step covariance, and E[e^{c0 + c1' s(T1) + c2' s(T2)}] and the
bivariate-lognormal call E[e^X (e^G - K)^+] are priced from (mean,
covariance). The Monte-Carlo side is ``CrossCurrencySimulation``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .analytic import _norm_cdf
from .cross_currency import (CrossCurrencyModel, CrossCurrencySimulation,
                             _int_b, _int_e, _step_cov5)
from .hull_white import HullWhiteModel
from .time_discretization import TimeDiscretization

# ln I = d + E' s and 1/N_n = exp(-A_n + F' s): the CPI and numeraire rows
_E = np.array([0.0, 1.0, 0.0, -1.0, 1.0])
_F = np.array([0.0, -1.0, 0.0, 0.0, 0.0])


class JarrowYildirimModel:
    """JY model: nominal and real Hull-White and a lognormal CPI.
    ``rho_nr``, ``rho_ni``, ``rho_ri`` correlate the nominal, real and CPI
    Brownians. The CPI drifts at the (nominal - real) short rate under the
    nominal risk-neutral measure; the real factor carries the -rho_ri
    sigma_r sigma_I quanto drift, both from the cross-currency
    construction."""

    def __init__(self, nominal: HullWhiteModel, real: HullWhiteModel,
                 cpi_initial: float, cpi_vol, rho_nr: float,
                 rho_ni: float, rho_ri: float, cpi_vol_times=None):
        self.xccy = CrossCurrencyModel(
            nominal, real, cpi_initial, cpi_vol, rho_df=rho_nr,
            rho_dx=rho_ni, rho_fx=rho_ri, fx_vol_times=cpi_vol_times)
        self.nominal = nominal
        self.real = real
        self.cpi0 = float(cpi_initial)

    # ------------------------------------------------------------------
    # moment propagation (the analytic engine)
    # ------------------------------------------------------------------
    def _moments(self, times: np.ndarray):
        """Exact joint Gaussian moments of s = (x_n, Y_n, x_r, Y_r, Z_I) on
        ``times`` (starting at 0): the mean mu[k] (only the real factor's
        quanto drift is nonzero), the covariance sig[k], and the one-step
        transitions A[k] for Cov(s(t_j), s(t_k)) = A_{j-1} ... A_k sig[k]."""
        m = self.xccy
        a_n, a_r = m.domestic.a, m.foreign.a
        times = np.asarray(times, dtype=np.float64)
        if times[0] != 0.0:
            raise ValueError("moment grid must start at 0")
        steps = times.size - 1
        mu = np.zeros((steps + 1, 5))
        sig = np.zeros((steps + 1, 5, 5))
        trans = np.zeros((steps, 5, 5))
        for k in range(steps):
            t, dt = times[k], times[k + 1] - times[k]
            s_n = m.domestic.sigma_at(t)
            s_r = m.foreign.sigma_at(t)
            s_i = m.fx_vol_at(t)
            q = _step_cov5(a_n, a_r, s_n, s_r, s_i, m.rho_df, m.rho_dx,
                           m.rho_fx, float(dt))
            a = np.eye(5)
            a[0, 0] = math.exp(-a_n * dt)
            a[1, 0] = _int_e(a_n, dt)
            a[2, 2] = math.exp(-a_r * dt)
            a[3, 2] = _int_e(a_r, dt)
            drift = m.rho_fx * s_r * s_i            # real quanto drift
            b = np.zeros(5)
            b[2] = -drift * _int_e(a_r, dt)
            b[3] = -drift * _int_b(a_r, dt)
            mu[k + 1] = a @ mu[k] + b
            sig[k + 1] = a @ sig[k] @ a.T + q
            trans[k] = a
        return mu, sig, trans

    def _cpi_coeffs(self, times: np.ndarray):
        """ln I(t) = d(t) + e' s(t) with e = (0, 1, 0, -1, 1); d collects
        ln I0 - A_r^int - 1/2 int sigma_I^2 + A_n^int (the simulation's
        deterministic decomposition)."""
        m = self.xccy
        v_n = np.array([m.domestic.gaussian_state(t)[2] for t in times])
        v_r = np.array([m.foreign.gaussian_state(t)[2] for t in times])
        a_int_n = -np.log(m.domestic.df(times)) + 0.5 * v_n
        a_int_r = -np.log(m.foreign.df(times)) + 0.5 * v_r
        dts = np.diff(times)
        si2 = np.array([m.fx_vol_at(t) ** 2 for t in times[:-1]])
        vx_int = np.concatenate([[0.0], np.cumsum(si2 * dts)])
        d = math.log(m.fx_spot) - a_int_r - vx_int * 0.5 + a_int_n
        return d, a_int_n

    @staticmethod
    def _pair_cov(sig, trans, j: int, k: int) -> np.ndarray:
        """Cov(s(t_j), s(t_k)) for j >= k."""
        phi = np.eye(5)
        for i in range(k, j):
            phi = trans[i] @ phi
        return phi @ sig[k]

    def _exp_affine(self, times, c1, c2, j1: int, j2: int):
        """(mean, variance) of c1' s(t_{j1}) + c2' s(t_{j2}), j2 >= j1,
        from the propagated moments."""
        mu, sig, trans = self._moments(times)
        c21 = self._pair_cov(sig, trans, j2, j1)        # Cov(s2, s1)
        mean = float(c1 @ mu[j1] + c2 @ mu[j2])
        var = float(c1 @ sig[j1] @ c1 + c2 @ sig[j2] @ c2
                    + 2.0 * c2 @ c21 @ c1)
        return mean, var

    # ------------------------------------------------------------------
    # products
    # ------------------------------------------------------------------
    def zcis_par_rate(self, maturity: float) -> float:
        """Zero-coupon inflation swap: fixed (1+K)^T - 1 against I(T)/I(0)
        - 1. The indexed leg's PV is P_r(0,T), so (1+K)^T = P_r(0,T) /
        P_n(0,T): curves only, no volatility."""
        if maturity <= 0:
            raise ValueError("maturity must be positive")
        ratio = float(self.real.df(maturity) / self.nominal.df(maturity))
        return ratio ** (1.0 / maturity) - 1.0

    def zcis_value(self, maturity: float, fixed_rate: float) -> float:
        """PV (receive inflation, pay fixed) per unit notional."""
        pn = float(self.nominal.df(maturity))
        pr = float(self.real.df(maturity))
        return (pr - pn) - pn * ((1.0 + fixed_rate) ** maturity - 1.0)

    def _grid_for(self, t1: float, t2: float) -> np.ndarray:
        bps = self.xccy._breakpoints()
        return np.unique(np.concatenate([[0.0, t1, t2],
                                         bps[(bps > 0) & (bps < t2)]]))

    def yoy_forward(self, t1: float, t2: float) -> float:
        """E^{T2-forward}[I(t2)/I(t1)], the convexity-corrected YoY forward
        ratio E^Q[(I2/I1) / N(t2)] / P_n(0,t2), exactly from the
        propagated moments."""
        if not 0.0 <= t1 < t2:
            raise ValueError("need 0 <= t1 < t2")
        times = self._grid_for(t1, t2)
        j1 = int(np.searchsorted(times, t1))
        j2 = int(np.searchsorted(times, t2))
        d, a_int_n = self._cpi_coeffs(times)
        mean, var = self._exp_affine(times, -_E, _E + _F, j1, j2)
        const = d[j2] - d[j1] - a_int_n[j2]
        pn2 = float(self.nominal.df(t2))
        return math.exp(const + mean + 0.5 * var) / pn2

    def yoy_swaplet_value(self, t1: float, t2: float,
                          fixed_rate: float) -> float:
        """PV of one YoY period: receive I(t2)/I(t1) - 1, pay K, at t2."""
        pn2 = float(self.nominal.df(t2))
        return pn2 * (self.yoy_forward(t1, t2) - 1.0 - fixed_rate)

    def yoy_swap_par_rate(self, payment_times: Sequence[float]) -> float:
        """K making the YoY swap (annual ratio resets) worth zero."""
        pt = np.asarray(payment_times, dtype=np.float64)
        if pt.ndim != 1 or pt.size < 1 or pt[0] <= 0 \
                or np.any(np.diff(pt) <= 0):
            raise ValueError("payment_times must be positive, increasing")
        grid = np.concatenate([[0.0], pt])
        pn = self.nominal.df(pt)
        fwd = np.array([self.yoy_forward(grid[i], grid[i + 1])
                        for i in range(pt.size)])
        return float(np.sum(pn * (fwd - 1.0)) / np.sum(pn))

    def yoy_caplet(self, t1: float, t2: float, strike_rate: float,
                   is_caplet: bool = True) -> float:
        """Caplet on the YoY ratio, (I(t2)/I(t1) - 1 - k)^+ paid at t2:
        E[e^X (e^G - K)^+] with X = -ln N(t2) jointly Gaussian with G = ln
        ratio, by the bivariate-lognormal formula
          e^{mx + vx/2} [e^{mg + vg/2 + cxg} Phi(d1) - K Phi(d2)],
          d2 = (mg + cxg - ln K) / sg, d1 = d2 + sg."""
        if not 0.0 <= t1 < t2:
            raise ValueError("need 0 <= t1 < t2")
        k = 1.0 + strike_rate
        if k <= 0:
            raise ValueError("1 + strike_rate must be positive")
        times = self._grid_for(t1, t2)
        j1 = int(np.searchsorted(times, t1))
        j2 = int(np.searchsorted(times, t2))
        d, a_int_n = self._cpi_coeffs(times)
        mu, sig, trans = self._moments(times)
        e, f = _E, _F
        # G = const_g + (-e)'s1 + e's2 ; X = const_x + f's2
        c21 = self._pair_cov(sig, trans, j2, j1)
        mg = (d[j2] - d[j1]) + float(-e @ mu[j1] + e @ mu[j2])
        vg = float(e @ sig[j1] @ e + e @ sig[j2] @ e
                   - 2.0 * e @ c21 @ e)
        mx = -a_int_n[j2] + float(f @ mu[j2])
        vx = float(f @ sig[j2] @ f)
        cxg = float(f @ sig[j2] @ e - f @ c21 @ e)
        sg = math.sqrt(max(vg, 1e-30))
        d2 = (mg + cxg - math.log(k)) / sg
        d1 = d2 + sg
        lead = math.exp(mx + 0.5 * vx)
        fwd_term = math.exp(mg + 0.5 * vg + cxg)
        if is_caplet:
            return lead * (fwd_term * _norm_cdf(d1) - k * _norm_cdf(d2))
        return lead * (k * _norm_cdf(-d2) - fwd_term * _norm_cdf(-d1))


class JarrowYildirimSimulation:
    """Exact Monte Carlo on the JY model (the cross-currency simulation,
    the real economy as foreign and the CPI as the FX rate): CPI paths, the
    nominal numeraire, and the YoY and ZCIS pricers. ``device``,
    ``normals`` and ``mesh`` pass through to ``CrossCurrencySimulation``
    (under a mesh the pricers' means and errors are over every rank's
    paths)."""

    def __init__(self, model: JarrowYildirimModel,
                 time_discretization: TimeDiscretization,
                 num_paths: int = 200_000, seed: int = 271,
                 antithetic: bool = True,
                 mesh=None, path_axis: str = "paths", *, device=None,
                 normals=None):
        self.model = model
        self.sim = CrossCurrencySimulation(model.xccy,
                                           time_discretization,
                                           num_paths, seed=seed,
                                           antithetic=antithetic,
                                           mesh=mesh, path_axis=path_axis,
                                           device=device, normals=normals)

    def cpi(self, time: float):
        return self.sim.fx(time)

    def mc_zcis_value(self, maturity: float, fixed_rate: float) -> float:
        """Pathwise (I(T)/I0 - (1+K)^T) / N_n(T)."""
        i = self.sim.fx(maturity)
        n = self.sim.numeraire(maturity)
        growth = i.div(self.model.cpi0).sub((1.0 + fixed_rate) ** maturity)
        return growth.div(n).get_average()

    def mc_yoy_forward(self, t1: float, t2: float):
        """(estimate, stderr) of E^{T2}[I(t2)/I(t1)] by pathwise
        discounting, the cross-check of the moment propagation."""
        i1 = self.sim.fx(t1)
        i2 = self.sim.fx(t2)
        n2 = self.sim.numeraire(t2)
        pn2 = float(self.model.nominal.df(t2))
        x = i2.div(i1).div(n2)
        mean = x.get_average()
        se = x.get_standard_error()
        return mean / pn2, se / pn2

    def mc_yoy_caplet(self, t1: float, t2: float, strike_rate: float,
                      is_caplet: bool = True):
        """(estimate, stderr) of the YoY caplet by pathwise payoff."""
        ratio = self.sim.fx(t2).div(self.sim.fx(t1))
        k = 1.0 + strike_rate
        pay = ratio.sub(k).floor(0.0) if is_caplet \
            else ratio.bus(k).floor(0.0)
        x = pay.div(self.sim.numeraire(t2))
        return x.get_average(), x.get_standard_error()
