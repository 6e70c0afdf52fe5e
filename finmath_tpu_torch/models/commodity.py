"""Commodity: the Schwartz-Smith two-factor model — short-term
mean-reverting deviations plus a long-term Brownian equilibrium level,
with the closed-form futures curve and options on futures, exact
Monte-Carlo simulation, and calendar-spread options (Margrabe exact at
zero strike).

Counterpart of ``finmath_tpu.models.commodity`` (Schwartz-Smith,
Management Science 2000). Under the risk-neutral measure:

  ln S(t) = chi(t) + xi(t)
  d chi = (-kappa chi - lambda_chi) dt + sigma_chi dW_chi
  d xi  = mu_star dt + sigma_xi dW_xi,      corr(W_chi, W_xi) = rho

Both factors are Gaussian, so:

* Futures: F(0,T) = E[S(T)] = exp(e^{-kT} chi0 + xi0 + A(T)) with the
  closed-form A(T) (risk-neutral drift + half total variance).
* Option on F(.,T) expiring at t: ln F(t,T) is Gaussian with the
  closed-form variance v^2(t,T) — Black-76.
* Calendar spread F(t,T1) - F(t,T2): two jointly lognormal legs with
  closed-form covariance — Margrabe EXACT at zero strike, MC for
  struck spreads.

The model's analytic layer is host NumPy float64, the JAX module's
arithmetic unchanged. The simulation is a float32 loop over the steps on
``[paths]`` tensors with the EXACT joint per-step Gaussian transition of
(chi, xi) (a host-precomputed 2x2 Cholesky per step, as in
``hull_white.py`` and ``cross_currency.py``); the pricers are float64
means and standard errors packed into one host copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from ..parallel.mesh import (check_mesh, mesh_device, path_block,
                             path_mean_and_stderr)
from ._draws import draws
from .analytic import _norm_cdf
from .time_discretization import TimeDiscretization


class SchwartzSmithModel:
    """Parameters: chi0/xi0 initial factors, kappa > 0 mean reversion,
    sigma_chi/sigma_xi > 0, rho in (-1, 1), mu_star the risk-neutral
    equilibrium drift, lambda_chi the short-term risk premium (enters
    the risk-neutral chi drift)."""

    def __init__(self, chi0: float, xi0: float, kappa: float,
                 sigma_chi: float, sigma_xi: float, rho: float,
                 mu_star: float = 0.0, lambda_chi: float = 0.0):
        if kappa <= 0 or sigma_chi <= 0 or sigma_xi <= 0:
            raise ValueError("kappa and volatilities must be positive")
        if not -1.0 < rho < 1.0:
            raise ValueError("rho must be in (-1, 1)")
        self.chi0 = float(chi0)
        self.xi0 = float(xi0)
        self.kappa = float(kappa)
        self.s_chi = float(sigma_chi)
        self.s_xi = float(sigma_xi)
        self.rho = float(rho)
        self.mu_star = float(mu_star)
        self.lam = float(lambda_chi)

    # ------------------------------------------------------------------
    def _a(self, tau) -> np.ndarray:
        """A(tau): risk-neutral drift of ln S plus half its variance."""
        tau = np.asarray(tau, dtype=np.float64)
        k = self.kappa
        e = np.exp(-k * tau)
        var = (self.s_chi ** 2 * (1.0 - e * e) / (2.0 * k)
               + self.s_xi ** 2 * tau
               + 2.0 * self.rho * self.s_chi * self.s_xi
               * (1.0 - e) / k)
        return (self.mu_star * tau - self.lam * (1.0 - e) / k
                + 0.5 * var)

    def futures_price(self, maturity) -> np.ndarray:
        """F(0, T) = E^Q[S(T)] (commodity futures carry no discounting
        in the martingale identity: the futures price IS the
        expectation)."""
        tau = np.asarray(maturity, dtype=np.float64)
        return np.exp(np.exp(-self.kappa * tau) * self.chi0 + self.xi0
                      + self._a(tau))

    def log_futures_covariance(self, t: float, mat1: float,
                               mat2: float) -> float:
        """Cov[ln F(t, T1), ln F(t, T2)] — ln F(t,T) = e^{-k(T-t)}
        chi(t) + xi(t) + A(T-t), so everything follows from the factor
        covariances at t."""
        if t < 0 or mat1 < t or mat2 < t:
            raise ValueError("need 0 <= t <= maturities")
        k = self.kappa
        v_chi = self.s_chi ** 2 * (1.0 - math.exp(-2 * k * t)) / (2 * k)
        v_xi = self.s_xi ** 2 * t
        c = self.rho * self.s_chi * self.s_xi \
            * (1.0 - math.exp(-k * t)) / k
        b1 = math.exp(-k * (mat1 - t))
        b2 = math.exp(-k * (mat2 - t))
        return b1 * b2 * v_chi + v_xi + (b1 + b2) * c

    def log_futures_variance(self, t: float, maturity: float) -> float:
        return self.log_futures_covariance(t, maturity, maturity)

    def option_on_future(self, expiry: float, maturity: float,
                         strike: float, discount_factor: float = 1.0,
                         is_call: bool = True) -> float:
        """European option expiring at ``expiry`` on F(expiry,
        ``maturity``): Black-76 with the closed-form v^2 (F(t,T) is a
        Q-martingale, lognormal)."""
        if not 0.0 < expiry <= maturity:
            raise ValueError("need 0 < expiry <= maturity")
        f = float(self.futures_price(maturity))
        v2 = self.log_futures_variance(expiry, maturity)
        sp = math.sqrt(max(v2, 0.0))
        if sp < 1e-14:
            intrinsic = (f - strike) if is_call else (strike - f)
            return discount_factor * max(intrinsic, 0.0)
        d1 = (math.log(f / strike) + 0.5 * v2) / sp
        d2 = d1 - sp
        if is_call:
            return discount_factor * (f * _norm_cdf(d1)
                                      - strike * _norm_cdf(d2))
        return discount_factor * (strike * _norm_cdf(-d2)
                                  - f * _norm_cdf(-d1))

    def calendar_spread_margrabe(self, expiry: float, mat1: float,
                                 mat2: float,
                                 discount_factor: float = 1.0) -> float:
        """(F(t,T1) - F(t,T2))^+ at zero strike: Margrabe EXACT (both
        legs jointly lognormal with closed-form covariance)."""
        f1 = float(self.futures_price(mat1))
        f2 = float(self.futures_price(mat2))
        v = (self.log_futures_variance(expiry, mat1)
             + self.log_futures_variance(expiry, mat2)
             - 2.0 * self.log_futures_covariance(expiry, mat1, mat2))
        sp = math.sqrt(max(v, 1e-30))
        d1 = (math.log(f1 / f2) + 0.5 * v) / sp
        return discount_factor * (f1 * _norm_cdf(d1)
                                  - f2 * _norm_cdf(d1 - sp))


# ---------------------------------------------------------------------------
# exact simulation
# ---------------------------------------------------------------------------

def _ss_scan(z1, z2, e_k, l11, l21, l22):
    """Exact per-step transition of the MEAN-ZERO factors:
    chi' = chi e^{-k dt} + l11 Z1; xi' = xi + l21 Z1 + l22 Z2 (the
    deterministic means are exact host float64, added in the pricers).
    ``z1``, ``z2`` [steps, paths] float32 (mirrored); the coefficients
    float64 NumPy [steps], rounded to float32 as the JAX step casts them.
    Histories [steps+1, paths] float32."""
    chi = xi = torch.zeros_like(z1[0])
    chis, xis = [chi], [xi]
    coef = np.stack([e_k, l11, l21, l22]).astype(np.float32)
    for s in range(z1.shape[0]):
        ek, a, b, c = (float(v) for v in coef[:, s])
        chi = chi * ek + a * z1[s]
        xi = xi + b * z1[s] + c * z2[s]
        chis.append(chi)
        xis.append(xi)
    return torch.stack(chis), torch.stack(xis)


def _ss_futures_core(chi, xi, decay, a_tau, chi_mean: float,
                     xi_mean: float, mesh=None) -> torch.Tensor:
    """Packed [2K] (means, stderrs) of F(t, T_k) = exp(decay_k chi(t)
    + xi(t) + A(tau_k) + deterministic means). The cores take ``mesh``:
    the paths are then this rank's block and the two moments of each
    price one all-reduce (``parallel.mesh.path_mean_and_stderr``)."""
    lnf = (decay[:, None] * (chi.to(ACC_DTYPE) + chi_mean)
           + (xi.to(ACC_DTYPE) + xi_mean) + a_tau[:, None])
    m, se = path_mean_and_stderr(torch.exp(lnf), mesh)
    return torch.cat([m, se])


def _ss_option_core(chi, xi, decay: float, a_tau: float, chi_mean: float,
                    xi_mean: float, strikes, signs, df: float,
                    mesh=None) -> torch.Tensor:
    """Packed [2K]: option prices + stderrs on ONE future F(t, T) for a
    strike vector (decay/a_tau scalars here)."""
    f = torch.exp(decay * (chi.to(ACC_DTYPE) + chi_mean)
                  + (xi.to(ACC_DTYPE) + xi_mean) + a_tau)
    pay = df * torch.clamp_min(signs[:, None] * (f[None, :]
                                                 - strikes[:, None]), 0.0)
    m, se = path_mean_and_stderr(pay, mesh)
    return torch.cat([m, se])


def _ss_spread_core(chi, xi, d1: float, d2: float, a1: float, a2: float,
                    chi_mean: float, xi_mean: float, strike: float,
                    df: float, mesh=None) -> torch.Tensor:
    """Packed [2]: calendar-spread option (F1 - F2 - K)^+ mean + se."""
    c = chi.to(ACC_DTYPE) + chi_mean
    x = xi.to(ACC_DTYPE) + xi_mean
    f1 = torch.exp(d1 * c + x + a1)
    f2 = torch.exp(d2 * c + x + a2)
    pay = df * torch.clamp_min(f1 - f2 - strike, 0.0)
    m, se = path_mean_and_stderr(pay, mesh)
    return torch.stack([m, se])


class SchwartzSmithSimulation:
    """Exact MC of (chi, xi) on a grid. The factor paths are simulated
    MEAN-ZERO in float32 (the deterministic means — mean reversion of
    chi0, risk premia, mu_star drift — are exact host float64 added
    inside the pricers), the standard drift/path split of the framework.

    The normals: two ``[steps, half]`` float32 blocks (``half =
    num_paths / 2`` when antithetic), the caller's ``normals=(z1, z2)``
    (the JAX scan's draws) or drawn from
    ``torch.Generator(device).manual_seed(seed)``, mirrored ``[z, -z]``
    along the path axis. ``device`` defaults to ``select_device()``.

    ``mesh``: a ``parallel.PathMesh``. Every rank draws (or is given) the
    global blocks above, the unmeshed stream, mirrored before they are
    split, and keeps its block of the paths (``num_paths`` divisible by
    the world size); the histories are the block's, ``spot`` carries the
    mesh, and the pricers' moments are all-reduced. Every rank returns the
    same prices."""

    def __init__(self, model: SchwartzSmithModel,
                 time_discretization: TimeDiscretization,
                 num_paths: int = 200_000, seed: int = 1729,
                 antithetic: bool = True,
                 mesh=None, path_axis: str = "paths", *, device=None,
                 normals=None):
        if antithetic and num_paths % 2:
            raise ValueError("antithetic needs an even num_paths")
        self.mesh = check_mesh(mesh)
        self.path_axis = path_axis
        if self.mesh is not None:
            self.mesh.local_count(num_paths)
        self.model = model
        self.td = time_discretization
        self.num_paths = int(num_paths)
        self.antithetic = bool(antithetic)
        self.device = mesh_device(self.mesh, device)
        times = time_discretization.as_array()
        if times[0] != 0.0:
            raise ValueError("simulation grid must start at 0")
        self._times = times
        dts = np.diff(times)
        k = model.kappa
        ek = np.exp(-k * dts)
        v_chi = model.s_chi ** 2 * (1.0 - ek * ek) / (2 * k)
        v_xi = model.s_xi ** 2 * dts
        c = model.rho * model.s_chi * model.s_xi * (1.0 - ek) / k
        l11 = np.sqrt(v_chi)
        l21 = c / np.maximum(l11, 1e-300)
        l22 = np.sqrt(np.maximum(v_xi - l21 * l21, 0.0))
        half = self.num_paths // 2 if self.antithetic else self.num_paths
        z1, z2 = draws(normals, ("normal", "normal"), (dts.size, half),
                       self.antithetic, seed, self.device,
                       ("normals z1", "normals z2"))
        self._chis, self._xis = _ss_scan(path_block(z1, self.mesh),
                                         path_block(z2, self.mesh), ek, l11,
                                         l21, l22)
        # exact deterministic means at the grid points
        e_t = np.exp(-k * times)
        self._chi_mean = (model.chi0 * e_t
                          - model.lam * (1.0 - e_t) / k)
        self._xi_mean = model.xi0 + model.mu_star * times

    def _index(self, time: float) -> int:
        ti = self.td.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return ti

    def _f64(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=ACC_DTYPE).to(self.device)

    def spot(self, time: float) -> RandomVariableTorch:
        """S(t) = exp(chi + xi) with the exact means."""
        i = self._index(time)
        return RandomVariableTorch.of(
            self._times[i],
            torch.exp(self._chis[i].to(ACC_DTYPE) + self._chi_mean[i]
                      + self._xis[i].to(ACC_DTYPE)
                      + self._xi_mean[i]).to(FLOAT_DTYPE), mesh=self.mesh)

    def _fut_consts(self, i: int, maturities):
        t = self._times[i]
        mats = np.atleast_1d(np.asarray(maturities, dtype=np.float64))
        if np.any(mats < t):
            raise ValueError("maturity before observation time")
        m = self.model
        decay = np.exp(-m.kappa * (mats - t))
        # ln F(t,T) = decay chi(t) + xi(t) + A(T - t) evaluated with the
        # RISK-NEUTRAL A measured from t: the same _a but applied to the
        # time-t factors (A depends only on tau by stationarity of the
        # RN dynamics)
        a_tau = m._a(mats - t)
        return decay, a_tau

    def mc_futures_prices(self, time: float, maturities):
        """(prices[K], stderr[K]) of E[F(time, T_k)] — by the
        martingale property this must equal F(0, T_k); one host copy."""
        i = self._index(time)
        decay, a_tau = self._fut_consts(i, maturities)
        out = _ss_futures_core(
            self._chis[i], self._xis[i], self._f64(decay), self._f64(a_tau),
            float(self._chi_mean[i]), float(self._xi_mean[i]),
            self.mesh).cpu().numpy()
        kk = decay.size
        return out[:kk], out[kk:]

    def mc_option_on_future(self, expiry: float, maturity: float,
                            strikes, discount_factor: float = 1.0,
                            is_call: bool = True):
        """(prices[K], stderr[K]) of the option on F(expiry, maturity)
        for a strike vector; oracle: ``option_on_future``."""
        i = self._index(expiry)
        decay, a_tau = self._fut_consts(i, maturity)
        ks = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
        sign = 1.0 if is_call else -1.0
        out = _ss_option_core(
            self._chis[i], self._xis[i], float(decay[0]), float(a_tau[0]),
            float(self._chi_mean[i]), float(self._xi_mean[i]),
            self._f64(ks), self._f64(np.full(ks.shape, sign)),
            float(discount_factor), self.mesh).cpu().numpy()
        kk = ks.size
        return out[:kk], out[kk:]

    def mc_calendar_spread(self, expiry: float, mat1: float, mat2: float,
                           strike: float = 0.0,
                           discount_factor: float = 1.0):
        """(price, stderr) of (F(t,T1) - F(t,T2) - K)^+; at K=0 the
        Margrabe closed form is the oracle."""
        i = self._index(expiry)
        decay, a_tau = self._fut_consts(i, [mat1, mat2])
        out = _ss_spread_core(
            self._chis[i], self._xis[i], float(decay[0]), float(decay[1]),
            float(a_tau[0]), float(a_tau[1]), float(self._chi_mean[i]),
            float(self._xi_mean[i]), float(strike),
            float(discount_factor), self.mesh).cpu().numpy()
        return float(out[0]), float(out[1])
