"""Hull-White one-factor short-rate model: exact Gaussian simulation of
(x(t), integral of x), analytic bond, caplet and swaption (Jamshidian)
pricers, and piecewise-volatility calibration.

Counterpart of ``finmath_tpu.models.hull_white`` (finmath-lib's
``HullWhiteModel``: dr = (theta(t) - a r) dt + sigma(t) dW fitted to the
initial discount curve, with piecewise-constant volatility and the
integrated short rate simulated jointly with the rate).

Brigo-Mercurio decomposition r(t) = x(t) + alpha(t), dx = -a x dt +
sigma(t) dW, with three deterministic state functions propagated exactly
per volatility segment by the recursion the simulation uses per step:

  phi(t) = Var x(t),  C(t) = Cov(x(t), Y(t)),  V(t) = Var Y(t),
  Y(t) = integral_0^t x(s) ds,

from which alpha(t) = f(0,t) + C(t), the pathwise numeraire N(t) =
exp(Y(t) + A(t)) with A(t) = -ln P(0,t) + V(t)/2, and the bond
P(t,T) = (P(0,T)/P(0,t)) exp(-B x(t) - B^2 phi(t)/2 - B C(t)),
B = (1 - e^{-a(T-t)})/a.

The analytic layer (bond options, Jamshidian swaptions, calibration) is
host NumPy float64, the same arithmetic as the JAX module. The
simulation is a float32 step loop over ``[paths]`` tensors on the device
with the exact joint transition of (x, Y): two normals per step,
correlated by the closed-form step covariance, whose coefficients are
formed in float64 and rounded to float32. Prices are float64 means.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from ..parallel.mesh import check_mesh, mesh_device, path_block, path_mean
from .analytic import _norm_cdf
from .curves import DiscountCurve
from .time_discretization import TimeDiscretization


def _b(a: float, tau):
    """B(tau) = (1 - e^{-a tau}) / a."""
    return (1.0 - np.exp(-a * np.asarray(tau, dtype=np.float64))) / a


def _step_cov(a: float, sigma: float, dt: float):
    """Exact conditional covariance of (x(t+dt), int_t^{t+dt} x ds)
    given x(t), for constant sigma over the step:

      Var eps = s^2 (1 - e^{-2a dt}) / (2a)
      Var eta = s^2/a^2 (dt - 2 B(dt) + (1-e^{-2a dt})/(2a))
      Cov     = s^2/a   (B(dt) - (1-e^{-2a dt})/(2a))
    """
    e2 = math.expm1(-2.0 * a * dt)  # e^{-2a dt} - 1
    g = -e2 / (2.0 * a)             # (1 - e^{-2a dt}) / (2a)
    bb = float(_b(a, dt))
    s2 = sigma * sigma
    vx = s2 * g
    vy = s2 / (a * a) * (dt - 2.0 * bb + g)
    cxy = s2 / a * (bb - g)
    return vx, vy, cxy


class HullWhiteModel:
    """Hull-White model: constant mean reversion ``a``, piecewise-constant
    volatility ``sigmas[i]`` on [vol_times[i], vol_times[i+1]) (the last
    value extends to infinity; pass a scalar for a flat vol), fitted to
    ``discount_curve`` by construction."""

    def __init__(self, discount_curve: DiscountCurve, mean_reversion: float,
                 volatility, vol_times: Optional[Sequence[float]] = None):
        if mean_reversion <= 1e-8:
            raise ValueError("mean_reversion must be positive (>= 1e-8); "
                             "the a -> 0 limit is not implemented")
        self.curve = discount_curve
        self.a = float(mean_reversion)
        sig = np.atleast_1d(np.asarray(volatility, dtype=np.float64))
        if np.any(sig <= 0):
            raise ValueError("volatility must be positive")
        if vol_times is None:
            if sig.size != 1:
                raise ValueError("vol_times required for piecewise vol")
            vol_times = [0.0]
        vt = np.asarray(vol_times, dtype=np.float64)
        if vt.size != sig.size or vt[0] != 0.0 or np.any(np.diff(vt) <= 0):
            raise ValueError("vol_times must start at 0, increase, and "
                             "align with volatility")
        self.vol_times = vt
        self.sigmas = sig

    # ------------------------------------------------------------------
    def sigma_at(self, t: float) -> float:
        """Volatility on the segment containing t (right-continuous)."""
        i = int(np.searchsorted(self.vol_times, t, side="right") - 1)
        return float(self.sigmas[max(i, 0)])

    def gaussian_state(self, t: float):
        """(phi, C, V) = (Var x(t), Cov(x,Y)(t), Var Y(t)) by exact
        propagation across the volatility segments up to ``t``."""
        a = self.a
        phi = c = v = 0.0
        s = 0.0
        for i in range(self.vol_times.size):
            seg_end = (self.vol_times[i + 1]
                       if i + 1 < self.vol_times.size else np.inf)
            dt = min(t, seg_end) - s
            if dt <= 0:
                break
            vx, vy, cxy = _step_cov(a, float(self.sigmas[i]), float(dt))
            ea = math.exp(-a * dt)
            bb = float(_b(a, dt))
            v = v + bb * bb * phi + 2.0 * bb * c + vy
            c = ea * (c + bb * phi) + cxy
            phi = phi * ea * ea + vx
            s += dt
        return phi, c, v

    def df(self, t) -> np.ndarray:
        return np.asarray(self.curve.get_discount_factor(t),
                          dtype=np.float64)

    # ------------------------------------------------------------------
    # analytic pricing (host float64): the oracle layer
    # ------------------------------------------------------------------
    def bond_option(self, expiry: float, bond_maturity: float,
                    strike: float, is_call: bool = True) -> float:
        """Option on the zero bond P(expiry, bond_maturity): lognormal
        with total variance B(T_B - T_O)^2 phi(T_O) under the
        T_O-forward measure, Black-76 on the forward bond."""
        if not 0.0 < expiry < bond_maturity:
            raise ValueError("need 0 < expiry < bond_maturity")
        phi, _, _ = self.gaussian_state(expiry)
        sp = abs(float(_b(self.a, bond_maturity - expiry))) * math.sqrt(phi)
        f = float(self.df(bond_maturity) / self.df(expiry))
        df_o = float(self.df(expiry))
        if sp < 1e-14:
            intrinsic = (f - strike) if is_call else (strike - f)
            return df_o * max(intrinsic, 0.0)
        d1 = (math.log(f / strike) + 0.5 * sp * sp) / sp
        d2 = d1 - sp
        if is_call:
            return df_o * (f * _norm_cdf(d1) - strike * _norm_cdf(d2))
        return df_o * (strike * _norm_cdf(-d2) - f * _norm_cdf(-d1))

    def caplet(self, fixing: float, payment: float, strike: float) -> float:
        """Caplet on the simple forward L(fixing, payment), paid at
        ``payment``: caplet = (1 + delta K) ZBP(fixing, payment,
        1/(1 + delta K))."""
        delta = payment - fixing
        k_bond = 1.0 / (1.0 + delta * strike)
        return (1.0 + delta * strike) * self.bond_option(
            fixing, payment, k_bond, is_call=False)

    def _bond_at_x(self, t: float, maturity, x):
        """Reconstitution P(t, T; x) for scalar t, vectorized over T/x."""
        phi, c, _ = self.gaussian_state(t)
        bb = _b(self.a, np.asarray(maturity) - t)
        return (self.df(maturity) / self.df(t)
                * np.exp(-bb * x - 0.5 * bb * bb * phi - bb * c))

    def swaption(self, expiry: float, payment_times: Sequence[float],
                 strike: float, payer: bool = True,
                 notional: float = 1.0) -> float:
        """European swaption by the Jamshidian decomposition: the x* at
        which the coupon bond prices at par (bisection), then zero-bond
        options struck at the critical bond prices. Payment times are the
        fixed-leg dates after ``expiry``; accruals from their spacing."""
        pt = np.asarray(payment_times, dtype=np.float64)
        if pt.ndim != 1 or pt.size < 1 or pt[0] <= expiry:
            raise ValueError("payment_times must follow the expiry")
        if np.any(np.diff(pt) <= 0):
            raise ValueError("payment_times must increase")
        deltas = np.diff(np.concatenate([[expiry], pt]))
        coupons = strike * deltas
        coupons[-1] += 1.0
        # bisection on g(x) = sum c_i P(T0, t_i; x) - 1, decreasing in x
        lo, hi = -5.0, 5.0
        phi, _, _ = self.gaussian_state(expiry)
        scale = math.sqrt(max(phi, 1e-30))
        lo, hi = lo * max(scale, 1e-2) * 50, hi * max(scale, 1e-2) * 50
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            g = float(np.sum(coupons * self._bond_at_x(expiry, pt, mid))) - 1.0
            if g > 0:
                lo = mid
            else:
                hi = mid
            if hi - lo < 1e-14 * max(1.0, abs(mid)):
                break
        x_star = 0.5 * (lo + hi)
        k_bonds = self._bond_at_x(expiry, pt, x_star)
        total = 0.0
        for ti, ci, ki in zip(pt, coupons, k_bonds):
            total += ci * self.bond_option(expiry, float(ti), float(ki),
                                           is_call=not payer)
        return notional * total

    # ------------------------------------------------------------------
    def forward_rate(self, t: float, eps: float = 1e-5) -> float:
        """Instantaneous forward f(0,t) by central difference of
        -ln P(0, .) (used only for short-rate reporting and the PDE)."""
        lo = max(t - eps, 0.0)
        return float((np.log(self.df(lo)) - np.log(self.df(t + eps)))
                     / (t + eps - lo))


# ---------------------------------------------------------------------------
# exact Monte-Carlo simulation
# ---------------------------------------------------------------------------

def _hw_paths(z1: torch.Tensor, z2: torch.Tensor, coef: torch.Tensor):
    """The exact joint transition, step by step in float32: per step
    ``Y' = Y + x B(dt) + lyx Z1 + ly Z2`` (from the old x), then ``x' = x
    e^{-a dt} + lx Z1``. ``z1``, ``z2``: ``[steps, paths]`` float32;
    ``coef``: ``[5, steps]`` float32 rows (e^{-a dt}, B(dt), lx, lyx, ly).
    Returns the histories ``[steps + 1, paths]`` of x and Y."""
    steps, paths = z1.shape
    xs = torch.zeros((steps + 1, paths), dtype=FLOAT_DTYPE, device=z1.device)
    ys = torch.zeros_like(xs)
    x, y = xs[0], ys[0]
    for s in range(steps):
        ea, bd, sx, syx, sy = coef[:, s]
        y = y + x * bd + syx * z1[s] + sy * z2[s]
        x = x * ea + sx * z1[s]
        xs[s + 1], ys[s + 1] = x, y
    return xs, ys


def _normal_block(gen, shape, antithetic: bool, device) -> torch.Tensor:
    """Standard float32 normals ``shape`` (last axis: paths), drawn as half
    the paths and mirrored ``[z, -z]`` along the last axis when
    antithetic."""
    if not antithetic:
        return torch.randn(shape, generator=gen, dtype=FLOAT_DTYPE,
                           device=device)
    z = torch.randn((*shape[:-1], shape[-1] // 2), generator=gen,
                    dtype=FLOAT_DTYPE, device=device)
    return torch.cat([z, -z], dim=-1)


def _f64(values, device) -> torch.Tensor:
    """Host values as a float64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(values, dtype=np.float64),
                           device=device)


def _injected(z, shape, device, what: str,
              dtype=FLOAT_DTYPE) -> torch.Tensor:
    """A caller's block as ``dtype`` on ``device``, checked to be
    ``shape``."""
    z = torch.as_tensor(z, dtype=dtype).to(device)
    if tuple(z.shape) != tuple(shape):
        raise ValueError(f"{what} of shape {tuple(z.shape)}; need "
                         f"{list(shape)}")
    return z


class HullWhiteSimulation:
    """Exact Monte-Carlo simulation of the Hull-White model on a time
    grid: pathwise short rate, zero bonds (affine reconstitution) and the
    exact bank-account numeraire, as ``RandomVariableTorch``.

    The normals: two ``[steps, num_paths / 2]`` float32 blocks per run from
    ``torch.Generator(device).manual_seed(seed)`` (``num_paths`` of them
    without ``antithetic``), mirrored ``[z, -z]`` along the path axis when
    antithetic; or the caller's ``normals=(z1, z2)``, two ``[steps,
    num_paths]`` blocks used as given (the JAX stream can be fed in).
    ``device`` defaults to ``select_device()``.

    ``mesh``: a ``parallel.PathMesh``. Every rank draws (or is given) the
    global blocks above, the unmeshed stream, and keeps its block of the
    paths (``num_paths`` divisible by the world size); the histories are
    the block's, the variables it returns carry the mesh (global
    reductions), and the Monte-Carlo prices, the TARN and the Bermudan
    reduce over the ranks. Every rank returns the same prices."""

    def __init__(self, model: HullWhiteModel,
                 time_discretization: TimeDiscretization, num_paths: int,
                 seed: int = 3141, antithetic: bool = False,
                 mesh=None, path_axis: str = "paths", *, device=None,
                 normals=None):
        self.mesh = check_mesh(mesh)
        self.path_axis = path_axis
        if antithetic and num_paths % 2:
            raise ValueError("antithetic needs an even num_paths")
        if self.mesh is not None:
            self.mesh.local_count(num_paths)
        self.model = model
        self.td = time_discretization
        self.num_paths = int(num_paths)
        self.seed = int(seed)
        self.antithetic = bool(antithetic)
        self.device = mesh_device(self.mesh, device)
        a = model.a
        times = time_discretization.as_array()
        if times[0] != 0.0:
            raise ValueError("simulation grid must start at 0")
        dts = np.diff(times)
        # a volatility step must not straddle a breakpoint
        for bt in model.vol_times[1:]:
            if bt < times[-1] and time_discretization.get_time_index(bt) < 0:
                raise ValueError(
                    f"volatility breakpoint {bt} not on the time grid")
        sig = np.array([model.sigma_at(t) for t in times[:-1]])
        cov = np.array([_step_cov(a, s, dt) for s, dt in zip(sig, dts)])
        vx, vy, cxy = cov[:, 0], cov[:, 1], cov[:, 2]
        lx = np.sqrt(vx)
        lyx = cxy / np.maximum(lx, 1e-300)
        ly = np.sqrt(np.maximum(vy - lyx * lyx, 0.0))
        coef = torch.as_tensor(
            np.stack([np.exp(-a * dts), _b(a, dts), lx, lyx, ly]).astype(
                np.float32), device=self.device)
        shape, dev = (dts.size, self.num_paths), self.device
        if normals is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            z1, z2 = (_normal_block(gen, shape, self.antithetic, dev)
                      for _ in range(2))
        else:
            z1, z2 = (_injected(z, shape, dev, f"normals z{i}")
                      for i, z in enumerate(normals, 1))
        self._xs, self._ys = _hw_paths(path_block(z1, self.mesh),
                                       path_block(z2, self.mesh), coef)
        # deterministic state at the grid points (host float64)
        st = np.array([model.gaussian_state(t) for t in times])
        self._phi, self._c, self._v = st[:, 0], st[:, 1], st[:, 2]
        self._lnp0 = np.log(model.df(times))
        self._a_int = -self._lnp0 + 0.5 * self._v       # A(t) = int alpha
        self._times = times

    # ------------------------------------------------------------------
    def _index(self, time: float) -> int:
        ti = self.td.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return ti

    def short_rate(self, time: float) -> RandomVariableTorch:
        """r(t) = x(t) + alpha(t), alpha(t) = f(0,t) + C(t)."""
        i = self._index(time)
        alpha = self.model.forward_rate(self._times[i]) + self._c[i]
        return RandomVariableTorch.of(
            self._times[i], self._xs[i] + torch.tensor(
                alpha, dtype=FLOAT_DTYPE, device=self.device), mesh=self.mesh)

    def numeraire(self, time: float) -> RandomVariableTorch:
        """N(t) = exp(Y(t) + A(t)), exact in distribution."""
        i = self._index(time)
        return RandomVariableTorch.of(
            self._times[i], torch.exp(self._ys[i].to(ACC_DTYPE)
                                      + float(self._a_int[i])).to(FLOAT_DTYPE),
            mesh=self.mesh)

    def bond(self, time: float, maturity: float) -> RandomVariableTorch:
        """P(t, T) by the affine reconstitution in x(t)."""
        i = self._index(time)
        t = self._times[i]
        if maturity < t:
            raise ValueError("maturity before observation time")
        bb = float(_b(self.model.a, maturity - t))
        lead = float(self.model.df(maturity) / self.model.df(t)
                     * math.exp(-0.5 * bb * bb * self._phi[i]
                                - bb * self._c[i]))
        return RandomVariableTorch.of(
            t, (lead * torch.exp(-bb * self._xs[i].to(ACC_DTYPE)))
            .to(FLOAT_DTYPE), mesh=self.mesh)

    def get_number_of_paths(self) -> int:
        return self.num_paths

    # ------------------------------------------------------------------
    # Monte-Carlo prices (one float64 mean each, over every rank's paths)
    # ------------------------------------------------------------------
    def _bond_coeffs(self, i: int, maturities) -> tuple:
        """(lead, B) of P(t_i, T) = lead * exp(-B x) for each T."""
        t = self._times[i]
        mats = np.atleast_1d(np.asarray(maturities, dtype=np.float64))
        if np.any(mats < t):
            raise ValueError("maturity before observation time")
        bb = _b(self.model.a, mats - t)
        lead = (self.model.df(mats) / self.model.df(t)
                * np.exp(-0.5 * bb * bb * self._phi[i] - bb * self._c[i]))
        return lead, bb

    def _inv_numeraire(self, i: int) -> torch.Tensor:
        return torch.exp(-self._ys[i].to(ACC_DTYPE) - float(self._a_int[i]))

    def _f64(self, values) -> torch.Tensor:
        return _f64(values, self.device)

    def mc_bond_price(self, maturity: float) -> float:
        """E[1/N(T)]: reproduces the input curve (martingale)."""
        return float(path_mean(self._inv_numeraire(self._index(maturity)),
                               self.mesh))

    def mc_caplet_price(self, fixing: float, payment: float,
                        strike: float) -> float:
        """delta * (L(T) - K)+ paid at ``payment``, discounted by the
        exact pathwise numeraire."""
        i = self._index(fixing)
        delta = payment - fixing
        lead, bb = self._bond_coeffs(i, payment)
        p_ts = float(lead[0]) * torch.exp(-float(bb[0])
                                          * self._xs[i].to(ACC_DTYPE))
        libor = (1.0 / p_ts - 1.0) / delta
        return float(path_mean(delta * torch.clamp_min(libor - strike, 0.0)
                               * p_ts * self._inv_numeraire(i), self.mesh))

    def mc_swaption_price(self, expiry: float,
                          payment_times: Sequence[float], strike: float,
                          payer: bool = True) -> float:
        """max(s (1 - coupon bond at expiry), 0) / N(expiry), the coupon
        stack one ``[K, paths]`` broadcast."""
        i = self._index(expiry)
        pt = np.asarray(payment_times, dtype=np.float64)
        deltas = np.diff(np.concatenate([[expiry], pt]))
        coupons = strike * deltas
        coupons[-1] += 1.0
        leads, bbs = self._bond_coeffs(i, pt)
        xa = self._xs[i].to(ACC_DTYPE)
        cb = torch.sum(self._f64(coupons * leads)[:, None]
                       * torch.exp(-self._f64(bbs)[:, None] * xa[None, :]),
                       dim=0)
        sign = 1.0 if payer else -1.0
        return float(path_mean(torch.clamp_min(sign * (1.0 - cb), 0.0)
                               * self._inv_numeraire(i), self.mesh))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HullWhiteCalibrationResult:
    model: HullWhiteModel
    rms_price_error: float
    iterations: int
    converged: bool


def calibrate_hull_white(discount_curve: DiscountCurve,
                         mean_reversion: float,
                         vol_times: Sequence[float],
                         swaptions: Sequence[dict],
                         target_prices: Sequence[float],
                         x0: Optional[Sequence[float]] = None,
                         max_iterations: int = 200,
                         accuracy: float = 1e-12) -> HullWhiteCalibrationResult:
    """Global fit of the piecewise volatility to European swaption prices
    by Levenberg-Marquardt on the Jamshidian pricer (host float64).
    ``swaptions`` entries: ``{"expiry": .., "payment_times": [..],
    "strike": .., "payer": ..}``. Volatilities are optimized in log."""
    from .calibration import LevenbergMarquardt

    vol_times = np.asarray(vol_times, dtype=np.float64)
    targets = np.asarray(target_prices, dtype=np.float64)
    if targets.size != len(swaptions):
        raise ValueError("target_prices must align with swaptions")

    def model_of(y: np.ndarray) -> HullWhiteModel:
        return HullWhiteModel(discount_curve, mean_reversion,
                              np.exp(np.clip(y, -30, 5)), vol_times)

    def residuals(y: np.ndarray) -> np.ndarray:
        m = model_of(y)
        return np.array([
            m.swaption(s["expiry"], s["payment_times"], s["strike"],
                       s.get("payer", True)) for s in swaptions]) - targets

    def jacobian(y: np.ndarray) -> np.ndarray:
        h = 1e-6
        cols = []
        for i in range(y.size):
            yp = y.copy()
            yp[i] += h
            ym = y.copy()
            ym[i] -= h
            cols.append((residuals(yp) - residuals(ym)) / (2 * h))
        return np.stack(cols, axis=1)

    start = np.log(np.full(vol_times.size, 0.01)
                   if x0 is None else np.asarray(x0, dtype=np.float64))
    lm = LevenbergMarquardt(residuals, jacobian,
                            max_iterations=max_iterations,
                            accuracy=accuracy,
                            lower_bound=-np.inf, upper_bound=np.inf)
    res = lm.run(start)
    m = model_of(res.parameters)
    rms = float(np.sqrt(np.mean(residuals(res.parameters) ** 2)))
    return HullWhiteCalibrationResult(model=m, rms_price_error=rms,
                                      iterations=res.iterations,
                                      converged=res.converged)
