"""Finite-difference (PDE) pricing layer: the batched theta scheme.

Counterpart of ``finmath_tpu.models.pde``, the analog of finmath-lib's
``net.finmath.finitedifference`` package (``FDMThetaMethod``,
``FDMBlackScholesModel``, ``FDMConstantElasticityOfVarianceModel``,
``FDMEuropeanCallOption`` / ``FDMEuropeanPutOption``). Departures from the
Java original, as in the JAX package:

* The backward induction is a loop over time steps; each step assembles
  the theta-scheme tridiagonal system for EVERY batch element (strike,
  volatility, scenario) at once and solves it with the prefix-scan Thomas
  solver (``ops/tridiagonal.py``), so a strike strip or a vol ladder is one
  solve, not a loop of solves.
* Everything is float64 (the H100 has native float64).
* The solver is differentiable: vega and rho come from autograd through
  the time loop and the prefix scans, instead of bump-and-reval.
* American exercise is an obstacle projection after each implicit step
  (Brennan-Schwartz-style operator splitting) with Rannacher start-up
  smoothing of the payoff kink.

A time-independent matrix is assembled once, and its elimination
(``tridiagonal._factor``: the eliminated superdiagonal and the pivots)
depends on theta alone, so it is computed once for the Rannacher steps and
once for the rest; each step then runs the matvec and the two affine
substitution scans. The values equal those of a fresh solve each step bit
for bit.

Interior stencil: backward PDE  V_t + mu V_x + (sig2/2) V_xx - r V = 0,
central differences, theta-weighted in time (theta=0.5 Crank-Nicolson,
1.0 implicit Euler). Boundary rows impose Gamma = 0, linearity of V in the
UNDERLYING (Windcliff-Forsyth-Vetzal), not in the grid coordinate, via a
ghost-point substitution folded into the tridiagonal row, so deep-ITM
values track the exact forward parity S - K e^{-r tau} on log grids,
theta-weighted like the interior.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.tridiagonal import _factor, _solve_factored, tridiagonal_matvec
from ..utils.config import select_device

__all__ = [
    "theta_scheme_solve",
    "FDMBlackScholesModel",
    "FDMConstantElasticityOfVarianceModel",
    "FDMLocalVolatilityModel",
    "FDMEuropeanCallOption",
    "FDMEuropeanPutOption",
    "FDMAmericanCallOption",
    "FDMAmericanPutOption",
    "FDMDigitalOption",
    "fdm_black_scholes_prices",
]

_F64 = torch.float64


# ---------------------------------------------------------------------------
# core theta-scheme backward induction
# ---------------------------------------------------------------------------

def _assemble_rows(mu, sig2, r, dx, g_top, g_bot):
    """Spatial-operator tridiagonal rows with the Gamma=0 ghost
    substitution folded into the boundary rows: top ghost
    V_{n+1} = V_n + g_top (V_n - V_{n-1}), bottom ghost
    V_{-1} = V_0 + g_bot (V_0 - V_1); rows stay tridiagonal and get the
    SAME theta weighting as the interior. Out of place, so autograd flows
    through every entry."""
    lo_c = 0.5 * sig2 / dx ** 2 - mu / (2.0 * dx)
    up_c = 0.5 * sig2 / dx ** 2 + mu / (2.0 * dx)
    di_c = -sig2 / dx ** 2 - r
    zero = torch.zeros_like(lo_c[..., :1])
    LO = torch.cat([zero, lo_c[..., 1:-1],
                    lo_c[..., -1:] + -g_top * up_c[..., -1:]], dim=-1)
    DI = torch.cat([di_c[..., :1] + (1.0 + g_bot) * lo_c[..., :1],
                    di_c[..., 1:-1],
                    di_c[..., -1:] + (1.0 + g_top) * up_c[..., -1:]], dim=-1)
    UP = torch.cat([up_c[..., :1] + -g_bot * lo_c[..., :1],
                    up_c[..., 1:-1], zero], dim=-1)
    return LO, DI, UP


def _theta_core(terminal, mu, sig2, r, thetas, dx, dt, g_top, g_bot,
                obstacle, *, time_dep: bool):
    """Backward induction on float64 tensors of one device.

    ``mu/sig2/r`` carry a leading [steps] axis iff ``time_dep``. A
    time-independent problem assembles its rows once and factors them once
    per distinct theta; the per-step work is then the matvec and the two
    substitution scans."""
    lead = 1 if time_dep else 0
    n = terminal.shape[-1]
    coef_shape = torch.broadcast_shapes(mu.shape[lead:], sig2.shape[lead:],
                                        r.shape[lead:], (n,))
    shape = torch.broadcast_shapes(
        terminal.shape, coef_shape,
        () if obstacle is None else obstacle.shape)
    v = terminal.expand(shape)

    def rows_of(m, s, rr):
        return _assemble_rows(m.expand(coef_shape), s.expand(coef_shape),
                              rr.expand(coef_shape), dx, g_top, g_bot)

    def factor(rows, th):
        LO, DI, UP = rows
        im = th * dt
        return _factor(-im * LO, 1.0 - im * DI, -im * UP)

    def advance(v, th, rows, factors):
        LO, DI, UP = rows
        ex = (1.0 - th) * dt
        rhs = v + ex * tridiagonal_matvec(LO, DI, UP, v)
        v_new = _solve_factored(factors, rhs)
        if obstacle is not None:
            v_new = torch.maximum(v_new, obstacle)
        return v_new

    if time_dep:
        for i, th in enumerate(thetas):
            rows = rows_of(mu[i], sig2[i], r[i])
            v = advance(v, th, rows, factor(rows, th))
        return v
    rows = rows_of(mu, sig2, r)
    factors = {}
    for th in thetas:
        if th not in factors:
            factors[th] = factor(rows, th)
        v = advance(v, th, rows, factors[th])
    return v


def _host(a) -> np.ndarray:
    """``a`` (a tensor on any device, or array-like) as float64 NumPy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def theta_scheme_solve(x,
                       terminal,
                       coeff_fn: Optional[Callable[[torch.Tensor],
                                                   Tuple[torch.Tensor,
                                                         torch.Tensor,
                                                         torch.Tensor]]],
                       maturity: float,
                       num_timesteps: int,
                       theta: float = 0.5,
                       rannacher: int = 2,
                       obstacle=None,
                       underlying=None,
                       coeffs: Optional[Tuple] = None,
                       device=None) -> torch.Tensor:
    """Solve V_t + mu V_x + (sig2/2) V_xx - r V = 0 backward from
    ``terminal`` at ``maturity`` to time 0 on the uniform grid ``x``
    (last axis; leading axes of ``terminal`` and of the coefficient
    arrays are batch). Returns a float64 tensor on ``device``
    (``select_device()`` by default); inputs may be arrays or tensors.

    Coefficients, one of:

    * ``coeffs=(mu, sig2, r)``: TIME-INDEPENDENT arrays broadcastable to
      ``[..., len(x)]``. The tridiagonal assembles once before the time
      loop and is factored once per theta.
    * ``coeff_fn(t) -> (mu, sig2, r)``: called ONCE with ``t`` the
      step-midpoint times as a ``[steps, 1]`` float64 tensor (second order
      for Crank-Nicolson), returning arrays broadcastable to
      ``[steps, len(x)]`` (a coefficient that ignores ``t`` may return
      ``[len(x)]``). The JAX package vmaps ``coeff_fn`` over scalar times
      instead; this is the one change of contract.

    The first ``rannacher`` steps run fully implicit (theta=1) to damp the
    terminal kink. ``obstacle`` (same shape rules as ``terminal``) turns
    the scheme into the projected variant: V = max(V, obstacle) after
    every step, American exercise.

    ``underlying`` is S(x) on the grid (e.g. exp(x) for a log grid);
    boundary rows impose linearity of V in it (Gamma = 0) through a ghost
    point extrapolated quadratically in x, exact for payoffs that become
    affine in S at the edges. Default: the grid itself, which reduces to
    the classic V_xx = 0 condition.

    Differentiable by autograd in every tensor input; when any input
    requires a gradient, the ghost factors and dx stay tensors.
    """
    dev = torch.device(device) if device is not None else select_device()

    def f64(a):
        return None if a is None else torch.as_tensor(a, dtype=_F64).to(dev)

    dt = maturity / num_timesteps
    steps = np.arange(num_timesteps)
    t_mid = maturity - (steps + 0.5) * dt
    thetas = [float(th) for th in np.where(steps < rannacher, 1.0,
                                           float(theta))]

    if coeffs is not None:
        mu, sig2, r = (f64(c) for c in coeffs)
        time_dep = False
    elif coeff_fn is not None:
        t = torch.as_tensor(t_mid, dtype=_F64, device=dev)[:, None]
        mu, sig2, r = (f64(c) for c in coeff_fn(t))
        mu, sig2, r = (c.expand(torch.broadcast_shapes(
            c.shape, (num_timesteps, 1))) for c in (mu, sig2, r))
        time_dep = True
    else:
        raise ValueError("provide coeffs=(mu, sig2, r) or coeff_fn")

    # Gamma=0 ghost-point folding factors (scalars, computed once). The
    # ghost underlying is the quadratic x-extrapolation of S(x): exact for
    # linear grids (g = 1 -> V_xx = 0) and second-order accurate for
    # exponential ones (g = 2 - e^{-dx} = e^{dx} + O(dx^3)).
    s = x if underlying is None else underlying
    if any(isinstance(a, torch.Tensor) and a.requires_grad
           for a in (x, terminal, mu, sig2, r, s, obstacle)):
        st, xt = f64(s), f64(x)
        g_top = (st[-3] - 3.0 * st[-2] + 2.0 * st[-1]) / (st[-1] - st[-2])
        g_bot = (2.0 * st[0] - 3.0 * st[1] + st[2]) / (st[0] - st[1])
        dx = xt[1] - xt[0]
    else:
        s_np, x_np = _host(s), _host(x)
        g_top = float((s_np[-3] - 3.0 * s_np[-2] + 2.0 * s_np[-1])
                      / (s_np[-1] - s_np[-2]))
        g_bot = float((2.0 * s_np[0] - 3.0 * s_np[1] + s_np[2])
                      / (s_np[0] - s_np[1]))
        dx = float(x_np[1] - x_np[0])
    return _theta_core(f64(terminal), mu, sig2, r, thetas, dx, dt, g_top,
                       g_bot, f64(obstacle), time_dep=time_dep)


def _solve_on_grid(x, spots, payoff_fn, maturity, model, american, device,
                   coeff_fn=None, coeffs=None):
    """One model solve: the payoff on the grid's spots (a float64 tensor
    on the device), the induction, one host copy of the values."""
    dev = torch.device(device) if device is not None else select_device()
    terminal = payoff_fn(torch.as_tensor(spots, dtype=_F64).to(dev))
    v = theta_scheme_solve(
        x, terminal, coeff_fn, maturity, model.num_timesteps,
        theta=model.theta, rannacher=model.rannacher,
        obstacle=terminal if american else None, underlying=spots,
        coeffs=coeffs, device=dev)
    return v.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# models: grid construction + PDE coefficients
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FDMBlackScholesModel:
    """Black-Scholes FDM model on a uniform LOG-spot grid.

    Mirrors finmath-lib ``FDMBlackScholesModel`` (numTimesteps,
    numSpacesteps, numStandardDeviations, center, theta, initialValue,
    riskFreeRate, volatility); solving in x = log S makes the
    coefficients constant, so the implicit matrix assembles once
    regardless of batch width."""

    num_timesteps: int
    num_spacesteps: int
    num_standard_deviations: float
    center: float
    theta: float
    initial_value: float
    risk_free_rate: float
    volatility: float
    dividend_yield: float = 0.0
    rannacher: int = 2

    def grid(self, maturity: float) -> np.ndarray:
        drift = (self.risk_free_rate - self.dividend_yield
                 - 0.5 * self.volatility ** 2)
        width = (self.num_standard_deviations * self.volatility
                 * math.sqrt(maturity) + abs(drift) * maturity)
        return np.linspace(math.log(self.center) - width,
                           math.log(self.center) + width,
                           self.num_spacesteps + 1, dtype=np.float64)

    def coefficient_arrays(self, x) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        mu = (self.risk_free_rate - self.dividend_yield
              - 0.5 * self.volatility ** 2)
        ones = np.ones(np.shape(x)[-1])
        return (mu * ones, self.volatility ** 2 * ones,
                self.risk_free_rate * ones)

    def coefficients(self, x):
        def coeff_fn(t):
            return tuple(torch.as_tensor(c, dtype=_F64, device=t.device)
                         for c in self.coefficient_arrays(x))

        return coeff_fn

    def spots(self, x) -> np.ndarray:
        return np.exp(_host(x))

    def solve(self, maturity: float, payoff_fn, american: bool = False,
              device=None):
        """(spots, values) on the grid at time 0, both NumPy."""
        x = self.grid(maturity)
        spots = np.exp(x)
        return spots, _solve_on_grid(x, spots, payoff_fn, maturity, self,
                                     american, device,
                                     coeffs=self.coefficient_arrays(x))


@dataclass(frozen=True)
class FDMConstantElasticityOfVarianceModel:
    """CEV model dS = r S dt + sigma S^beta dW on a uniform SPOT grid.

    Mirrors finmath-lib ``FDMConstantElasticityOfVarianceModel``. The grid
    is [low, high] around ``center`` with a lognormal-equivalent spread
    from sigma * center^(beta-1); at S=0 (beta<1) drift and diffusion
    vanish and the boundary row degenerates to pure discounting, which
    the linearity rows reproduce exactly."""

    num_timesteps: int
    num_spacesteps: int
    num_standard_deviations: float
    center: float
    theta: float
    initial_value: float
    risk_free_rate: float
    volatility: float
    exponent: float  # beta
    rannacher: int = 2

    def grid(self, maturity: float) -> np.ndarray:
        vol_ln = self.volatility * self.center ** (self.exponent - 1.0)
        spread = (self.num_standard_deviations * vol_ln
                  * math.sqrt(maturity))
        low = max(self.center * math.exp(-spread), 0.0)
        high = self.center * math.exp(spread)
        return np.linspace(low, high, self.num_spacesteps + 1,
                           dtype=np.float64)

    def coefficient_arrays(self, s) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        s = _host(s)
        mu = self.risk_free_rate * s
        sig2 = (self.volatility ** 2) * s ** (2.0 * self.exponent)
        return mu, sig2, np.full_like(s, self.risk_free_rate)

    def coefficients(self, s):
        def coeff_fn(t):
            return tuple(torch.as_tensor(c, dtype=_F64, device=t.device)
                         for c in self.coefficient_arrays(s))

        return coeff_fn

    def spots(self, s) -> np.ndarray:
        return _host(s)

    def solve(self, maturity: float, payoff_fn, american: bool = False,
              device=None):
        """(spots, values) on the grid at time 0, both NumPy."""
        s = self.grid(maturity)
        return s, _solve_on_grid(s, s, payoff_fn, maturity, self, american,
                                 device, coeffs=self.coefficient_arrays(s))


@dataclass(frozen=True)
class FDMLocalVolatilityModel:
    """Dupire local-volatility backward PDE on the log-spot grid.

    sigma_loc^2(x, t) comes from the same ``local_variance`` autodiff
    extractor the Monte-Carlo ``LocalVolatilityModel`` uses
    (``models/local_vol.py``), so PDE and MC price the IDENTICAL local-vol
    dynamics: the PDE run is the noise-free oracle for the MC engine and
    vice versa. No Java counterpart: finmath's FDM package stops at CEV."""

    num_timesteps: int
    num_spacesteps: int
    num_standard_deviations: float
    theta: float
    initial_value: float
    risk_free_rate: float
    surface: object  # SSVISurface / DupireLocalVolSurface
    dividend_yield: float = 0.0
    reference_vol: float = 0.3  # grid-sizing scale
    t_floor: float = 1e-3
    min_variance: float = 1e-6
    max_variance: float = 16.0
    rannacher: int = 2

    def grid(self, maturity: float) -> np.ndarray:
        width = (self.num_standard_deviations * self.reference_vol
                 * math.sqrt(maturity)
                 + abs(self.risk_free_rate - self.dividend_yield)
                 * maturity)
        c = math.log(self.initial_value)
        return np.linspace(c - width, c + width,
                           self.num_spacesteps + 1, dtype=np.float64)

    def coefficients(self, x):
        """``coeff_fn(t)`` for ``theta_scheme_solve``: ``t`` a ``[steps,
        1]`` tensor, the coefficients ``[steps, len(x)]`` (the rate
        ``[len(x)]``), all local variances of the induction in one
        ``local_variance`` call."""
        from .local_vol import local_variance

        carry = self.risk_free_rate - self.dividend_yield
        logs0 = math.log(self.initial_value)

        def coeff_fn(t):
            xj = torch.as_tensor(x, dtype=_F64).to(t.device)
            tt = torch.clamp_min(t, self.t_floor)
            k = xj - logs0 - carry * tt
            v = local_variance(self.surface, k, tt)
            v = torch.clamp(v, self.min_variance, self.max_variance)
            mu = carry - 0.5 * v
            return mu, v, torch.full_like(xj, self.risk_free_rate)

        return coeff_fn

    def spots(self, x) -> np.ndarray:
        return np.exp(_host(x))

    def solve(self, maturity: float, payoff_fn, american: bool = False,
              device=None):
        """(spots, values) on the grid at time 0, both NumPy."""
        x = self.grid(maturity)
        spots = np.exp(x)
        return spots, _solve_on_grid(x, spots, payoff_fn, maturity, self,
                                     american, device,
                                     coeff_fn=self.coefficients(x))


# ---------------------------------------------------------------------------
# products (finmath FDM product surface)
# ---------------------------------------------------------------------------

class _FDMOption:
    """Shared getValue plumbing: returns (spots, values) grids like
    finmath's ``FDMEuropeanCallOption.getValue(time, model)`` double[][],
    plus an interpolated scalar at the model's initialValue. ``device``
    (``select_device()`` by default) is where the solve runs."""

    american = False

    def __init__(self, maturity: float, strike: float):
        self.maturity = float(maturity)
        self.strike = float(strike)

    def payoff(self, spots: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def get_value(self, evaluation_time: float, model, device=None):
        if evaluation_time != 0.0:
            raise NotImplementedError(
                "FDM products value at time 0 (as finmath's do)")
        return model.solve(self.maturity, self.payoff,
                           american=self.american, device=device)

    getValue = get_value

    def value(self, model, device=None) -> float:
        spots, values = self.get_value(0.0, model, device=device)
        return float(np.interp(model.initial_value, spots, values))


class FDMEuropeanCallOption(_FDMOption):
    def payoff(self, spots):
        return torch.clamp_min(spots - self.strike, 0.0)


class FDMEuropeanPutOption(_FDMOption):
    def payoff(self, spots):
        return torch.clamp_min(self.strike - spots, 0.0)


class FDMAmericanPutOption(FDMEuropeanPutOption):
    american = True


class FDMAmericanCallOption(FDMEuropeanCallOption):
    american = True


class FDMDigitalOption(_FDMOption):
    """Cash-or-nothing call: the payoff discontinuity is the stress test
    for the Rannacher start-up (oscillates badly under plain CN).

    The terminal condition is the CELL AVERAGE of the indicator (Pooley-
    Vetzal-Forsyth payoff averaging): a node's value is the fraction of
    its dual cell above the strike, which removes the O(dx) error from
    the strike landing between grid nodes."""

    def payoff(self, spots):
        mid = 0.5 * (spots[..., 1:] + spots[..., :-1])
        lower = torch.cat([spots[..., :1], mid], dim=-1)
        upper = torch.cat([mid, spots[..., -1:]], dim=-1)
        return torch.clamp((upper - self.strike) / (upper - lower), 0.0, 1.0)


# ---------------------------------------------------------------------------
# batched strike-strip pricer (one solve for the whole strip)
# ---------------------------------------------------------------------------

def fdm_black_scholes_prices(initial_value: float, risk_free_rate: float,
                             volatility, maturity: float,
                             strikes: Sequence[float],
                             is_call: bool = True,
                             dividend_yield: float = 0.0,
                             american: bool = False,
                             num_timesteps: int = 200,
                             num_spacesteps: int = 400,
                             num_standard_deviations: float = 8.0,
                             theta: float = 0.5,
                             device=None) -> np.ndarray:
    """Price a whole strike strip (and optionally a vol ladder:
    ``volatility`` may be scalar or ``[n_vols, 1]``-shaped) in ONE
    theta-scheme solve; the batch rides the tridiagonal solver's leading
    axes. Returns NumPy values interpolated at ``initial_value``, shape =
    broadcast(strikes, volatility)."""
    strikes = _host(strikes)
    vol = _host(volatility)
    sig2 = vol ** 2
    mu = risk_free_rate - dividend_yield - 0.5 * sig2
    vol_max = float(np.max(vol))
    width = (num_standard_deviations * vol_max * math.sqrt(maturity)
             + abs(risk_free_rate - dividend_yield) * maturity)
    x = np.linspace(math.log(initial_value) - width,
                    math.log(initial_value) + width,
                    num_spacesteps + 1, dtype=np.float64)
    spots = np.exp(x)
    sign = 1.0 if is_call else -1.0
    terminal = np.maximum(sign * (spots - strikes[..., None]), 0.0)

    ones = np.ones_like(x)
    coeffs = (np.asarray(mu)[..., None] * ones if np.ndim(mu) else mu * ones,
              np.asarray(sig2)[..., None] * ones if np.ndim(sig2)
              else sig2 * ones,
              np.full_like(x, risk_free_rate))

    v = theta_scheme_solve(x, terminal, None, maturity, num_timesteps,
                           theta=theta,
                           obstacle=terminal if american else None,
                           underlying=spots, coeffs=coeffs, device=device)
    # interpolate every batch row at the initial value on the host: one
    # copy of the values, the interpolation a scalar weight
    v = v.cpu().numpy()
    xq = math.log(initial_value)
    idx = int(np.clip(np.searchsorted(x, xq) - 1, 0, x.shape[0] - 2))
    w = (xq - x[idx]) / (x[idx + 1] - x[idx])
    return v[..., idx] * (1.0 - w) + v[..., idx + 1] * w
