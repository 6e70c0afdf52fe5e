"""Hedge simulation and realized-variance products: the delta-hedged
portfolio and the variance swap.

Counterpart of ``finmath_tpu.models.hedging`` (finmath-lib's
``BlackScholesDeltaHedgedPortfolio`` and a realized-variance payoff). The
hedge evaluates the Black-Scholes delta N(d1) of every grid date in one
float32 pass over the ``[T + 1, paths]`` asset matrix, then carries the
cash leg through a loop over the dates.

Precision, the JAX function's mixed split: the delta is float32
(``torch.log``, ``torch.erf``; the per-date time to maturity and its
coefficients are the float32 scalars the JAX scan forms); the cash leg and
its accrual exp(r dt) are float64, and each rebalance is
``(d_new - d_prev) * s`` in float64. The discounted hedged-portfolio mean
reprices the option on any grid; the hedge error's standard deviation
shrinks like sqrt(dt).

Under a meshed facade (its ``mesh``, a ``parallel.PathMesh``) the asset
matrix is this rank's block of the paths and every statistic is global,
in the two passes of the unsharded kernels: one all-reduce of the sums
for the means, then one of the squared deviations from them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from ..utils.config import to_device
from .equity_products import (_black_scholes_of, _deterministic_dfs, _f32,
                              _grid_times_up_to, _mesh_of, _over_ranks,
                              _spot_of, _with_spot_row)


def _delta_coefficients(times, r: float, sigma: float, maturity: float):
    """Per date the float32 scalars of d1 = (log(s / K) + c) / v, as the
    JAX scan forms them: tau = float32(max(T - float32(t), 1e-12)),
    c = (r + 0.5 sigma sigma) tau and v = sigma sqrt(tau), all float32."""
    f32 = np.float32
    rf, sigf = f32(r), f32(sigma)
    t32 = np.asarray(times, dtype=np.float64).astype(f32).astype(np.float64)
    tau = np.maximum(float(maturity) - t32, 1e-12).astype(f32)
    c = (rf + f32(0.5) * sigf * sigf) * tau
    v = sigf * np.sqrt(tau)
    return c.astype(f32), v.astype(f32)


def _delta_hedge_kernel(assets_with_s0, times, r: float, sigma: float,
                        strike, maturity: float, v0: float, is_call: bool,
                        mesh=None):
    """assets_with_s0: [T+1, paths] float32 including t=0; times: [T+1]
    host float64 grid (0 first); strike a float32 0-dim tensor. Returns
    [3] float64: (discounted portfolio mean, hedge-error mean, hedge-error
    std), the hedge error being portfolio(T) - payoff(T) in time-T money;
    under ``mesh`` over every rank's paths."""
    sign = 1.0 if is_call else -1.0
    device = assets_with_s0.device
    c, v = _delta_coefficients(times, r, sigma, maturity)
    c = to_device(c[:, None], FLOAT_DTYPE, device)
    v = to_device(v[:, None], FLOAT_DTYPE, device)
    d1 = (torch.log(assets_with_s0 / strike) + c) / v
    delta = torch.erf(d1 / math.sqrt(2.0)).add_(1.0).mul_(0.5)
    del d1
    if not is_call:
        delta = delta - 1.0
    s0 = assets_with_s0[0]
    cash = v0 - delta[0].to(ACC_DTYPE) * s0.to(ACC_DTYPE)   # self-financing
    dts = np.diff(np.asarray(times, dtype=np.float64))
    for k, dt in enumerate(dts, start=1):
        cash = cash * math.exp(r * dt)                         # f64 accrual
        cash = cash - (delta[k] - delta[k - 1]).to(ACC_DTYPE) \
            * assets_with_s0[k].to(ACC_DTYPE)                  # rebalance
    s_t = assets_with_s0[-1].to(ACC_DTYPE)
    portfolio = delta[-1].to(ACC_DTYPE) * s_t + cash
    payoff = torch.clamp_min(sign * (s_t - strike.to(ACC_DTYPE)), 0.0)
    err = portfolio - payoff
    pv = portfolio * math.exp(-r * maturity)
    over = _over_ranks(mesh)
    n = pv.shape[0] * (1 if mesh is None else mesh.world_size)
    sums = over(torch.stack([torch.sum(pv), torch.sum(err)]))
    mean_pv = sums[0] / n
    mean_err = sums[1] / n
    std_err = torch.sqrt(over(torch.sum((err - mean_err) ** 2)) / (n - 1))
    return torch.stack([mean_pv, mean_err, std_err])


class DeltaHedgedPortfolio:
    """Discrete Black-Scholes delta hedge of a European option, rebalanced
    on the facade's grid (finmath BlackScholesDeltaHedgedPortfolio):
    starts with the analytic premium, trades delta(t, S_t) at every grid
    date. The discounted terminal portfolio reprices the option for ANY
    rebalancing grid; the terminal hedge error is the discretization
    residual (std ~ sqrt(dt))."""

    def __init__(self, maturity: float, strike: float,
                 is_call: bool = True):
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.is_call = bool(is_call)

    def simulate(self, model) -> dict:
        from .analytic import black_scholes_option_value

        bs = _black_scholes_of(
            model, "the BS delta hedge needs a Black-Scholes facade")
        times = _grid_times_up_to(model, self.maturity)
        assets = model.get_asset_values(times)
        v0 = black_scholes_option_value(
            bs.initial_value, bs.risk_free_rate, bs.volatility,
            self.maturity, self.strike, self.is_call)
        out = _delta_hedge_kernel(
            _with_spot_row(assets, bs.initial_value), [0.0] + times,
            bs.risk_free_rate, bs.volatility, _f32(self.strike, assets),
            self.maturity, v0, self.is_call, _mesh_of(model)).cpu().numpy()
        return {"value": float(out[0]), "premium": v0,
                "hedge_error_mean": float(out[1]),
                "hedge_error_std": float(out[2])}

    def get_value(self, model) -> float:
        """Discounted terminal hedge-portfolio mean: equals the option
        value on any grid (finmath's getValue contract)."""
        return self.simulate(model)["value"]

    getValue = get_value


def _variance_swap_kernel(assets_with_s0, df: float, inv_t: float,
                          mesh=None):
    """[3] float64 (value, stderr, undiscounted mean RV) of the realized
    variance of each path; under ``mesh`` over every rank's paths."""
    la = torch.log(assets_with_s0)
    dlog = la[1:] - la[:-1]                      # [T, paths] f32
    del la
    rv = torch.sum((dlog * dlog).to(ACC_DTYPE), dim=0) * inv_t
    over = _over_ranks(mesh)
    n = rv.shape[0] * (1 if mesh is None else mesh.world_size)
    mean = over(torch.sum(rv)) / n
    std = torch.sqrt(over(torch.sum((rv - mean) ** 2)) / (n - 1))
    return torch.stack([mean * df, std / math.sqrt(1.0 * n) * df, mean])


class VarianceSwap:
    """Pays the annualized realized variance of log returns on the
    facade's grid at maturity: RV = (1/T) sum (ln S_{i+1}/S_i)^2.
    ``get_value`` returns df * E[RV]; ``fair_strike`` the undiscounted
    expectation (the quoted variance-swap strike). Under Black-Scholes
    E[RV] = sigma^2 + (r - sigma^2/2)^2 dt (the drift-squared term is the
    discrete-sampling bias)."""

    def __init__(self, maturity: float):
        self.maturity = float(maturity)

    def _packed(self, model) -> np.ndarray:
        times = _grid_times_up_to(model, self.maturity)
        assets = model.get_asset_values(times)
        df = float(_deterministic_dfs(model, [self.maturity])[0])
        return _variance_swap_kernel(
            _with_spot_row(assets, _spot_of(model)), df,
            1.0 / self.maturity, _mesh_of(model)).cpu().numpy()

    def get_value_and_error(self, model) -> tuple:
        out = self._packed(model)
        return float(out[0]), float(out[1])

    def get_value(self, model) -> float:
        return self.get_value_and_error(model)[0]

    def fair_strike(self, model) -> float:
        return float(self._packed(model)[2])

    getValue = get_value
