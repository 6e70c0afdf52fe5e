"""Path-dependent equity products (digital, Asian, barrier, lookback), each
a few device operations over a facade's asset matrix, and a book priced
with one host transfer.

Counterpart of ``finmath_tpu.models.equity_products`` (finmath-lib's
``assetderivativevaluation.products`` ``DigitalOption``, ``AsianOption``
and the barrier and lookback payoffs its users compose through the
``RandomVariable`` API). A product reads only the facade's surface:
``get_asset_value``, ``get_asset_values``, ``get_numeraire``, ``.model``
(or ``.params``) and ``process.time_discretization``, so any equity facade
with that surface serves. Its ``packed_value_and_error`` returns the
``[2]`` float64 (value, standard error) on the facade's device without a
host transfer; ``get_value_and_error`` copies that tensor to the host once,
and ``price_portfolio`` copies a whole book's ``[N, 2]`` once.

Under a meshed facade (its ``mesh``, a ``parallel.PathMesh``) the asset
matrices are this rank's block of the paths and every payoff mean and
standard error is global: a float64 all-reduce of the sum, then of the
squared deviations from the global mean (``_mean_and_stderr``). Every
product of the port reduces so, those of ``american``, ``hedging``,
``structured_products`` and ``local_vol.european_call_values`` too.

Precision, as in the JAX package: path data stays float32 (the payoffs
are float32 where the JAX function computes them in float32), the payoff
means and standard errors, the discount factors and the geometric
averages are float64. Scalars the JAX functions take as float32 arrays
(strikes, barriers) are 0-dim float32 tensors on the facade's device, so
every operation on them is the IEEE float32 operation on both devices.

The Brownian-bridge barrier computes every step's crossing factor in one
pass over the ``[T, paths]`` log-distance matrix and multiplies the
factors with one ``torch.prod`` along the date axis (the JAX package
carries the float32 survival through a ``lax.scan``, so the order of the
float32 product differs).

Oracles: the closed forms in ``models/analytic.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from ..utils.config import to_device


def _mean_and_stderr(pay: torch.Tensor, mesh=None) -> torch.Tensor:
    """Packed [2] float64 (mean, MC standard error) of a [paths] payoff;
    under ``mesh`` over every rank's block (two-pass: the global mean,
    then the global sum of squared deviations)."""
    n = pay.shape[-1]
    p = pay.to(ACC_DTYPE)
    if mesh is None:
        mean = torch.sum(p) / n
        var = torch.sum((p - mean) ** 2) / (n - 1)
    else:
        n *= mesh.world_size
        mean = mesh.all_reduce(torch.sum(p)) / n
        var = mesh.all_reduce(torch.sum((p - mean) ** 2)) / (n - 1)
    return torch.stack([mean, torch.sqrt(var / n)])


def _mesh_of(model):
    """The facade's ``PathMesh``, or None (facades without one)."""
    return getattr(model, "mesh", None)


def _over_ranks(mesh):
    """The sum over the ranks of ``mesh`` (the identity without one)."""
    return (lambda x: x) if mesh is None else mesh.all_reduce


def _deterministic_dfs(model, times) -> np.ndarray:
    """N(0)/N(t) for each t, requiring a deterministic numeraire (the
    equity facades)."""
    n0 = model.get_numeraire(0.0)
    dfs = []
    for t in times:
        nt = model.get_numeraire(float(t))
        if not (nt.is_deterministic() and n0.is_deterministic()):
            raise NotImplementedError(
                "equity products need a deterministic numeraire; use the "
                "LMM product layer for stochastic rates")
        dfs.append(float(n0.get_average() / nt.get_average()))
    return np.asarray(dfs, dtype=np.float64)


def _grid_times_up_to(model, maturity: float) -> list:
    td = getattr(model, "time_discretization", None)
    if td is None:                         # BS facade: on the process
        td = model.process.time_discretization
    times = [float(t) for t in td.as_array()
             if 0.0 < float(t) <= maturity + 1e-12]
    if not times or abs(times[-1] - maturity) > 1e-9:
        raise ValueError(
            f"maturity {maturity} not on the simulation grid")
    return times


def _spot_of(model) -> float:
    """The t=0 asset value of a facade (initial_value on the underlying
    model object; every equity family carries it)."""
    inner = getattr(model, "model", None) or getattr(model, "params", None)
    s0 = getattr(inner, "initial_value", None)
    if s0 is None:
        raise NotImplementedError(
            "facade does not expose initial_value for the t=0 row")
    return float(s0)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-dim tensor on ``like``'s device: the counterpart of the
    JAX functions' ``jnp.asarray(x, dtype=FLOAT_DTYPE)`` arguments."""
    return torch.full((), float(x), dtype=FLOAT_DTYPE, device=like.device)


def _with_spot_row(assets: torch.Tensor, s0: float) -> torch.Tensor:
    """[T + 1, paths]: the t=0 row (S0 in float32) above ``assets``."""
    return torch.cat([assets.new_full((1, assets.shape[1]), s0), assets])


def _black_scholes_of(model, what: str):
    from .black_scholes import BlackScholesModel

    bs = getattr(model, "model", None)
    if not isinstance(bs, BlackScholesModel):
        raise NotImplementedError(what)
    return bs


class _Product:
    """``get_value_and_error`` as one host copy of
    ``packed_value_and_error``."""

    def get_value_and_error(self, model) -> tuple:
        out = self.packed_value_and_error(model).cpu().numpy()
        return float(out[0]), float(out[1])

    def get_value(self, model) -> float:
        return self.get_value_and_error(model)[0]

    def getValue(self, model) -> float:
        return self.get_value(model)


def _digital_kernel(s_t, df: float, strike, is_call: bool, mesh=None):
    sign = 1.0 if is_call else -1.0
    pay = (sign * (s_t - strike) > 0.0).to(ACC_DTYPE) * df
    return _mean_and_stderr(pay, mesh)


class DigitalOption(_Product):
    """Cash-or-nothing digital: pays 1 at maturity if ITM
    (finmath-lib ``products.DigitalOption``)."""

    def __init__(self, maturity: float, strike: float, is_call: bool = True):
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.is_call = bool(is_call)

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        s_t = model.get_asset_value(self.maturity).values
        df = _deterministic_dfs(model, [self.maturity])[0]
        return _digital_kernel(s_t, float(df), _f32(self.strike, s_t),
                               self.is_call, _mesh_of(model))


def _asian_kernel(assets, df: float, strike, is_call: bool,
                  geometric: bool, mesh=None):
    sign = 1.0 if is_call else -1.0
    if geometric:
        avg = torch.exp(torch.mean(torch.log(assets.to(ACC_DTYPE)), dim=0))
    else:
        avg = torch.mean(assets.to(ACC_DTYPE), dim=0)
    pay = torch.clamp_min(sign * (avg - strike), 0.0) * df
    return _mean_and_stderr(pay, mesh)


def _asian_cv_kernel(assets, df: float, strike, geo_value: float,
                     is_call: bool, mesh=None):
    """Arithmetic Asian with the geometric Asian as control variate
    (beta fixed at 1): the corrected estimator is unbiased with the
    residual (arith - geo) variance."""
    sign = 1.0 if is_call else -1.0
    a64 = assets.to(ACC_DTYPE)
    arith = torch.mean(a64, dim=0)
    geo = torch.exp(torch.mean(torch.log(a64), dim=0))
    pay_a = torch.clamp_min(sign * (arith - strike), 0.0) * df
    pay_g = torch.clamp_min(sign * (geo - strike), 0.0) * df
    out = _mean_and_stderr(pay_a - pay_g, mesh)
    return torch.stack([out[0] + geo_value, out[1]])


class AsianOption(_Product):
    """Arithmetic-average Asian option over explicit averaging dates
    (finmath-lib ``products.AsianOption``), paid at the last date.

    ``average="geometric"`` prices the geometric payoff instead;
    ``control_variate="geometric"`` keeps the arithmetic payoff but
    subtracts the geometric payoff pathwise and adds back its exact
    closed form (gated on a Black-Scholes facade)."""

    def __init__(self, averaging_times: Sequence[float], strike: float,
                 is_call: bool = True, average: str = "arithmetic",
                 control_variate: Optional[str] = None):
        self.averaging_times = [float(t) for t in averaging_times]
        if (not self.averaging_times
                or sorted(self.averaging_times) != self.averaging_times
                or self.averaging_times[0] <= 0.0):
            raise ValueError("averaging_times must be ascending, positive")
        if average not in ("arithmetic", "geometric"):
            raise ValueError("average must be 'arithmetic' or 'geometric'")
        if control_variate not in (None, "geometric"):
            raise ValueError("control_variate must be None or 'geometric'")
        if control_variate and average == "geometric":
            raise ValueError("the geometric payoff IS the control variate")
        self.strike = float(strike)
        self.is_call = bool(is_call)
        self.average = average
        self.control_variate = control_variate

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        assets = model.get_asset_values(self.averaging_times)
        df = float(_deterministic_dfs(model, [self.averaging_times[-1]])[0])
        # the JAX kernel subtracts a float32 strike from float64 averages
        strike = float(np.float32(self.strike))
        if self.control_variate == "geometric":
            from .analytic import geometric_asian_option_value

            bs = _black_scholes_of(
                model, "geometric control variate needs a Black-Scholes "
                       "facade (the geometric closed form)")
            geo = geometric_asian_option_value(
                bs.initial_value, bs.risk_free_rate, bs.volatility,
                self.averaging_times, self.strike, self.is_call)
            return _asian_cv_kernel(assets, df, strike, geo, self.is_call,
                                    _mesh_of(model))
        return _asian_kernel(assets, df, strike, self.is_call,
                             self.average == "geometric", _mesh_of(model))


def _barrier_bridge_kernel(assets_with_s0, df: float, strike, barrier,
                           up: bool, knock_in: bool, is_call: bool,
                           inv_var_dt, rebate: float = 0.0, mesh=None):
    """Brownian-bridge corrected barrier (lognormal dynamics).
    assets_with_s0: [T+1, paths] float32 INCLUDING the t=0 row; inv_var_dt:
    [T] float32 1/(sigma^2 dt) per step on the device. Survival of an
    out-option is the product over steps of 1 - exp(-2 a_k a_{k+1} /
    (sigma^2 dt)) with a = ln(S/B), 0 where an endpoint breaches; the
    factors are one float32 pass over [T, paths], their product one
    ``torch.prod`` along the dates."""
    sign = 1.0 if is_call else -1.0
    a = torch.log(assets_with_s0 / barrier)
    breach = a >= 0.0 if up else a <= 0.0      # side * a >= 0
    fac = (a[:-1] * -2.0).mul_(a[1:]).mul_(inv_var_dt[:, None])
    fac = fac.exp_().clamp_(0.0, 1.0).neg_().add_(1.0)
    fac.masked_fill_(breach[:-1] | breach[1:], 0.0)
    del a, breach
    survival = torch.prod(fac, dim=0)
    del fac
    vanilla = torch.clamp_min(sign * (assets_with_s0[-1] - strike), 0.0)
    alive = (1.0 - survival) if knock_in else survival
    pay = vanilla * alive + rebate * (1.0 - alive)
    return _mean_and_stderr(pay.to(ACC_DTYPE) * df, mesh)


def _barrier_discrete_kernel(assets, df: float, strike, barrier,
                             up: bool, knock_in: bool, is_call: bool,
                             rebate: float, mesh=None):
    sign = 1.0 if is_call else -1.0
    vanilla = torch.clamp_min(sign * (assets[-1] - strike), 0.0)
    gap = assets - barrier
    breached = torch.any(gap >= 0.0 if up else gap <= 0.0, dim=0)
    del gap
    alive = (breached if knock_in else ~breached).to(FLOAT_DTYPE)
    pay = vanilla * alive + rebate * (1.0 - alive)
    return _mean_and_stderr(pay.to(ACC_DTYPE) * df, mesh)


class BarrierOption(_Product):
    """Single-barrier knock-in/knock-out European option, monitored on
    the facade's simulation grid.

    ``monitoring="discrete"`` knocks only on grid dates;
    ``monitoring="bridge"`` applies the Brownian-bridge crossing
    correction for a continuously monitored contract (gated on
    Black-Scholes facades). A cash ``rebate`` is paid at maturity when the
    option is knocked out (out-types) or never knocked in (in-types)."""

    _TYPES = ("up-out", "down-out", "up-in", "down-in")

    def __init__(self, maturity: float, strike: float, barrier: float,
                 barrier_type: str, is_call: bool = True,
                 monitoring: str = "discrete", rebate: float = 0.0):
        if barrier_type not in self._TYPES:
            raise ValueError(f"barrier_type must be one of {self._TYPES}")
        if monitoring not in ("discrete", "bridge"):
            raise ValueError("monitoring must be 'discrete' or 'bridge'")
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.barrier = float(barrier)
        self.barrier_type = barrier_type
        self.is_call = bool(is_call)
        self.monitoring = monitoring
        self.rebate = float(rebate)

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        times = _grid_times_up_to(model, self.maturity)
        assets = model.get_asset_values(times)
        df = float(_deterministic_dfs(model, [self.maturity])[0])
        up = self.barrier_type.startswith("up")
        knock_in = self.barrier_type.endswith("in")
        strike, barrier = _f32(self.strike, assets), _f32(self.barrier,
                                                          assets)
        if self.monitoring == "bridge":
            bs = _black_scholes_of(
                model, "bridge monitoring needs lognormal dynamics "
                       "(Black-Scholes facade)")
            steps = np.diff([0.0] + times)
            inv = to_device(1.0 / (bs.volatility ** 2 * steps),
                            FLOAT_DTYPE, assets.device)
            return _barrier_bridge_kernel(
                _with_spot_row(assets, bs.initial_value), df, strike,
                barrier, up, knock_in, self.is_call, inv, self.rebate,
                _mesh_of(model))
        return _barrier_discrete_kernel(assets, df, strike, barrier, up,
                                        knock_in, self.is_call, self.rebate,
                                        _mesh_of(model))


def _lookback_kernel(assets, s0: float, df: float, strike: float,
                     kind: str, fixed: bool, mesh=None):
    """The extremum over the t=0 spot and ``assets`` ([T, paths]) is taken
    in float32 (exact: no accumulation); the payoff and its reduction are
    float64."""
    s_t = assets[-1].to(ACC_DTYPE)
    if kind == "max":
        ext = torch.clamp_min(torch.amax(assets, dim=0), s0).to(ACC_DTYPE)
        pay = torch.clamp_min(ext - strike, 0.0) if fixed else (ext - s_t)
    else:
        ext = torch.clamp_max(torch.amin(assets, dim=0), s0).to(ACC_DTYPE)
        pay = torch.clamp_min(strike - ext, 0.0) if fixed else (s_t - ext)
    return _mean_and_stderr(pay * df, mesh)


class LookbackOption(_Product):
    """Lookback option on the facade's simulation grid. Types:
    ``floating-call`` pays S_T - min S, ``floating-put`` pays
    max S - S_T, ``fixed-call`` pays (max S - K)+, ``fixed-put`` pays
    (K - min S)+. Discrete monitoring biases the extremum toward the spot
    (the Broadie-Glasserman-Kou sqrt(dt) correction bounds the gap to the
    continuous closed forms)."""

    _TYPES = ("floating-call", "floating-put", "fixed-call", "fixed-put")

    def __init__(self, maturity: float, lookback_type: str,
                 strike: Optional[float] = None):
        if lookback_type not in self._TYPES:
            raise ValueError(f"lookback_type must be one of {self._TYPES}")
        fixed = lookback_type.startswith("fixed")
        if fixed and strike is None:
            raise ValueError("fixed-strike lookback needs a strike")
        if not fixed and strike is not None:
            raise ValueError("floating-strike lookback takes no strike")
        self.maturity = float(maturity)
        self.lookback_type = lookback_type
        self.strike = float(strike) if fixed else 0.0

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        times = _grid_times_up_to(model, self.maturity)
        assets = model.get_asset_values(times)
        df = float(_deterministic_dfs(model, [self.maturity])[0])
        s0 = float(np.float32(_spot_of(model)))
        kind = "min" if self.lookback_type in ("floating-call",
                                               "fixed-put") else "max"
        return _lookback_kernel(assets, s0, df, self.strike, kind,
                                self.lookback_type.startswith("fixed"),
                                _mesh_of(model))


# ---------------------------------------------------------------------------
# portfolio pricing: one transfer for a whole book
# ---------------------------------------------------------------------------

def price_portfolio(model, products) -> list:
    """[(value, stderr)] for a product book with ONE host transfer: every
    product's ``packed_value_and_error`` stays on the device (the launches
    queue without a synchronisation) and the stacked ``[N, 2]`` float64
    tensor is copied to the host once. Works for any product with
    ``packed_value_and_error(model)``: the equity exotics,
    ``EuropeanOption``, the Hull-White book (TARN, Bermudan), ..."""
    if not products:
        return []
    packed = [p.packed_value_and_error(model) for p in products]
    device = packed[0].device
    out = torch.stack([p.to(device) for p in packed]).cpu().numpy()
    return [(float(v), float(e)) for v, e in out]
