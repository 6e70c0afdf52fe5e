"""Structured equity products: forward-start, cliquet, compound and
chooser options and the autocallable note, each a few device operations
over any equity facade, each with its exact Black-Scholes closed form as
oracle.

Counterpart of ``finmath_tpu.models.structured_products`` (finmath-lib
users build these payoffs through the ``RandomVariable`` API on a
``MonteCarloAssetModel``). Closed forms (host float64, as there):
Rubinstein (1991) forward-start, the per-period forward-start
decomposition of a locally collared cliquet, Geske (1979) compound through
the Gauss-Legendre bivariate normal CDF, the simple-chooser parity, and the
two-date express certificate.

The compound and chooser payoffs evaluate the inner Black-Scholes value
pathwise in float32 (``_bs_value_vec``, ``torch.log`` and ``torch.erf``),
as the JAX functions do; the reductions are float64.

Under a meshed facade (its ``mesh``, a ``parallel.PathMesh``) each payoff
is this rank's block of the paths and its mean and standard error are
global (``equity_products._mean_and_stderr``), equal on every rank.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from .analytic import _norm_cdf, black_scholes_option_value
from .equity_products import (_Product, _black_scholes_of,
                              _deterministic_dfs, _f32, _mean_and_stderr,
                              _mesh_of, _spot_of, _with_spot_row)


# ---------------------------------------------------------------------------
# closed forms (host f64)
# ---------------------------------------------------------------------------

def forward_start_option_value(initial_value: float, risk_free_rate: float,
                               volatility: float, start_time: float,
                               maturity: float, moneyness: float,
                               is_call: bool = True) -> float:
    """Rubinstein (1991): option with strike set to
    ``moneyness * S(start_time)``. Homogeneity gives
    V = S0 * BS(spot=1, strike=moneyness, tau=maturity-start_time)."""
    if not 0.0 < start_time < maturity:
        raise ValueError("need 0 < start_time < maturity")
    return initial_value * black_scholes_option_value(
        1.0, risk_free_rate, volatility, maturity - start_time,
        moneyness, is_call)


def cliquet_option_value(risk_free_rate: float, volatility: float,
                         reset_times: Sequence[float],
                         floor: float, cap: float,
                         notional: float = 1.0) -> float:
    """Exact value of the (globally uncapped, locally collared) cliquet
    paying sum_i clip(S(t_i)/S(t_{i-1}) - 1, floor, cap) at the last
    reset: period returns of a GBM are independent, and a collared
    return is floor + (X - (1+floor))+ - (X - (1+cap))+ with X the
    period's lognormal gross return, each term a Rubinstein forward-start
    value with S0 = 1."""
    t = [0.0] + [float(x) for x in reset_times]
    if sorted(t) != t or len(t) < 2:
        raise ValueError("reset_times must be ascending, positive")
    if not floor <= cap:
        raise ValueError("floor must be <= cap")
    total = 0.0
    for a, b in zip(t[:-1], t[1:]):
        tau = b - a
        c_floor = black_scholes_option_value(
            1.0, risk_free_rate, volatility, tau, 1.0 + floor)
        c_cap = (black_scholes_option_value(
            1.0, risk_free_rate, volatility, tau, 1.0 + cap)
            if np.isfinite(cap) else 0.0)
        # undiscounted expectation of the collared return
        total += floor + (c_floor - c_cap) * math.exp(
            risk_free_rate * tau)
    return notional * math.exp(-risk_free_rate * t[-1]) * total


def compound_option_value(initial_value: float, risk_free_rate: float,
                          volatility: float, outer_maturity: float,
                          outer_strike: float, inner_maturity: float,
                          inner_strike: float) -> float:
    """Geske (1979) call-on-call: at t1 = outer_maturity the holder may
    pay outer_strike for a European call (inner_strike, t2), through the
    Gauss-Legendre bivariate normal CDF."""
    from .multi_asset import bivariate_normal_cdf
    s, r, sig = initial_value, risk_free_rate, volatility
    t1, k1, t2, k2 = (outer_maturity, outer_strike, inner_maturity,
                      inner_strike)
    if not 0.0 < t1 < t2:
        raise ValueError("need 0 < outer_maturity < inner_maturity")
    # critical spot s* at t1: BS(s*, t2-t1, k2) = k1
    lo, hi = 1e-8, s * 50.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if black_scholes_option_value(mid, r, sig, t2 - t1, k2) < k1:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-12 * max(1.0, mid):
            break
    s_star = 0.5 * (lo + hi)
    sq1, sq2 = sig * math.sqrt(t1), sig * math.sqrt(t2)
    a1 = (math.log(s / s_star) + (r + 0.5 * sig**2) * t1) / sq1
    a2 = a1 - sq1
    b1 = (math.log(s / k2) + (r + 0.5 * sig**2) * t2) / sq2
    b2 = b1 - sq2
    rho = math.sqrt(t1 / t2)
    return (s * bivariate_normal_cdf(a1, b1, rho)
            - k2 * math.exp(-r * t2) * bivariate_normal_cdf(a2, b2, rho)
            - k1 * math.exp(-r * t1) * _norm_cdf(a2))


def chooser_option_value(initial_value: float, risk_free_rate: float,
                         volatility: float, choice_time: float,
                         maturity: float, strike: float) -> float:
    """Simple chooser: at ``choice_time`` the holder picks the call or
    the put (same strike/maturity). Parity decomposition:
    chooser = call(K, T) + put(K e^{-r(T-t1)}, t1)."""
    if not 0.0 < choice_time < maturity:
        raise ValueError("need 0 < choice_time < maturity")
    return (black_scholes_option_value(
        initial_value, risk_free_rate, volatility, maturity, strike)
        + black_scholes_option_value(
            initial_value, risk_free_rate, volatility, choice_time,
            strike * math.exp(-risk_free_rate * (maturity - choice_time)),
            is_call=False))


# ---------------------------------------------------------------------------
# Monte-Carlo payoffs
# ---------------------------------------------------------------------------

def _forward_start_kernel(s_t1, s_t2, df: float, moneyness, is_call: bool,
                          mesh=None):
    sign = 1.0 if is_call else -1.0
    # s_t2 - moneyness * s_t1 with one rounding (an FMA), as XLA contracts
    # the JAX function's multiply-add
    gap = torch.addcmul(s_t2, s_t1, moneyness.expand_as(s_t1), value=-1.0)
    pay = torch.clamp_min(sign * gap, 0.0)
    return _mean_and_stderr(pay.to(ACC_DTYPE) * df, mesh)


def _cliquet_kernel(assets_with_s0, df: float, floor, cap, notional: float,
                    mesh=None):
    ratios = assets_with_s0[1:] / assets_with_s0[:-1] - 1.0
    clipped = torch.clamp(ratios, floor, cap).to(ACC_DTYPE)
    pay = torch.sum(clipped, dim=0) * notional
    return _mean_and_stderr(pay * df, mesh)


def _bs_value_vec(s, r, sigma, tau, k, is_call):
    """Pathwise Black-Scholes value (float32 vector math). ``r``,
    ``sigma``, ``tau`` are floats; ``k`` a float or a float32 0-dim tensor
    (then ``k * exp(-r tau)`` is a float32 product, as in the JAX
    function)."""
    sq = sigma * math.sqrt(tau)
    d1 = (torch.log(s / k) + (r + 0.5 * sigma * sigma) * tau) / sq
    d2 = d1 - sq
    sqrt2 = math.sqrt(2.0)
    nd1 = 0.5 * (1.0 + torch.erf(d1 / sqrt2))
    nd2 = 0.5 * (1.0 + torch.erf(d2 / sqrt2))
    call = s * nd1 - k * math.exp(-r * tau) * nd2
    if is_call:
        return call
    return call - s + k * math.exp(-r * tau)


def _compound_kernel(s_t1, df1: float, k1, r: float, sigma: float,
                     tau: float, k2: float, is_call_inner: bool, mesh=None):
    inner = _bs_value_vec(s_t1, r, sigma, tau, k2, is_call_inner)
    pay = torch.clamp_min(inner - k1, 0.0)
    return _mean_and_stderr(pay.to(ACC_DTYPE) * df1, mesh)


def _chooser_kernel(s_t1, df1: float, k, r: float, sigma: float,
                    tau: float, mesh=None):
    call = _bs_value_vec(s_t1, r, sigma, tau, k, True)
    put = call - s_t1 + k * math.exp(-r * tau)
    pay = torch.maximum(call, put)
    return _mean_and_stderr(pay.to(ACC_DTYPE) * df1, mesh)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

class ForwardStartOption(_Product):
    """Strike fixes at ``moneyness * S(start_time)``; pays at
    ``maturity``. Model-generic MC; Rubinstein closed form under BS."""

    def __init__(self, start_time: float, maturity: float,
                 moneyness: float = 1.0, is_call: bool = True):
        if not 0.0 < start_time < maturity:
            raise ValueError("need 0 < start_time < maturity")
        self.start_time = float(start_time)
        self.maturity = float(maturity)
        self.moneyness = float(moneyness)
        self.is_call = bool(is_call)

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        assets = model.get_asset_values([self.start_time, self.maturity])
        df = float(_deterministic_dfs(model, [self.maturity])[0])
        return _forward_start_kernel(assets[0], assets[1], df,
                                     _f32(self.moneyness, assets),
                                     self.is_call, _mesh_of(model))


class CliquetOption(_Product):
    """Locally collared cliquet: pays
    notional * sum_i clip(S(t_i)/S(t_{i-1}) - 1, floor, cap) at the
    last reset (ratchet without global floor). Exact closed form under
    BS via the per-period forward-start decomposition."""

    def __init__(self, reset_times: Sequence[float], floor: float,
                 cap: float, notional: float = 1.0):
        self.reset_times = [float(t) for t in reset_times]
        if (sorted(self.reset_times) != self.reset_times
                or not self.reset_times or self.reset_times[0] <= 0.0):
            raise ValueError("reset_times must be ascending, positive")
        if not floor <= cap:
            raise ValueError("floor must be <= cap")
        self.floor = float(floor)
        self.cap = float(cap)
        self.notional = float(notional)

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        assets = model.get_asset_values(self.reset_times)
        df = float(_deterministic_dfs(model, [self.reset_times[-1]])[0])
        return _cliquet_kernel(
            _with_spot_row(assets, _spot_of(model)), df,
            _f32(self.floor, assets), _f32(self.cap, assets), self.notional,
            _mesh_of(model))


class CompoundOption(_Product):
    """Call on a European option (Geske): at ``outer_maturity`` pay
    ``outer_strike`` for the (inner_strike, inner_maturity) option.
    The inner value is the Black-Scholes closed form evaluated
    pathwise, so the facade must be Black-Scholes."""

    def __init__(self, outer_maturity: float, outer_strike: float,
                 inner_maturity: float, inner_strike: float,
                 inner_is_call: bool = True):
        if not 0.0 < outer_maturity < inner_maturity:
            raise ValueError("need 0 < outer_maturity < inner_maturity")
        self.t1 = float(outer_maturity)
        self.k1 = float(outer_strike)
        self.t2 = float(inner_maturity)
        self.k2 = float(inner_strike)
        self.inner_is_call = bool(inner_is_call)

    def _bs(self, model):
        return _black_scholes_of(
            model, "compound/chooser valuation closes the inner option in "
                   "Black-Scholes form; use a Black-Scholes facade")

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device. The payoff
        reads ``model.get_asset_value(t1).values``: on a meshed facade
        this rank's block of the paths, whose statistics are then
        reduced over the ranks."""
        bs = self._bs(model)
        s_t1 = model.get_asset_value(self.t1).values
        df1 = float(_deterministic_dfs(model, [self.t1])[0])
        return _compound_kernel(
            s_t1, df1, _f32(self.k1, s_t1), float(bs.risk_free_rate),
            float(bs.volatility), self.t2 - self.t1, self.k2,
            self.inner_is_call, _mesh_of(model))


# ---------------------------------------------------------------------------
# autocallables
# ---------------------------------------------------------------------------

def autocallable_value_single_observation(
        initial_value: float, risk_free_rate: float, volatility: float,
        observation_time: float, maturity: float,
        autocall_level: float, coupon1: float,
        final_coupon_level: float, final_coupon: float,
        protection_level: float,
        reference_level: Optional[float] = None) -> float:
    """Exact value of the two-date express certificate under
    Black-Scholes (the closed-form oracle for ``AutocallableNote``):
    at t1, if S(t1) >= autocall_level redeem 1 + coupon1; else at T pay
    (1 + final_coupon) if S(T) >= final_coupon_level, 1 if
    protection_level <= S(T) < final_coupon_level, and
    S(T)/reference_level below the protection barrier. All four legs
    are lognormal rectangle probabilities through the Gauss-Legendre
    bivariate normal CDF (lower-tail convention; correlation
    sqrt(t1/T) between the log-spots)."""
    from .multi_asset import bivariate_normal_cdf
    s, r, sig = initial_value, risk_free_rate, volatility
    t1, t2 = float(observation_time), float(maturity)
    ref = float(reference_level if reference_level is not None
                else initial_value)
    if not 0.0 < t1 < t2:
        raise ValueError("need 0 < observation_time < maturity")
    if not protection_level <= final_coupon_level:
        raise ValueError("need protection_level <= final_coupon_level")

    def h(level, t, shift=0.0):
        # lower-tail standardization: P(S_t < level) = N(h(level, t))
        return ((math.log(level / s) - (r - 0.5 * sig * sig) * t)
                / (sig * math.sqrt(t)) - shift * sig * math.sqrt(t))

    rho = math.sqrt(t1 / t2)
    df1, df2 = math.exp(-r * t1), math.exp(-r * t2)
    h1 = h(autocall_level, t1)
    # leg 1: called at t1
    value = (1.0 + coupon1) * df1 * (1.0 - _norm_cdf(h1))
    # leg 2: alive, S_T >= final_coupon_level
    p_alive_above = _norm_cdf(h1) - bivariate_normal_cdf(
        h1, h(final_coupon_level, t2), rho)
    value += (1.0 + final_coupon) * df2 * p_alive_above
    # leg 3: alive, protection <= S_T < final_coupon_level
    p_mid = (bivariate_normal_cdf(h1, h(final_coupon_level, t2), rho)
             - bivariate_normal_cdf(h1, h(protection_level, t2), rho))
    value += df2 * p_mid
    # leg 4: alive, S_T < protection: pay S_T / ref (share-measure shift)
    e_s = s * math.exp(r * t2) * bivariate_normal_cdf(
        h(autocall_level, t1, shift=1.0),
        h(protection_level, t2, shift=1.0), rho)
    value += df2 * e_s / ref
    return value


def _autocall_kernel(assets, dfs, autocall_levels, coupon_levels, coupons,
                     protection_level, ref_level, notional: float,
                     memory: bool, mesh=None):
    """A branchless sweep over the (small) observation schedule carrying
    the alive mask and the unpaid-memory accumulator per path. The levels,
    coupons, protection and reference level are floats rounded to float32
    (the JAX function's float32 arrays); ``dfs`` float64 floats."""
    num_dates, paths = assets.shape
    alive = torch.ones(paths, dtype=assets.dtype, device=assets.device)
    mem = torch.zeros_like(alive)
    acc = torch.zeros(paths, dtype=ACC_DTYPE, device=assets.device)
    for i in range(num_dates):
        s_i = assets[i]
        coup_hit = (s_i >= coupon_levels[i]).to(assets.dtype)
        pay_c = alive * coup_hit * (coupons[i] + mem)
        if memory:
            mem = torch.where(coup_hit > 0.0, 0.0, mem + coupons[i])
        if i < num_dates - 1:
            call_hit = (s_i >= autocall_levels[i]).to(assets.dtype)
            pay = pay_c + alive * call_hit
            alive = alive * (1.0 - call_hit)
        else:
            principal = torch.where(s_i >= protection_level, 1.0,
                                    s_i / ref_level)
            pay = pay_c + alive * principal
        acc = acc + dfs[i] * pay.to(ACC_DTYPE)
    return _mean_and_stderr(acc * notional, mesh)


class AutocallableNote(_Product):
    """Autocallable (express / Phoenix) certificate on any equity facade.

    On each observation date t_i before maturity: if
    S(t_i) >= autocall_levels[i], the note redeems at notional plus the
    date's coupon. A coupon (Phoenix style) is paid whenever
    S(t_i) >= coupon_levels[i] while the note is alive; with
    ``memory=True`` missed coupons accumulate and pay on the next coupon
    event. At maturity, if never called: notional back above
    ``protection_level``, ``S_T / reference_level`` participation below
    it (short down-and-in put), plus the final coupon condition.

    The express certificate (no separate coupon barrier) is
    ``coupon_levels == autocall_levels`` with ``memory=False``; its
    two-date case has the exact closed form
    ``autocallable_value_single_observation``."""

    def __init__(self, observation_dates: Sequence[float],
                 autocall_levels: Sequence[float],
                 coupons: Sequence[float],
                 protection_level: float,
                 coupon_levels: Optional[Sequence[float]] = None,
                 reference_level: Optional[float] = None,
                 memory: bool = False, notional: float = 1.0):
        self.dates = [float(t) for t in observation_dates]
        if (sorted(self.dates) != self.dates or len(self.dates) < 2
                or self.dates[0] <= 0.0):
            raise ValueError(
                "observation_dates must be ascending, positive, and "
                "include the maturity (>= 2 dates)")
        m = len(self.dates)
        self.autocall_levels = [float(x) for x in autocall_levels]
        self.coupons = [float(x) for x in coupons]
        self.coupon_levels = ([float(x) for x in coupon_levels]
                              if coupon_levels is not None
                              else list(self.autocall_levels))
        if not (len(self.autocall_levels) == len(self.coupons)
                == len(self.coupon_levels) == m):
            raise ValueError("schedule arrays must match the dates")
        self.protection_level = float(protection_level)
        self.reference_level = reference_level
        self.memory = bool(memory)
        self.notional = float(notional)

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        assets = model.get_asset_values(self.dates)
        dfs = [float(x) for x in _deterministic_dfs(model, self.dates)]
        ref = (self.reference_level if self.reference_level is not None
               else _spot_of(model))

        def f32(xs):
            return [float(x) for x in np.asarray(xs, dtype=np.float32)]

        return _autocall_kernel(
            assets, dfs, f32(self.autocall_levels), f32(self.coupon_levels),
            f32(self.coupons), f32([self.protection_level])[0],
            f32([ref])[0], self.notional, self.memory, _mesh_of(model))


class ChooserOption(_Product):
    """Simple chooser: at ``choice_time`` the holder takes the call or
    the put with the same strike/maturity (valued in closed form
    pathwise; Black-Scholes facade required)."""

    def __init__(self, choice_time: float, maturity: float,
                 strike: float):
        if not 0.0 < choice_time < maturity:
            raise ValueError("need 0 < choice_time < maturity")
        self.t1 = float(choice_time)
        self.maturity = float(maturity)
        self.strike = float(strike)

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device. The payoff
        reads ``model.get_asset_value(choice_time).values``: on a meshed
        facade this rank's block of the paths, whose statistics are then
        reduced over the ranks."""
        bs = _black_scholes_of(
            model, "chooser valuation closes the branches in Black-Scholes "
                   "form; use a Black-Scholes facade")
        s_t1 = model.get_asset_value(self.t1).values
        df1 = float(_deterministic_dfs(model, [self.t1])[0])
        return _chooser_kernel(
            s_t1, df1, _f32(self.strike, s_t1), float(bs.risk_free_rate),
            float(bs.volatility), self.maturity - self.t1, _mesh_of(model))
