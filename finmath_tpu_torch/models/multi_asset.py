"""Multi-asset (correlated) Black-Scholes model and rainbow products:
exchange (Margrabe), best-of/worst-of (Stulz), basket, spread (Kirk).

Counterpart of ``finmath_tpu.models.multi_asset`` (finmath-lib's
``MultiAssetBlackScholesModel``: a vector of initial values and factor
loadings vol x Cholesky(correlation), with the ``ExchangeOption``
product). The model runs through the port's ``EulerScheme``: each step's
diffusion is the float32 ``[assets, factors, paths]`` loading times the
step's ``[factors, paths]`` increments, summed over the factors (no matrix
product, so TF32 never enters). The log-space Euler step is exact for GBM
at every grid point.

A rainbow product reads one ``[assets, paths]`` gather at its maturity
(``get_all_asset_values``) and reduces on the device to a packed ``[2]``
float64 (value, standard error); ``get_value_and_error`` copies it to the
host once.

Closed forms (host float64, as in the JAX package): Margrabe (1978)
exchange, Stulz (1982) two-asset min/max through a 128-node
Gauss-Legendre bivariate normal CDF, the exact geometric basket, and the
Kirk (1995) spread approximation.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from .analytic import _norm_cdf, black_scholes_option_value
from .brownian_motion import BrownianMotion
from .equity_products import _f32, _mean_and_stderr, _mesh_of, _Product
from .process import EulerScheme, ProcessModel
from .time_discretization import TimeDiscretization


class MultiAssetBlackScholesModel(ProcessModel):
    """d correlated geometric Brownian motions under the risk-neutral
    measure (finmath's MultiAssetBlackScholesModel): asset i has initial
    value S0_i, volatility sigma_i and instantaneous correlation rho_ij;
    the factor loadings are sigma_i * chol(rho)_i, formed in float64 and
    rounded to float32. Simulated in log space (exact at grid points)."""

    def __init__(self, initial_values: Sequence[float],
                 risk_free_rate: float, volatilities: Sequence[float],
                 correlation):
        self.initial_values = tuple(float(s) for s in initial_values)
        self.risk_free_rate = float(risk_free_rate)
        self.volatilities = tuple(float(v) for v in volatilities)
        corr = np.asarray(correlation, dtype=np.float64)
        d = len(self.initial_values)
        if len(self.volatilities) != d or corr.shape != (d, d):
            raise ValueError(
                "initial_values, volatilities and correlation must agree "
                f"on the asset count (got {d}, {len(self.volatilities)}, "
                f"{corr.shape})")
        if not np.allclose(corr, corr.T, atol=1e-12):
            raise ValueError("correlation must be symmetric")
        if not np.allclose(np.diag(corr), 1.0, atol=1e-12):
            raise ValueError("correlation must have unit diagonal")
        # chol raises on non-PSD, the honest failure mode
        chol = np.linalg.cholesky(corr)
        self.correlation = corr
        self._loadings = np.asarray(
            np.diag(self.volatilities) @ chol, dtype=np.float64)
        self._mu = np.asarray([self.risk_free_rate - 0.5 * v * v
                               for v in self.volatilities])[:, None]
        self._on_device = {}

    def _constants(self, device) -> tuple:
        """(drift [d, 1], loadings [d, d, 1]) float32 on ``device``, made
        once a device."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = (
                torch.as_tensor(self._mu, dtype=FLOAT_DTYPE).to(device),
                torch.as_tensor(self._loadings, dtype=FLOAT_DTYPE)[
                    :, :, None].to(device))
        return self._on_device[key]

    # -- ProcessModel interface (log coordinates) --
    def get_number_of_components(self) -> int:
        return len(self.initial_values)

    def get_number_of_factors(self) -> int:
        return len(self.initial_values)

    def initial_state(self, num_paths: int, device=None) -> torch.Tensor:
        logs0 = np.log(np.asarray(self.initial_values))[:, None]
        return torch.as_tensor(logs0, dtype=FLOAT_DTYPE).to(device).expand(
            len(self.initial_values), num_paths)

    def drift(self, time_index, state) -> torch.Tensor:
        return self._constants(state.device)[0].expand_as(state)

    def factor_loadings(self, time_index, state) -> torch.Tensor:
        lam = self._constants(state.device)[1]
        return lam.expand(lam.shape[:2] + (state.shape[-1],))

    def apply_state_space_transform(self, component: int,
                                    x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x)

    def numeraire(self, time: float) -> RandomVariableTorch:
        return RandomVariableTorch(0.0, math.exp(self.risk_free_rate * time))

    def __hash__(self):
        return hash((self.initial_values, self.risk_free_rate,
                     self.volatilities, self.correlation.tobytes()))

    def __eq__(self, other):
        return (isinstance(other, MultiAssetBlackScholesModel)
                and self.initial_values == other.initial_values
                and self.risk_free_rate == other.risk_free_rate
                and self.volatilities == other.volatilities
                and np.array_equal(self.correlation, other.correlation))


class MonteCarloMultiAssetBlackScholesModel:
    """Simulation facade over the correlated GBM vector, with
    MonteCarloBlackScholesModel's surface plus the ``[assets, paths]``
    gather the rainbow products read. Without ``brownian``, the increments
    are drawn on ``device`` (default ``select_device()``) from ``seed``.
    ``mesh``: a ``parallel.PathMesh`` (``EulerScheme``): each rank
    simulates its block of the paths and the products' means are global."""

    def __init__(self, time_discretization: TimeDiscretization,
                 num_paths: int, model: MultiAssetBlackScholesModel,
                 seed: int = 3141, brownian=None, mesh=None, device=None):
        if device is None and mesh is not None:
            device = getattr(mesh, "device", None)
        self.model = model
        self.brownian = brownian or BrownianMotion(
            time_discretization, model.get_number_of_factors(),
            num_paths, seed, device=device)
        self.process = EulerScheme(model, self.brownian, mesh=mesh,
                                   device=device)
        self.mesh = self.process.mesh

    def get_asset_value(self, time: float,
                        asset_index: int = 0) -> RandomVariableTorch:
        ti = self.process.time_discretization.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return self.process.get_process_value(ti, asset_index)

    def get_asset_values(self, times, asset_index: int = 0) -> torch.Tensor:
        from .black_scholes import MonteCarloBlackScholesModel

        return MonteCarloBlackScholesModel.get_asset_values(
            self, times, asset_index)

    def get_all_asset_values(self, time: float) -> torch.Tensor:
        """[assets, paths] at one date: one gather and one ``exp``."""
        ti = self.process.time_discretization.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return torch.exp(self.process._lazy_states()[ti])

    def get_numeraire(self, time: float) -> RandomVariableTorch:
        return self.model.numeraire(time)

    def get_number_of_paths(self) -> int:
        return self.process.get_number_of_paths()

    getAssetValue = get_asset_value
    getNumeraire = get_numeraire
    getNumberOfPaths = get_number_of_paths


def _df(model, maturity: float) -> float:
    return float(model.get_numeraire(0.0).get_average()
                 / model.get_numeraire(maturity).get_average())


# ---------------------------------------------------------------------------
# Rainbow products (a few device operations over the [assets, paths] gather)
# ---------------------------------------------------------------------------

def _exchange_kernel(s1, s2, df: float, mesh=None):
    pay = torch.clamp_min(s1 - s2, 0.0)
    return _mean_and_stderr(pay.to(ACC_DTYPE) * df, mesh)


class ExchangeOption(_Product):
    """Pays max(S_a - S_b, 0) at maturity (finmath-lib
    ``products.ExchangeOption``); Margrabe (1978) is the oracle."""

    def __init__(self, maturity: float, asset_index_1: int = 0,
                 asset_index_2: int = 1):
        self.maturity = float(maturity)
        self.i1, self.i2 = int(asset_index_1), int(asset_index_2)

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        assets = model.get_all_asset_values(self.maturity)
        return _exchange_kernel(assets[self.i1], assets[self.i2],
                                _df(model, self.maturity), _mesh_of(model))


def _rainbow_kernel(assets, df: float, strike, on_max: bool, is_call: bool,
                    mesh=None):
    ext = torch.amax(assets, dim=0) if on_max else torch.amin(assets, dim=0)
    sign = 1.0 if is_call else -1.0
    pay = torch.clamp_min(sign * (ext - strike), 0.0)
    return _mean_and_stderr(pay.to(ACC_DTYPE) * df, mesh)


class RainbowOption(_Product):
    """European option on the best/worst of several assets:
    kind in {'call-on-max','call-on-min','put-on-max','put-on-min'}.
    The two-asset Stulz (1982) closed forms are the oracle."""

    _KINDS = ("call-on-max", "call-on-min", "put-on-max", "put-on-min")

    def __init__(self, maturity: float, strike: float, kind: str,
                 asset_indices: Optional[Sequence[int]] = None):
        if kind not in self._KINDS:
            raise ValueError(f"kind must be one of {self._KINDS}")
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.kind = kind
        self.asset_indices = (None if asset_indices is None
                              else [int(i) for i in asset_indices])

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        assets = model.get_all_asset_values(self.maturity)
        if self.asset_indices is not None:
            assets = torch.stack([assets[i] for i in self.asset_indices])
        return _rainbow_kernel(
            assets, _df(model, self.maturity), _f32(self.strike, assets),
            self.kind.endswith("max"), self.kind.startswith("call"),
            _mesh_of(model))


def _basket_kernel(assets, weights, df: float, strike: float,
                   is_call: bool, geometric: bool, mesh=None):
    w = weights[:, None]
    if geometric:
        basket = torch.exp(torch.sum(w * torch.log(assets.to(ACC_DTYPE)),
                                     dim=0))
    else:
        basket = torch.sum(w * assets.to(ACC_DTYPE), dim=0)
    sign = 1.0 if is_call else -1.0
    pay = torch.clamp_min(sign * (basket - strike), 0.0)
    return _mean_and_stderr(pay * df, mesh)


def _basket_cv_kernel(assets, weights, df: float, strike: float,
                      geo_value: float, is_call: bool, mesh=None):
    """Arithmetic basket with the exact geometric basket as control
    variate (the same construction as the Asian control variate)."""
    w = weights[:, None]
    a64 = assets.to(ACC_DTYPE)
    arith = torch.sum(w * a64, dim=0)
    geo = torch.exp(torch.sum(w * torch.log(a64), dim=0))
    sign = 1.0 if is_call else -1.0
    pay_a = torch.clamp_min(sign * (arith - strike), 0.0) * df
    pay_g = torch.clamp_min(sign * (geo - strike), 0.0) * df
    out = _mean_and_stderr(pay_a - pay_g, mesh)
    return torch.stack([out[0] + geo_value, out[1]])


class BasketOption(_Product):
    """European option on a weighted basket sum(w_i S_i(T)).
    ``average='geometric'`` prices the geometric basket (exactly
    lognormal: its closed form is the oracle and the control variate);
    ``control_variate='geometric'`` corrects the arithmetic payoff with
    it."""

    def __init__(self, maturity: float, weights: Sequence[float],
                 strike: float, is_call: bool = True,
                 average: str = "arithmetic",
                 control_variate: Optional[str] = None):
        if average not in ("arithmetic", "geometric"):
            raise ValueError("average must be 'arithmetic' or 'geometric'")
        if control_variate not in (None, "geometric"):
            raise ValueError("control_variate must be None or 'geometric'")
        if control_variate and average == "geometric":
            raise ValueError("the geometric payoff IS the control variate")
        self.maturity = float(maturity)
        self.weights = [float(w) for w in weights]
        if any(w <= 0 for w in self.weights):
            raise ValueError("basket weights must be positive")
        self.strike = float(strike)
        self.is_call = bool(is_call)
        self.average = average
        self.control_variate = control_variate

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        assets = model.get_all_asset_values(self.maturity)
        if assets.shape[0] != len(self.weights):
            raise ValueError(
                f"{len(self.weights)} weights for {assets.shape[0]} assets")
        df = _df(model, self.maturity)
        w = torch.stack([torch.full((), x, dtype=ACC_DTYPE,
                                    device=assets.device)
                         for x in self.weights])
        if self.control_variate == "geometric":
            m = model.model
            geo = geometric_basket_option_value(
                m.initial_values, m.risk_free_rate, m.volatilities,
                m.correlation, self.weights, self.maturity, self.strike,
                self.is_call)
            return _basket_cv_kernel(assets, w, df, self.strike, geo,
                                     self.is_call, _mesh_of(model))
        return _basket_kernel(assets, w, df, self.strike, self.is_call,
                              self.average == "geometric", _mesh_of(model))


def _spread_kernel(s1, s2, df: float, strike: float, mesh=None):
    pay = torch.clamp_min(s1.to(ACC_DTYPE) - s2.to(ACC_DTYPE) - strike, 0.0)
    return _mean_and_stderr(pay * df, mesh)


class SpreadOption(_Product):
    """Pays (S_a - S_b - K)+ at maturity. K=0 reduces to the exchange
    option (Margrabe exact); Kirk (1995) is the approximate oracle for
    K != 0."""

    def __init__(self, maturity: float, strike: float,
                 asset_index_1: int = 0, asset_index_2: int = 1):
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.i1, self.i2 = int(asset_index_1), int(asset_index_2)

    def packed_value_and_error(self, model) -> torch.Tensor:
        """[2] float64 (value, stderr) on the facade's device."""
        assets = model.get_all_asset_values(self.maturity)
        return _spread_kernel(assets[self.i1], assets[self.i2],
                              _df(model, self.maturity), self.strike,
                              _mesh_of(model))


# ---------------------------------------------------------------------------
# Closed-form oracles (host float64)
# ---------------------------------------------------------------------------

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(128)


def bivariate_normal_cdf(a: float, b: float, rho: float) -> float:
    """P(X <= a, Y <= b) for standard bivariate normals with
    correlation rho, by 128-point Gauss-Legendre quadrature of the
    Drezner-Wesolowsky identity
    M(a,b,rho) = Phi(a)Phi(b) + (1/2pi) int_0^rho f(r) dr
    (accurate to ~1e-12 for |rho| <= 0.999; the degenerate limits are
    handled exactly)."""
    a, b, rho = float(a), float(b), float(rho)
    if not -1.0 <= rho <= 1.0:
        raise ValueError("rho must be in [-1, 1]")
    if rho >= 1.0:
        return _norm_cdf(min(a, b))
    if rho <= -1.0:
        return max(0.0, _norm_cdf(a) + _norm_cdf(b) - 1.0)
    r = 0.5 * rho * (_GL_NODES + 1.0)          # map [-1,1] -> [0, rho]
    one_m = 1.0 - r * r
    integrand = np.exp(-(a * a + b * b - 2.0 * r * a * b)
                       / (2.0 * one_m)) / np.sqrt(one_m)
    # dr = (rho/2) dx carries the sign of rho
    return float(_norm_cdf(a) * _norm_cdf(b)
                 + 0.5 * rho * (_GL_WEIGHTS * integrand).sum()
                 / (2.0 * math.pi))


def margrabe_exchange_value(s1: float, s2: float, vol1: float, vol2: float,
                            rho: float, maturity: float) -> float:
    """Margrabe (1978): E[df (S1(T) - S2(T))+] = S1 N(d1) - S2 N(d2)
    with sigma^2 = vol1^2 + vol2^2 - 2 rho vol1 vol2 (rate-free)."""
    sig = math.sqrt(max(vol1**2 + vol2**2 - 2.0 * rho * vol1 * vol2, 0.0))
    if sig == 0.0 or maturity <= 0.0:
        return max(s1 - s2, 0.0)
    sq = sig * math.sqrt(maturity)
    d1 = (math.log(s1 / s2) + 0.5 * sq * sq) / sq
    return s1 * _norm_cdf(d1) - s2 * _norm_cdf(d1 - sq)


def stulz_rainbow_value(s1: float, s2: float, risk_free_rate: float,
                        vol1: float, vol2: float, rho: float,
                        maturity: float, strike: float,
                        kind: str) -> float:
    """Stulz (1982) two-asset rainbow closed forms, b = r:
    'call-on-min' directly; 'call-on-max' = C1 + C2 - call-on-min;
    puts via the rainbow parity p = c(K) - c(0) + K df."""
    r, t, k = float(risk_free_rate), float(maturity), float(strike)
    if kind not in RainbowOption._KINDS:
        raise ValueError(f"kind must be one of {RainbowOption._KINDS}")

    def call_on_min(kk: float) -> float:
        if kk <= 0.0:
            # (min - 0)+ = min = S2 - (S2 - S1)+:
            # df E[min] = s2 - margrabe(s2, s1)
            return s2 - margrabe_exchange_value(s2, s1, vol2, vol1,
                                                rho, t)
        sig = math.sqrt(max(vol1**2 + vol2**2 - 2.0 * rho * vol1 * vol2,
                            1e-300))
        sq = sig * math.sqrt(t)
        d = (math.log(s1 / s2) + 0.5 * sig**2 * t) / sq
        y1 = (math.log(s1 / kk) + (r + 0.5 * vol1**2) * t) \
            / (vol1 * math.sqrt(t))
        y2 = (math.log(s2 / kk) + (r + 0.5 * vol2**2) * t) \
            / (vol2 * math.sqrt(t))
        rho1 = (rho * vol2 - vol1) / sig
        rho2 = (rho * vol1 - vol2) / sig
        return (s1 * bivariate_normal_cdf(y1, -d, rho1)
                + s2 * bivariate_normal_cdf(y2, d - sq, rho2)
                - kk * math.exp(-r * t) * bivariate_normal_cdf(
                    y1 - vol1 * math.sqrt(t), y2 - vol2 * math.sqrt(t),
                    rho))

    s1, s2 = float(s1), float(s2)

    def call_on_max(kk: float) -> float:
        return (black_scholes_option_value(s1, r, vol1, t, kk)
                + black_scholes_option_value(s2, r, vol2, t, kk)
                - call_on_min(kk)) if kk > 0.0 else \
            (s1 + s2 - call_on_min(0.0))

    if kind == "call-on-min":
        return call_on_min(k)
    if kind == "call-on-max":
        return call_on_max(k)
    if kind == "put-on-min":
        return call_on_min(k) - call_on_min(0.0) + k * math.exp(-r * t)
    return call_on_max(k) - call_on_max(0.0) + k * math.exp(-r * t)


def geometric_basket_option_value(initial_values, risk_free_rate: float,
                                  volatilities, correlation, weights,
                                  maturity: float, strike: float,
                                  is_call: bool = True) -> float:
    """Exact closed form for the geometric basket prod S_i^{w_i}:
    a product of lognormals is lognormal with
    m = sum w_i (ln S0_i + (r - sigma_i^2/2) T), v = T w' Sigma w."""
    s0 = np.asarray(initial_values, dtype=np.float64)
    vol = np.asarray(volatilities, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    corr = np.asarray(correlation, dtype=np.float64)
    t, r, k = float(maturity), float(risk_free_rate), float(strike)
    cov = corr * np.outer(vol, vol)
    m = float(w @ (np.log(s0) + (r - 0.5 * vol**2) * t))
    v = float(w @ cov @ w) * t
    df = math.exp(-r * t)
    if v <= 0.0:
        g = math.exp(m)
        intr = max(g - k, 0.0) if is_call else max(k - g, 0.0)
        return df * intr
    sv = math.sqrt(v)
    d1 = (m - math.log(k) + v) / sv
    d2 = d1 - sv
    fwd = math.exp(m + 0.5 * v)
    if is_call:
        return df * (fwd * _norm_cdf(d1) - k * _norm_cdf(d2))
    return df * (k * _norm_cdf(-d2) - fwd * _norm_cdf(-d1))


def kirk_spread_approximation(s1: float, s2: float, risk_free_rate: float,
                              vol1: float, vol2: float, rho: float,
                              maturity: float, strike: float) -> float:
    """Kirk (1995) lognormal-ratio approximation for (S1 - S2 - K)+,
    b = r: Black'76 on F1 vs F2 + K e^{rT}-forwarded strike with the
    blended volatility. Exact at K = 0 (reduces to Margrabe)."""
    t, r, k = float(maturity), float(risk_free_rate), float(strike)
    f1 = s1 * math.exp(r * t)
    f2 = s2 * math.exp(r * t)
    fk = f2 + k
    a = f2 / fk
    sig = math.sqrt(max(vol1**2 - 2.0 * rho * vol1 * vol2 * a
                        + (vol2 * a) ** 2, 0.0))
    df = math.exp(-r * t)
    if sig <= 0.0 or t <= 0.0:
        return df * max(f1 - fk, 0.0)
    sq = sig * math.sqrt(t)
    d1 = (math.log(f1 / fk) + 0.5 * sq * sq) / sq
    return df * (f1 * _norm_cdf(d1) - fk * _norm_cdf(d1 - sq))
