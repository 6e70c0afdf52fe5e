"""Bates (1996) stochastic-volatility jump-diffusion: Heston variance plus
lognormal jumps in the asset.

Counterpart of ``finmath_tpu.models.bates`` (finmath-lib's Fourier
``BatesModel``):

    dS = (r - lam kappa_J) S dt + sqrt(V) S dW_S + (e^J - 1) S dN
    dV = kappa (theta - V) dt + xi sqrt(V) dW_V,  d<W_S,W_V> = rho dt
    J ~ Normal(a, b),  N ~ Poisson(lam),  kappa_J = e^{a + b^2/2} - 1

* The characteristic function (the Heston CF times the compensated
  compound-Poisson factor) and its Gil-Pelaez prices are host NumPy
  float64, copied unchanged.
* ``mc_bates_european_prices`` and ``MonteCarloBatesModel`` share one
  step function (``_bates_step``, the JAX ``_bates_step_factory``):
  full-truncation Heston Euler and the branchless Poisson jumps of the
  Merton engine (``merton._poisson_icdf_branchless``), a Python loop over
  the steps on ``[paths]`` tensors of the device.
* The draws: ``normals=(z1, z2, z_j)`` and ``uniforms=``, each
  ``[steps, num_paths]`` float32 (``num_paths / 2`` mirrored when
  antithetic), the JAX kernel's shapes; without them, a
  ``torch.Generator`` of the device seeded with ``seed``.

Precision as in the JAX step: the coefficients that the JAX step forms
from its float64 parameters (the asset drift, the correlated normal, the
variance drift and loading) are float64 and then rounded to the path
dtype; paths float32 (``dtype=torch.float64`` runs the oracle on the same
draws), the Poisson CDF and the payoff means float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from ..utils.config import select_device, to_device
from ._draws import draws, np_dtype, pack_prices, terminal_mean
from .fourier import CharacteristicFunction, european_call_from_cf, heston_cf
from .heston import HestonParams, _grid_rows
from .merton import _jump_tail_guard, _poisson_cdf, _poisson_icdf_branchless
from .time_discretization import TimeDiscretization


@dataclass(frozen=True)
class BatesParams:
    """Heston diffusion parameters plus the Merton jump triple."""

    initial_value: float
    risk_free_rate: float
    v0: float
    kappa: float
    theta: float
    xi: float
    rho: float
    jump_intensity: float
    jump_size_mean: float
    jump_size_std: float

    def __post_init__(self):
        # reuse the Heston validation (raises on bad diffusion params)
        _ = self.heston
        if self.jump_intensity < 0 or self.jump_size_std < 0:
            raise ValueError("need jump_intensity >= 0 and "
                             "jump_size_std >= 0")

    @property
    def heston(self) -> HestonParams:
        return HestonParams(self.initial_value, self.risk_free_rate,
                            self.v0, self.kappa, self.theta, self.xi,
                            self.rho)

    @property
    def jump_compensator(self) -> float:
        """kappa_J = E[e^J] - 1."""
        return math.expm1(self.jump_size_mean
                          + 0.5 * self.jump_size_std ** 2)


# ---------------------------------------------------------------------------
# characteristic function (host f64 complex — the pricing oracle)
# ---------------------------------------------------------------------------

def bates_cf(params: BatesParams, maturity: float) -> CharacteristicFunction:
    """phi(u) = E[e^{iu ln S_T}]: the Heston CF (already carrying the
    r-drift martingale) times the compensated compound-Poisson factor.
    phi(-i) = S0 e^{rT} survives the composition exactly — the jump
    factor is 1 at u = -i by construction."""
    h = heston_cf(params.heston, maturity)
    lam = params.jump_intensity
    a, b = params.jump_size_mean, params.jump_size_std
    kj = params.jump_compensator

    def cf(u):
        u = np.asarray(u, dtype=np.complex128)
        jump = lam * maturity * (np.exp(1j * u * a - 0.5 * b * b * u * u)
                                 - 1.0) - 1j * u * lam * kj * maturity
        return h(u) * np.exp(jump)
    return cf


def bates_characteristic_prices(params: BatesParams, maturity: float,
                                strikes, is_call: bool = True,
                                num_nodes: int = 512,
                                upper: float = 400.0) -> np.ndarray:
    """European prices by Gil-Pelaez inversion of the Bates CF, with
    the martingale drift assertion active."""
    return european_call_from_cf(
        bates_cf(params, maturity), params.risk_free_rate, maturity,
        strikes, is_call=is_call, num_nodes=num_nodes, upper=upper,
        initial_value=params.initial_value)


# ---------------------------------------------------------------------------
# the shared step and the Monte-Carlo engine
# ---------------------------------------------------------------------------

def _bates_step(log_s, v, z1, z2, z_j, u, cdf, dt: float, p: BatesParams,
                max_jumps: int, dtype):
    """One step of (log S, V): full-truncation Heston Euler and the
    branchless jumps of the float32 uniforms ``u`` against the float64
    Poisson ``cdf`` of ``lam dt``, on the float32 normals ``z1`` (the
    variance), ``z2`` and ``z_j`` (the jumps)."""
    f = np_dtype(dtype)
    kj = math.expm1(p.jump_size_mean + 0.5 * p.jump_size_std ** 2)
    rho_perp = math.sqrt(1.0 - p.rho * p.rho)
    z1 = z1.to(dtype)
    z2 = z2.to(dtype)
    dt_ = float(f(dt))
    sqrt_dt = float(np.sqrt(f(dt)))
    vp = torch.clamp_min(v, 0.0)                      # full truncation
    sqrt_vp = torch.sqrt(vp)
    n = _poisson_icdf_branchless(u.to(ACC_DTYPE), None, max_jumps,
                                 cdf).to(dtype)
    jump = n * float(f(p.jump_size_mean)) \
        + float(f(p.jump_size_std)) * torch.sqrt(n) * z_j.to(dtype)
    dw_v = z1 * sqrt_dt
    # the JAX step forms these from its float64 parameters: float64,
    # then rounded to the path dtype
    dw_s = (p.rho * z1.to(ACC_DTYPE)
            + rho_perp * z2.to(ACC_DTYPE)).to(dtype) * sqrt_dt
    mu_s = (p.risk_free_rate - p.jump_intensity * kj
            - 0.5 * vp.to(ACC_DTYPE)).to(dtype)
    log_s = log_s + mu_s * dt_ + sqrt_vp * dw_s + jump
    mu_v = (p.kappa * (p.theta - vp.to(ACC_DTYPE))).to(dtype)
    vol_v = (p.xi * sqrt_vp.to(ACC_DTYPE)).to(dtype)
    v = v + mu_v * dt_ + vol_v * dw_v
    return log_s, v


def _bates_draws(normals, uniforms, shape, antithetic: bool, seed: int,
                 device) -> list:
    """``[z1, z2, z_j, u]`` mirrored: the caller's ``normals=(z1, z2,
    z_j)`` and ``uniforms=`` (in [1e-7, 1 - 1e-7]), or drawn in that
    order from ``seed``."""
    given = None
    if normals is not None or uniforms is not None:
        if normals is None or uniforms is None:
            raise ValueError("inject both normals=(z1, z2, z_j) and "
                             "uniforms=")
        given = (*normals, uniforms)
    return draws(given, ("normal", "normal", "normal", "uniform"), shape,
                 antithetic, seed, device,
                 ("normals z1", "normals z2", "normals z_j", "uniforms"),
                 bounds={3: (1e-7, 1.0 - 1e-7)})


def _mc_bates_kernel(blocks, num_paths: int, num_steps: int,
                     max_jumps: int, dtype, p: BatesParams, maturity,
                     strikes, device) -> np.ndarray:
    """The step loop -> ``[2 + K]``: ``[E[S_T] e^{-rT}, E[V_T], call
    prices...]`` in one host copy."""
    f = np_dtype(dtype)
    dt = maturity / num_steps
    cdf = _poisson_cdf(torch.full((), p.jump_intensity * dt,
                                  dtype=ACC_DTYPE, device=device), max_jumps)
    log_s = torch.full((num_paths,), float(np.log(f(p.initial_value))),
                       dtype=dtype, device=device)
    v = torch.full((num_paths,), float(f(p.v0)), dtype=dtype, device=device)
    z1, z2, z_j, u = blocks
    for i in range(num_steps):
        log_s, v = _bates_step(log_s, v, z1[i], z2[i], z_j[i], u[i], cdf,
                               dt, p, max_jumps, dtype)
    st = torch.exp(log_s)
    df = math.exp(-p.risk_free_rate * maturity)
    return pack_prices(st, strikes, df, (
        terminal_mean(st, df), terminal_mean(torch.clamp_min(v, 0.0))))


def mc_bates_european_prices(params: BatesParams, maturity: float,
                             strikes, num_paths: int = 100_000,
                             num_steps: int = 64, seed: int = 3141,
                             antithetic: bool = False,
                             max_jumps_per_step: int = 16,
                             dtype=None, *, device=None, normals=None,
                             uniforms=None):
    """European call prices for a strike vector from one simulation on
    ``device`` (default ``select_device()``). Returns ``(prices [K],
    discounted_forward, expected_var)``; the forward must equal S0 up to
    MC error.

    ``dtype=torch.float64`` runs the float64 oracle on the same draws;
    ``normals=(z1, z2, z_j)`` and ``uniforms=`` inject them, each
    ``[num_steps, num_paths]`` float32 (``num_paths / 2`` when
    antithetic)."""
    if antithetic and num_paths % 2:
        raise ValueError("antithetic needs an even num_paths")
    _jump_tail_guard(params.jump_intensity * maturity / num_steps,
                     max_jumps_per_step)
    dtype = FLOAT_DTYPE if dtype is None else dtype
    device = torch.device(device) if device is not None else select_device()
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    half = num_paths // 2 if antithetic else num_paths
    blocks = _bates_draws(normals, uniforms, (int(num_steps), half),
                          antithetic, seed, device)
    out = _mc_bates_kernel(blocks, int(num_paths), int(num_steps),
                           int(max_jumps_per_step), dtype, params,
                           float(maturity), strikes, device)
    return out[2:], float(out[0]), float(out[1])


# ---------------------------------------------------------------------------
# object API facade (finmath MonteCarloAssetModel shape)
# ---------------------------------------------------------------------------

def _bates_path_history(blocks, num_paths: int, max_jumps: int,
                        p: BatesParams, dts: np.ndarray,
                        device) -> torch.Tensor:
    """The float32 log-price history ``[steps + 1, paths]`` on the grid of
    step sizes ``dts`` from the blocks ``[z1, z2, z_j, u]``."""
    steps = dts.shape[0]
    cdf = _poisson_cdf(to_device(p.jump_intensity * dts, ACC_DTYPE, device),
                       max_jumps)
    hist = torch.empty((steps + 1, num_paths), dtype=FLOAT_DTYPE,
                       device=device)
    log_s = torch.full((num_paths,), float(np.log(np.float32(
        p.initial_value))), dtype=FLOAT_DTYPE, device=device)
    v = torch.full((num_paths,), float(np.float32(p.v0)), dtype=FLOAT_DTYPE,
                   device=device)
    hist[0] = log_s
    z1, z2, z_j, u = blocks
    for i in range(steps):
        log_s, v = _bates_step(log_s, v, z1[i], z2[i], z_j[i], u[i], cdf[i],
                               float(dts[i]), p, max_jumps, FLOAT_DTYPE)
        hist[i + 1] = log_s
    return hist


class MonteCarloBatesModel:
    """``MonteCarloBlackScholesModel`` surface over Bates dynamics, so the
    equity products price under stochastic vol and jumps unchanged. The
    paths are drawn on ``device`` (default ``select_device()``) from
    ``seed``, or from the caller's ``normals=(z1, z2, z_j)`` and
    ``uniforms=``, each ``[steps, num_paths]`` float32."""

    def __init__(self, time_discretization: TimeDiscretization,
                 num_paths: int, params: BatesParams, seed: int = 3141,
                 max_jumps_per_step: int = 16, *, device=None, normals=None,
                 uniforms=None):
        self.params = params
        self._td = time_discretization
        self._num_paths = int(num_paths)
        self._seed = int(seed)
        self._max_jumps = int(max_jumps_per_step)
        dts = np.asarray(time_discretization.get_step_sizes(),
                         dtype=np.float64)
        _jump_tail_guard(params.jump_intensity * float(dts.max()),
                         self._max_jumps)
        self._dts = dts
        self.device = torch.device(device) if device is not None \
            else select_device()
        self._injected = (normals, uniforms)
        self._hist: Optional[torch.Tensor] = None

    @property
    def time_discretization(self) -> TimeDiscretization:
        return self._td

    def _states(self) -> torch.Tensor:
        if self._hist is None:
            blocks = _bates_draws(*self._injected,
                                  (self._dts.shape[0], self._num_paths),
                                  False, self._seed, self.device)
            self._hist = _bates_path_history(
                blocks, self._num_paths, self._max_jumps, self.params,
                self._dts, self.device)
        return self._hist

    def get_asset_value(self, time: float,
                        asset_index: int = 0) -> RandomVariableTorch:
        ti = self._td.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return RandomVariableTorch.of(time, torch.exp(self._states()[ti]))

    def get_asset_values(self, times, asset_index: int = 0) -> torch.Tensor:
        rows = _grid_rows(self._td, times, self.device)
        return torch.exp(self._states()[rows])

    def get_numeraire(self, time: float) -> RandomVariableTorch:
        return RandomVariableTorch(
            time, math.exp(self.params.risk_free_rate * time))

    def get_number_of_paths(self) -> int:
        return self._num_paths

    getAssetValue = get_asset_value
    getNumeraire = get_numeraire
    getNumberOfPaths = get_number_of_paths
