"""Merton (1976) jump-diffusion equity model: a Monte-Carlo engine with
branchless Poisson jumps, the closed-form Poisson-mixture series pricer,
and surface calibration.

Counterpart of ``finmath_tpu.models.merton`` (finmath-lib's
``assetderivativevaluation.models.MertonModel`` and the Fourier
``MertonModel``).

* The series pricer and the calibration are host NumPy float64, copied
  unchanged; the calibration runs on the port's ``LevenbergMarquardt``.
* ``mc_merton_european_prices`` is a Python loop over the steps on
  ``[paths]`` tensors of the device. The Poisson count of a step is drawn
  by inverse CDF with a static cap: one float64 CDF over ``max_jumps``
  (``cumsum`` of ``exp(log_pmf)``, ``log_pmf`` taking a ``cumsum`` of
  ``log(k)``, the JAX order) and ``n = #{k : u > F(k)}`` on a
  ``[max_jumps, paths]`` comparison. Given ``n`` jumps the log-jump is
  exactly ``n a + b sqrt(n) Z``, so the scheme is exact in distribution at
  every grid point.
* The draws: ``normals=(z_d, z_j)`` and ``uniforms=``, each
  ``[steps, num_paths]`` float32 (``num_paths / 2`` mirrored when
  antithetic), the JAX kernel's shapes; without them, a ``torch.Generator``
  of the device seeded with ``seed``.
* ``MonteCarloMertonModel`` is the facade the equity products read; its
  ``_states`` is the ``[steps + 1, paths]`` float32 log history on its own
  grid. It has no ``EulerScheme``: the jumps are not a Brownian factor.

Precision as in the JAX package: paths float32 (``dtype=torch.float64``
runs the oracle on the same draws), the CDF, the counts' comparison and
the payoff means float64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from ..utils.config import select_device, to_device
from ._draws import draws, np_dtype, pack_prices, terminal_mean
from .analytic import black_scholes_option_value
from .heston import _central_difference_jacobian, _grid_rows
from .time_discretization import TimeDiscretization


@dataclass(frozen=True)
class MertonParams:
    """Merton jump-diffusion under the risk-neutral measure:

    dS/S- = (r - lam*kappa) dt + sigma dW + (Y - 1) dN

    with ``N`` a Poisson process of intensity ``lam = jump_intensity``,
    iid lognormal jump factors ``log Y ~ Normal(jump_size_mean,
    jump_size_std)`` and the martingale compensator ``kappa = E[Y] - 1
    = exp(a + b^2/2) - 1``."""

    initial_value: float
    risk_free_rate: float
    volatility: float
    jump_intensity: float
    jump_size_mean: float
    jump_size_std: float

    def __post_init__(self):
        if self.initial_value <= 0:
            raise ValueError("initial_value must be positive")
        if self.volatility <= 0:
            raise ValueError("volatility must be positive")
        if self.jump_intensity < 0:
            raise ValueError("jump_intensity must be >= 0")
        if self.jump_size_std < 0:
            raise ValueError("jump_size_std must be >= 0")

    @property
    def jump_compensator(self) -> float:
        """kappa = E[Y] - 1."""
        return math.expm1(self.jump_size_mean
                          + 0.5 * self.jump_size_std ** 2)


# ---------------------------------------------------------------------------
# closed form: Merton's Poisson-mixture series (exact for Europeans)
# ---------------------------------------------------------------------------

def merton_series_prices(params: MertonParams, maturity: float, strikes,
                         is_call: bool = True,
                         max_terms: int = 60) -> np.ndarray:
    """European option prices by Merton's conditioning series: given
    ``n`` jumps in [0, T] the terminal log price is Gaussian, so

    ``price = sum_n e^{-lam' T} (lam' T)^n / n! * BS(sigma_n, r_n)``

    with ``lam' = lam (1 + kappa)``, ``sigma_n^2 = sigma^2 + n b^2 / T``
    and ``r_n = r - lam kappa + n (a + b^2/2) / T``. Puts via put-call
    parity (exact)."""
    p = params
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    if maturity <= 0:
        raise ValueError("maturity must be positive")
    if np.any(strikes <= 0):
        raise ValueError("strikes must be positive")
    a, b, lam = p.jump_size_mean, p.jump_size_std, p.jump_intensity
    kappa = p.jump_compensator
    lam_p = lam * (1.0 + kappa)
    call = np.zeros_like(strikes)
    log_w = -lam_p * maturity  # log of e^{-lam' T} (lam' T)^n / n!
    for n in range(max_terms):
        sigma_n = math.sqrt(p.volatility ** 2 + n * b * b / maturity)
        r_n = (p.risk_free_rate - lam * kappa
               + n * (a + 0.5 * b * b) / maturity)
        w = math.exp(log_w)
        if w > 1e-18 or n == 0:
            # the lam' weight equals the Poisson probability times the
            # discount-rate shift e^{(r_n - r)T}
            bs = np.array([
                black_scholes_option_value(p.initial_value, r_n, sigma_n,
                                           maturity, k) for k in strikes])
            call += w * bs
        log_w += math.log(max(lam_p * maturity, 1e-300)) - math.log(n + 1)
        if lam_p * maturity == 0.0:
            break
    if is_call:
        return call
    df = math.exp(-p.risk_free_rate * maturity)
    return call - p.initial_value + strikes * df


# ---------------------------------------------------------------------------
# Monte-Carlo engine
# ---------------------------------------------------------------------------

def _poisson_cdf(lam_dt: torch.Tensor, max_jumps: int) -> torch.Tensor:
    """The float64 Poisson CDF F(k), k < ``max_jumps``, of each intensity
    in ``lam_dt`` (float64, any leading shape): ``[..., max_jumps]``, in
    the JAX order (a ``cumsum`` of ``log(k)`` inside ``log_pmf``, then a
    ``cumsum`` of ``exp(log_pmf)``)."""
    k = torch.arange(max_jumps, dtype=ACC_DTYPE, device=lam_dt.device)
    lam = lam_dt[..., None]
    log_pmf = (-lam + k * torch.log(torch.clamp_min(lam, 1e-300))
               - torch.cumsum(torch.log(torch.clamp_min(k, 1.0)), dim=0))
    return torch.cumsum(torch.exp(log_pmf), dim=-1)


def _poisson_icdf_branchless(u: torch.Tensor, lam_dt, max_jumps: int,
                             cdf: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Poisson counts by inverse CDF with a static cap:
    n = #{k : u > F(k)} on a ``[max_jumps, paths]`` comparison of the
    float64 uniforms ``u`` with the CDF (``cdf``, when the caller built it
    with ``_poisson_cdf``). int32 [paths]; exact up to the tail mass
    P[N > max_jumps]."""
    if cdf is None:
        cdf = _poisson_cdf(torch.as_tensor(lam_dt, dtype=ACC_DTYPE).to(
            u.device), max_jumps)
    return torch.sum(u[None, :] > cdf[:, None], dim=0, dtype=torch.int32)


def _jump_tail_guard(lam_dt: float, max_jumps: int) -> None:
    """Raise when a step's Poisson mass beyond the cap exceeds 1e-9."""
    k = np.arange(max_jumps + 1)
    log_pmf = -lam_dt + k * np.log(max(lam_dt, 1e-300)) \
        - np.cumsum(np.log(np.maximum(k, 1)))
    tail = 1.0 - np.exp(log_pmf).sum()
    if tail > 1e-9:
        raise ValueError(
            f"lam*dt = {lam_dt:.3g} leaves tail mass {tail:.2g} beyond "
            f"the jump cap {max_jumps}; raise num_steps or "
            "max_jumps_per_step")


def _mc_merton_kernel(blocks, num_paths: int, num_steps: int,
                      max_jumps: int, dtype, s0, r, sigma, lam, a, b,
                      maturity, strikes, device) -> np.ndarray:
    """The step loop on the mirrored blocks -> strike-vector payoffs ->
    float64 means. Returns ``[1 + K]``: ``[E[S_T] e^{-rT}, call
    prices...]`` in one host copy."""
    f = np_dtype(dtype)
    dt = maturity / num_steps
    kappa = math.expm1(a + 0.5 * b * b)
    drift = float(f((r - 0.5 * sigma * sigma - lam * kappa) * dt))
    sig_sqdt = float(f(sigma * math.sqrt(dt)))
    a_, b_ = float(f(a)), float(f(b))
    cdf = _poisson_cdf(torch.full((), lam * dt, dtype=ACC_DTYPE,
                                  device=device), max_jumps)
    z_d, z_j, u = blocks
    log_s = torch.full((num_paths,), float(np.log(f(s0))), dtype=dtype,
                       device=device)
    for i in range(num_steps):
        n = _poisson_icdf_branchless(u[i].to(ACC_DTYPE), None, max_jumps,
                                     cdf).to(dtype)
        # sum of n iid Normal(a, b) log jumps == Normal(n a, b sqrt(n))
        jump = n * a_ + b_ * torch.sqrt(n) * z_j[i].to(dtype)
        log_s = log_s + drift + sig_sqdt * z_d[i].to(dtype) + jump
    st = torch.exp(log_s)
    df = math.exp(-r * maturity)
    return pack_prices(st, strikes, df, (terminal_mean(st, df),))


def _merton_draws(normals, uniforms, shape, antithetic: bool, seed: int,
                  device) -> list:
    """``[z_d, z_j, u]`` mirrored: the caller's ``normals=(z_d, z_j)`` and
    ``uniforms=``, or drawn in that order from ``seed``."""
    given = None
    if normals is not None or uniforms is not None:
        if normals is None or uniforms is None:
            raise ValueError("inject both normals=(z_d, z_j) and uniforms=")
        given = (*normals, uniforms)
    return draws(given, ("normal", "normal", "uniform"), shape, antithetic,
                 seed, device, ("normals z_d", "normals z_j", "uniforms"))


def mc_merton_european_prices(params: MertonParams, maturity: float,
                              strikes, num_paths: int = 100_000,
                              num_steps: int = 16, seed: int = 3141,
                              antithetic: bool = False,
                              max_jumps_per_step: int = 16,
                              dtype=None, *, device=None, normals=None,
                              uniforms=None):
    """European call prices for a strike vector from one simulation on
    ``device`` (default ``select_device()``). Returns ``(prices [K],
    discounted_forward)`` — the forward must equal S0 up to MC error (the
    scheme is exact in distribution).

    ``dtype=torch.float64`` runs the float64 oracle on the same draws;
    ``normals=(z_d, z_j)`` and ``uniforms=`` inject them, each
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
    blocks = _merton_draws(normals, uniforms, (int(num_steps), half),
                           antithetic, seed, device)
    p = params
    out = _mc_merton_kernel(
        blocks, int(num_paths), int(num_steps), int(max_jumps_per_step),
        dtype, p.initial_value, p.risk_free_rate, p.volatility,
        p.jump_intensity, p.jump_size_mean, p.jump_size_std,
        float(maturity), strikes, device)
    return out[1:], float(out[0])


# ---------------------------------------------------------------------------
# object API facade (finmath MonteCarloAssetModel shape)
# ---------------------------------------------------------------------------

def _merton_path_history(blocks, num_paths: int, max_jumps: int, s0, r,
                         sigma, lam, a, b, dts: np.ndarray,
                         device) -> torch.Tensor:
    """The float32 log-price history ``[steps + 1, paths]`` on the grid of
    step sizes ``dts`` from the blocks ``[z_d, z_j, u]``, each ``[steps,
    paths]``."""
    f = np.float32
    kappa = math.expm1(a + 0.5 * b * b)
    mu = float(f(r - 0.5 * sigma * sigma - lam * kappa))
    sig, a_, b_ = float(f(sigma)), float(f(a)), float(f(b))
    steps = dts.shape[0]
    dt_f = dts.astype(np.float32)
    sq_dt = np.sqrt(dt_f)
    cdf = _poisson_cdf(to_device(lam * dts, ACC_DTYPE, device), max_jumps)
    z_d, z_j, u = blocks
    hist = torch.empty((steps + 1, num_paths), dtype=FLOAT_DTYPE,
                       device=device)
    log_s = torch.full((num_paths,), float(np.log(f(s0))),
                       dtype=FLOAT_DTYPE, device=device)
    hist[0] = log_s
    for i in range(steps):
        n = _poisson_icdf_branchless(u[i].to(ACC_DTYPE), None, max_jumps,
                                     cdf[i]).to(FLOAT_DTYPE)
        log_s = (log_s + float(f(mu) * dt_f[i]) + float(f(sig) * sq_dt[i])
                 * z_d[i] + n * a_ + b_ * torch.sqrt(n) * z_j[i])
        hist[i + 1] = log_s
    return hist


class MonteCarloMertonModel:
    """Simulation facade over the Merton dynamics: asset/numeraire
    accessors on a time grid for the equity products. It owns its path
    generator (the scheme of the pricing engine, exact in distribution at
    grid points), drawn on ``device`` (default ``select_device()``) from
    ``seed``, or from the caller's ``normals=(z_d, z_j)`` and
    ``uniforms=``, each ``[steps, num_paths]`` float32."""

    def __init__(self, time_discretization: TimeDiscretization,
                 num_paths: int, params: MertonParams, seed: int = 3141,
                 max_jumps_per_step: int = 16, *, device=None, normals=None,
                 uniforms=None):
        self.params = params
        self.time_discretization = time_discretization
        self.num_paths = int(num_paths)
        self.seed = int(seed)
        self.max_jumps_per_step = int(max_jumps_per_step)
        self.device = torch.device(device) if device is not None \
            else select_device()
        self._injected = (normals, uniforms)
        self._log_states: Optional[torch.Tensor] = None

    def _states(self) -> torch.Tensor:
        if self._log_states is None:
            p = self.params
            td = self.time_discretization
            shape = (td.get_number_of_time_steps(), self.num_paths)
            blocks = _merton_draws(*self._injected, shape, False, self.seed,
                                   self.device)
            self._log_states = _merton_path_history(
                blocks, self.num_paths, self.max_jumps_per_step,
                p.initial_value, p.risk_free_rate, p.volatility,
                p.jump_intensity, p.jump_size_mean, p.jump_size_std,
                np.asarray(td.get_step_sizes(), dtype=np.float64),
                self.device)
        return self._log_states

    def get_asset_value(self, time: float,
                        asset_index: int = 0) -> RandomVariableTorch:
        ti = self.time_discretization.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return RandomVariableTorch.of(
            self.time_discretization.get_time(ti),
            torch.exp(self._states()[ti]))

    def get_asset_values(self, times, asset_index: int = 0) -> torch.Tensor:
        """[len(times), paths] asset matrix: one gather of the history
        and one ``exp``."""
        rows = _grid_rows(self.time_discretization, times, self.device)
        return torch.exp(self._states()[rows])

    def get_numeraire(self, time: float) -> RandomVariableTorch:
        return RandomVariableTorch(
            time, math.exp(self.params.risk_free_rate * time))

    def get_number_of_paths(self) -> int:
        return self.num_paths

    getAssetValue = get_asset_value
    getNumeraire = get_numeraire
    getNumberOfPaths = get_number_of_paths


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MertonCalibrationResult:
    params: MertonParams
    rms_price_error: float
    iterations: int
    converged: bool


def _to_unconstrained(p: MertonParams) -> np.ndarray:
    return np.array([
        math.log(p.volatility), math.log(max(p.jump_intensity, 1e-12)),
        p.jump_size_mean, math.log(max(p.jump_size_std, 1e-12)),
    ])


def _from_unconstrained(y: np.ndarray, s0: float, r: float) -> MertonParams:
    y = np.clip(y, -30.0, 30.0)
    return MertonParams(
        initial_value=s0, risk_free_rate=r,
        volatility=math.exp(y[0]), jump_intensity=math.exp(y[1]),
        jump_size_mean=float(y[2]), jump_size_std=math.exp(y[3]),
    )


def calibrate_merton(s0: float, r: float,
                     maturities: Sequence[float],
                     strikes: Sequence[Sequence[float]],
                     target_prices: Sequence[Sequence[float]],
                     x0: Optional[MertonParams] = None,
                     max_iterations: int = 200,
                     accuracy: float = 1e-9) -> MertonCalibrationResult:
    """Calibrate (sigma, lam, a, b) to a European call surface by
    Levenberg-Marquardt on the exact series pricer (host float64,
    central-difference Jacobian). Positives are optimized in log; ``a``
    is free.

    ``strikes[i]``/``target_prices[i]`` belong to ``maturities[i]``."""
    from .calibration import LevenbergMarquardt

    if len(maturities) != len(strikes) or len(strikes) != len(target_prices):
        raise ValueError("maturities, strikes, target_prices must align")
    targets = np.concatenate(
        [np.asarray(p, dtype=np.float64) for p in target_prices])

    def residuals(y: np.ndarray) -> np.ndarray:
        p = _from_unconstrained(y, s0, r)
        rows = [merton_series_prices(p, t, k)
                for t, k in zip(maturities, strikes)]
        return np.concatenate(rows) - targets

    start = x0 or MertonParams(s0, r, volatility=0.2, jump_intensity=0.3,
                               jump_size_mean=-0.1, jump_size_std=0.2)
    lm = LevenbergMarquardt(residuals, _central_difference_jacobian(residuals),
                            max_iterations=max_iterations,
                            accuracy=accuracy,
                            lower_bound=-np.inf, upper_bound=np.inf)
    res = lm.run(_to_unconstrained(start))
    p = _from_unconstrained(res.parameters, s0, r)
    rms = float(np.sqrt(np.mean(residuals(res.parameters) ** 2)))
    return MertonCalibrationResult(params=p, rms_price_error=rms,
                                   iterations=res.iterations,
                                   converged=res.converged)
