"""Heston stochastic-volatility equity model: Monte-Carlo engines
(full-truncation Euler and Andersen's Quadratic-Exponential scheme with the
martingale correction), the semi-analytic characteristic-function pricer,
and surface calibration.

Counterpart of ``finmath_tpu.models.heston`` (finmath-lib's
``assetderivativevaluation.models.HestonModel`` with its truncation
``Scheme``, and ``fouriermethod.models.HestonModel``).

* The characteristic-function pricer (Gatheral's P1/P2 form in the
  Albrecher et al. "little Heston trap" branch) and the calibration are
  host NumPy float64, copied unchanged; the calibration runs on the port's
  ``LevenbergMarquardt``.
* ``mc_heston_european_prices`` is a Python loop over the steps on
  ``[paths]`` tensors of the device (the JAX package fuses the same into
  one ``lax.scan``). The QE regime switch is branchless: both regimes are
  computed and ``torch.where`` selects. The strike vector is priced from
  the one terminal state; the forward, E[V_T] and the prices come back in
  one float64 tensor and one host copy.
* The draws: ``uniforms=`` and ``normals=`` (QE) or ``normals=(z1, z2)``
  (Euler), each ``[steps, num_paths]`` float32 (``num_paths / 2`` when
  antithetic: the engine mirrors them ``[u, 1 - u]`` and ``[z, -z]``), in
  the JAX kernel's shapes; without them, the engine draws from a
  ``torch.Generator`` of the device seeded with ``seed`` (torch's stream
  is not JAX's Threefry: the tests inject the JAX draws).
* ``HestonModel`` is a two-component, two-factor ``ProcessModel`` for the
  port's ``EulerScheme``; ``MonteCarloHestonModel`` its facade, so the
  equity products price under stochastic volatility unchanged.

Precision as in the JAX package: paths float32 (``dtype=torch.float64``
runs the oracle on the same draws), payoff means float64. The scalar
coefficients are rounded to the path dtype first, as the JAX kernel casts
its parameters, and every ``maximum(., 1e-30)`` guard is kept.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.random_variable import FLOAT_DTYPE, RandomVariableTorch
from ..utils.config import select_device, to_device
from ._draws import draws, np_dtype, pack_prices, terminal_mean
from .process import EulerScheme, ProcessModel
from .time_discretization import TimeDiscretization


@dataclass(frozen=True)
class HestonParams:
    """Heston dynamics under the risk-neutral measure:

    dS = r S dt + sqrt(V) S dW_S
    dV = kappa (theta - V) dt + xi sqrt(V) dW_V,   d<W_S, W_V> = rho dt

    ``theta`` is the long-run VARIANCE (not vol), ``v0`` the initial
    variance, ``xi`` the vol-of-vol."""

    initial_value: float
    risk_free_rate: float
    v0: float
    kappa: float
    theta: float
    xi: float
    rho: float

    def __post_init__(self):
        if self.initial_value <= 0:
            raise ValueError("initial_value must be positive")
        if min(self.v0, self.kappa, self.theta, self.xi) <= 0:
            raise ValueError("v0, kappa, theta, xi must be positive")
        if not -1.0 < self.rho < 1.0:
            raise ValueError("rho must lie in (-1, 1)")

    @property
    def feller_ratio(self) -> float:
        """2 kappa theta / xi^2 — >= 1 means the variance cannot reach 0."""
        return 2.0 * self.kappa * self.theta / (self.xi * self.xi)


# ---------------------------------------------------------------------------
# semi-analytic pricing via the characteristic function (host, f64 complex)
# ---------------------------------------------------------------------------

def _heston_pj(params: HestonParams, maturity: float, strikes: np.ndarray,
               j: int, nodes: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """P_j (j=1,2) of the Heston call formula by Gauss-Legendre quadrature
    of the Gatheral form, in the Albrecher et al. (2007) "little Heston
    trap" branch: with c = 1/g the complex log stays on the principal
    branch for all maturities, so no phase unwrapping is needed."""
    p = params
    x = math.log(p.initial_value)
    a = p.kappa * p.theta
    u_j = 0.5 if j == 1 else -0.5
    b_j = p.kappa - p.rho * p.xi if j == 1 else p.kappa

    phi = nodes.astype(np.complex128)                        # [Q]
    ixp = 1j * phi
    d = np.sqrt((p.rho * p.xi * ixp - b_j) ** 2
                - p.xi ** 2 * (2.0 * u_j * ixp - phi ** 2))
    # little-trap: c = (b - rho xi i phi - d) / (b - rho xi i phi + d)
    num = b_j - p.rho * p.xi * ixp - d
    den = b_j - p.rho * p.xi * ixp + d
    c = num / den
    e_dt = np.exp(-d * maturity)
    big_d = num / p.xi ** 2 * (1.0 - e_dt) / (1.0 - c * e_dt)
    big_c = (p.risk_free_rate * ixp * maturity
             + a / p.xi ** 2 * (num * maturity
                                - 2.0 * np.log((1.0 - c * e_dt)
                                               / (1.0 - c))))
    f = np.exp(big_c + big_d * p.v0 + ixp * x)               # [Q]
    lnk = np.log(np.asarray(strikes, dtype=np.float64))      # [K]
    integrand = np.real(
        np.exp(-np.outer(lnk, phi) * 1j) * (f / ixp)[None, :])  # [K, Q]
    return 0.5 + (integrand @ weights) / np.pi


def heston_characteristic_prices(params: HestonParams, maturity: float,
                                 strikes, is_call: bool = True,
                                 num_nodes: int = 256,
                                 upper: float = 400.0) -> np.ndarray:
    """European option prices by the Heston semi-closed formula:
    ``call = S0 P1 - K e^{-rT} P2`` with P1/P2 computed by ``num_nodes``
    point Gauss-Legendre quadrature on (0, ``upper``]. Puts via
    put-call parity (exact). The calibration oracle and the regression
    net of the MC engines."""
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    if maturity <= 0:
        raise ValueError("maturity must be positive")
    if np.any(strikes <= 0):
        raise ValueError("strikes must be positive")
    nodes, weights = np.polynomial.legendre.leggauss(int(num_nodes))
    nodes = 0.5 * (nodes + 1.0) * upper
    weights = 0.5 * upper * weights
    p1 = _heston_pj(params, maturity, strikes, 1, nodes, weights)
    p2 = _heston_pj(params, maturity, strikes, 2, nodes, weights)
    df = math.exp(-params.risk_free_rate * maturity)
    call = params.initial_value * p1 - strikes * df * p2
    if is_call:
        return call
    return call - params.initial_value + strikes * df


# ---------------------------------------------------------------------------
# Monte-Carlo engines
# ---------------------------------------------------------------------------

_QE_PSI_C = 1.5  # Andersen's regime switch threshold


def _qe_constants(f, r, v0, kappa, theta, xi, rho, dt):
    """Andersen's per-step constants (eqs. 17-27, 33-39) in the path
    dtype's NumPy scalar type ``f``, in the JAX kernel's order."""
    rr, kappa, theta, xi, rho = f(r), f(kappa), f(theta), f(xi), f(rho)
    dt_ = f(dt)
    e_kdt = np.exp(-kappa * dt_)
    c1 = xi * xi * e_kdt * (f(1.0) - e_kdt) / kappa
    c2 = theta * xi * xi * (f(1.0) - e_kdt) ** 2 / (f(2.0) * kappa)
    g1 = g2 = f(0.5)
    k0 = -rho * kappa * theta * dt_ / xi
    k1 = g1 * dt_ * (kappa * rho / xi - f(0.5)) - rho / xi
    k2 = g2 * dt_ * (kappa * rho / xi - f(0.5)) + rho / xi
    k3 = g1 * dt_ * (f(1.0) - rho * rho)
    k4 = g2 * dt_ * (f(1.0) - rho * rho)
    big_a = k2 + f(0.5) * k4
    return dict(theta=theta, e_kdt=e_kdt, c1=c1, c2=c2, k0=k0, k1=k1, k2=k2,
                k3=k3, k4=k4, big_a=big_a, r_dt=rr * dt_,
                k13=k1 + f(0.5) * k3)


def _qe_step(log_s, v, u, zs, c):
    """One Andersen QE-M step of (log S, V) on the uniforms ``u`` (the
    variance) and the normals ``zs`` (the asset), ``c`` the constants of
    ``_qe_constants`` as Python floats. Returns the new state."""
    theta, e_kdt = c["theta"], c["e_kdt"]
    m = theta + (v - theta) * e_kdt
    s2 = v * c["c1"] + c["c2"]
    psi = s2 / torch.clamp_min(m * m, 1e-30)
    # quadratic regime (psi <= psi_c): v' = a (b + Zv)^2
    psi_q = torch.clamp_max(psi, _QE_PSI_C)
    two_over = 2.0 / psi_q
    b2 = two_over - 1.0 + torch.sqrt(
        two_over * torch.clamp_min(two_over - 1.0, 0.0))
    a_q = m / (1.0 + b2)
    zv = torch.special.ndtri(u)
    b_q = torch.sqrt(b2)
    v_quad = a_q * (b_q + zv) ** 2
    # exponential regime (psi > psi_c): mass p at 0 + exp tail
    psi_e = torch.clamp_min(psi, _QE_PSI_C)
    p_mass = (psi_e - 1.0) / (psi_e + 1.0)
    m_floor = torch.clamp_min(m, 1e-30)
    beta = (1.0 - p_mass) / m_floor
    # log(.) / beta and x / sqrt(y) below are written as XLA's algebraic
    # simplifier compiles the JAX kernel: log(.) m / (1 - p) and
    # x * rsqrt(y)
    v_exp = torch.where(
        u <= p_mass, 0.0,
        torch.log((1.0 - p_mass) / torch.clamp_min(1.0 - u, 1e-30))
        * m_floor / (1.0 - p_mass))
    quad = psi <= _QE_PSI_C
    v_new = torch.where(quad, v_quad, v_exp)
    # martingale correction K0* (Andersen section 3.3)
    big_a = c["big_a"]
    one_m = 1.0 - 2.0 * big_a * a_q
    exp_m = torch.exp(big_a * b2 * a_q / one_m) \
        * torch.rsqrt(torch.clamp_min(one_m, 1e-30))
    exp_e = p_mass + beta * (1.0 - p_mass) \
        / torch.clamp_min(beta - big_a, 1e-30)
    k0_star = -torch.log(torch.where(quad, exp_m, exp_e)) - c["k13"] * v
    log_s = (log_s + c["r_dt"] + k0_star + c["k1"] * v + c["k2"] * v_new
             + torch.sqrt(torch.clamp_min(c["k3"] * v + c["k4"] * v_new,
                                          0.0)) * zs)
    return log_s, v_new


def _euler_step(log_s, v, z1, z2, c):
    """One full-truncation Euler step (Lord et al. 2010) on the normals
    ``z1`` (the variance) and ``z2``."""
    vp = torch.clamp_min(v, 0.0)
    sqrt_vp = torch.sqrt(vp)
    dw_v = z1 * c["sqrt_dt"]
    dw_s = (c["rho"] * z1 + c["rho_perp"] * z2) * c["sqrt_dt"]
    log_s = log_s + (c["r"] - 0.5 * vp) * c["dt"] + sqrt_vp * dw_s
    v = v + c["kappa"] * (c["theta"] - vp) * c["dt"] \
        + c["xi"] * sqrt_vp * dw_v
    return log_s, v


def _mc_heston_kernel(blocks, num_paths: int, num_steps: int, scheme: str,
                      dtype, s0, r, v0, kappa, theta, xi, rho, maturity,
                      strikes, device) -> np.ndarray:
    """The step loop on the mirrored blocks -> strike-vector payoffs ->
    float64 means. Returns ``[2 + K]``: ``[E[S_T] e^{-rT}, E[V_T], call
    prices...]`` in one host copy."""
    f = np_dtype(dtype)
    dt = maturity / num_steps
    log_s = torch.full((num_paths,), float(np.log(f(s0))), dtype=dtype,
                       device=device)
    v = torch.full((num_paths,), float(f(v0)), dtype=dtype, device=device)
    if scheme == "qe":
        c = {k: float(x) for k, x in _qe_constants(
            f, r, v0, kappa, theta, xi, rho, dt).items()}
        u_all, z_all = blocks
        for i in range(num_steps):
            log_s, v = _qe_step(log_s, v, u_all[i].to(dtype),
                                z_all[i].to(dtype), c)
    else:
        dt_ = f(dt)
        c = {k: float(x) for k, x in dict(
            r=f(r), kappa=f(kappa), theta=f(theta), xi=f(xi), rho=f(rho),
            rho_perp=np.sqrt(f(1.0) - f(rho) * f(rho)), dt=dt_,
            sqrt_dt=np.sqrt(dt_)).items()}
        z1_all, z2_all = blocks
        for i in range(num_steps):
            log_s, v = _euler_step(log_s, v, z1_all[i].to(dtype),
                                   z2_all[i].to(dtype), c)
    st = torch.exp(log_s)
    df = math.exp(-r * maturity)
    return pack_prices(st, strikes, df, (
        terminal_mean(st, df), terminal_mean(torch.clamp_min(v, 0.0))))


def mc_heston_european_prices(params: HestonParams, maturity: float,
                              strikes, num_paths: int = 100_000,
                              num_steps: int = 64, seed: int = 3141,
                              scheme: str = "qe",
                              antithetic: bool = False,
                              dtype=None, *, device=None, uniforms=None,
                              normals=None):
    """European call prices for a strike vector from one simulation on
    ``device`` (default ``select_device()``). Returns ``(prices [K],
    discounted_forward, expected_var)`` — the forward is the martingale
    diagnostic (must equal S0 up to MC error; the QE-M correction makes
    it exact in expectation).

    ``dtype=torch.float64`` runs the float64 oracle on the same draws.
    ``uniforms=`` and ``normals=`` (QE) or ``normals=(z1, z2)`` (Euler)
    inject the draws, each ``[num_steps, num_paths]`` float32
    (``num_paths / 2`` when antithetic)."""
    if antithetic and num_paths % 2:
        raise ValueError("antithetic needs an even num_paths")
    if scheme not in ("qe", "euler"):
        raise ValueError(f"unknown scheme {scheme!r}")
    dtype = FLOAT_DTYPE if dtype is None else dtype
    device = torch.device(device) if device is not None else select_device()
    strikes = np.atleast_1d(np.asarray(strikes, dtype=np.float64))
    half = num_paths // 2 if antithetic else num_paths
    shape = (int(num_steps), half)
    if scheme == "qe":
        given = None
        if uniforms is not None or normals is not None:
            if uniforms is None or normals is None:
                raise ValueError("the QE scheme needs both uniforms= and "
                                 "normals=")
            given = (uniforms, normals)
        blocks = draws(given, ("uniform", "normal"), shape, antithetic, seed,
                       device, ("uniforms", "normals"),
                       bounds={0: (1e-7, 1.0 - 1e-7)})
    else:
        if uniforms is not None:
            raise ValueError("the Euler scheme takes normals=(z1, z2) only")
        blocks = draws(normals, ("normal", "normal"), shape, antithetic,
                       seed, device, ("normals z1", "normals z2"))
    p = params
    out = _mc_heston_kernel(
        blocks, int(num_paths), int(num_steps), scheme, dtype,
        p.initial_value, p.risk_free_rate, p.v0, p.kappa, p.theta, p.xi,
        p.rho, float(maturity), strikes, device)
    return out[2:], float(out[0]), float(out[1])


# ---------------------------------------------------------------------------
# object API (finmath HestonModel + EulerSchemeFromProcessModel shape)
# ---------------------------------------------------------------------------

class HestonModel(ProcessModel):
    """Two-component ProcessModel (log S, V) with full-truncation drift
    and loadings — drive it with the shared ``EulerScheme`` exactly like
    ``BlackScholesModel``. Component 0 is the asset (exp transform),
    component 1 the variance; factor 0 drives the variance and the asset
    loads ``rho`` on it."""

    def __init__(self, params: HestonParams):
        self.params = params

    def get_number_of_components(self) -> int:
        return 2

    def get_number_of_factors(self) -> int:
        return 2

    def initial_state(self, num_paths: int, device=None) -> torch.Tensor:
        p = self.params
        return torch.stack([
            torch.full((num_paths,), math.log(p.initial_value),
                       dtype=FLOAT_DTYPE, device=device),
            torch.full((num_paths,), p.v0, dtype=FLOAT_DTYPE, device=device),
        ])

    def drift(self, time_index, state) -> torch.Tensor:
        p = self.params
        vp = torch.clamp_min(state[1], 0.0)
        return torch.stack([
            p.risk_free_rate - 0.5 * vp,
            p.kappa * (p.theta - vp),
        ])

    def factor_loadings(self, time_index, state) -> torch.Tensor:
        p = self.params
        sqrt_vp = torch.sqrt(torch.clamp_min(state[1], 0.0))
        rho_perp = math.sqrt(1.0 - p.rho * p.rho)
        zeros = torch.zeros_like(sqrt_vp)
        # factor 0 drives the variance; the asset sees rho of it
        return torch.stack([
            torch.stack([p.rho * sqrt_vp, rho_perp * sqrt_vp]),
            torch.stack([p.xi * sqrt_vp, zeros]),
        ])

    def apply_state_space_transform(self, component: int,
                                    x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x) if component == 0 else x

    def numeraire(self, time: float) -> RandomVariableTorch:
        return RandomVariableTorch(
            time, math.exp(self.params.risk_free_rate * time))

    @property
    def initial_value(self) -> float:
        return self.params.initial_value

    @property
    def risk_free_rate(self) -> float:
        return self.params.risk_free_rate

    def __hash__(self):
        return hash(self.params)

    def __eq__(self, other):
        return isinstance(other, HestonModel) and self.params == other.params


def _grid_rows(td: TimeDiscretization, times, device) -> torch.Tensor:
    """The grid indices of ``times`` as a long tensor on ``device``;
    an off-grid time raises."""
    idx = []
    for t in times:
        ti = td.get_time_index(t)
        if ti < 0:
            raise ValueError(f"time {t} not on the simulation grid")
        idx.append(ti)
    return to_device(idx, torch.long, device)


class MonteCarloHestonModel:
    """Simulation facade over the Heston ProcessModel through the shared
    ``EulerScheme`` (full truncation): the surface of
    ``MonteCarloBlackScholesModel``, so the equity products price under
    stochastic volatility unchanged. ``get_asset_values`` gathers the
    [dates, paths] matrix with one index; ``asset_index`` 1 gives the raw
    variance (no transform). Without ``brownian``, the increments are
    drawn on ``device`` (default: the mesh's, else ``select_device()``)
    from ``seed``. ``mesh``: a ``parallel.PathMesh`` (``EulerScheme``):
    each rank simulates its block of the same paths."""

    def __init__(self, time_discretization: TimeDiscretization,
                 num_paths: int, model, seed: int = 3141,
                 brownian=None, mesh=None, *, device=None):
        from .brownian_motion import BrownianMotion

        if device is None and mesh is not None:
            device = getattr(mesh, "device", None)
        if isinstance(model, HestonParams):
            model = HestonModel(model)
        self.model = model
        self.brownian = brownian or BrownianMotion(
            time_discretization, 2, num_paths, seed, device=device)
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
        states = self.process._lazy_states()
        rows = _grid_rows(self.process.time_discretization, times,
                          states.device)
        if asset_index == 0:
            return torch.exp(states[rows, 0])
        return states[rows, asset_index]

    def get_numeraire(self, time: float) -> RandomVariableTorch:
        return self.model.numeraire(time)

    def get_number_of_paths(self) -> int:
        return self.process.get_number_of_paths()

    getAssetValue = get_asset_value
    getNumeraire = get_numeraire
    getNumberOfPaths = get_number_of_paths


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HestonCalibrationResult:
    params: HestonParams
    rms_price_error: float
    iterations: int
    converged: bool


def _to_unconstrained(p: HestonParams) -> np.ndarray:
    return np.array([
        math.log(p.v0), math.log(p.kappa), math.log(p.theta),
        math.log(p.xi), math.atanh(p.rho),
    ])


def _from_unconstrained(y: np.ndarray, s0: float, r: float) -> HestonParams:
    y = np.clip(y, -30.0, 30.0)
    return HestonParams(
        initial_value=s0, risk_free_rate=r,
        v0=math.exp(y[0]), kappa=math.exp(y[1]), theta=math.exp(y[2]),
        xi=math.exp(y[3]), rho=math.tanh(np.clip(y[4], -7.0, 7.0)),
    )


def _central_difference_jacobian(residuals):
    """The calibrations' Jacobian: central differences with step 1e-6 in
    each unconstrained coordinate."""
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
    return jacobian


def calibrate_heston(s0: float, r: float,
                     maturities: Sequence[float],
                     strikes: Sequence[Sequence[float]],
                     target_prices: Sequence[Sequence[float]],
                     x0: Optional[HestonParams] = None,
                     max_iterations: int = 200,
                     accuracy: float = 1e-9) -> HestonCalibrationResult:
    """Calibrate (v0, kappa, theta, xi, rho) to a European call surface
    by Levenberg-Marquardt on the characteristic-function pricer (host
    float64, central-difference Jacobian), in an unconstrained chart (log
    for the positives, atanh for rho).

    ``strikes[i]``/``target_prices[i]`` belong to ``maturities[i]``."""
    from .calibration import LevenbergMarquardt

    if len(maturities) != len(strikes) or len(strikes) != len(target_prices):
        raise ValueError("maturities, strikes, target_prices must align")
    targets = np.concatenate(
        [np.asarray(p, dtype=np.float64) for p in target_prices])

    def residuals(y: np.ndarray) -> np.ndarray:
        p = _from_unconstrained(y, s0, r)
        rows = [heston_characteristic_prices(p, t, k)
                for t, k in zip(maturities, strikes)]
        return np.concatenate(rows) - targets

    start = x0 or HestonParams(s0, r, v0=0.04, kappa=1.0, theta=0.04,
                               xi=0.5, rho=-0.5)
    lm = LevenbergMarquardt(residuals, _central_difference_jacobian(residuals),
                            max_iterations=max_iterations,
                            accuracy=accuracy,
                            lower_bound=-np.inf, upper_bound=np.inf)
    res = lm.run(_to_unconstrained(start))
    p = _from_unconstrained(res.parameters, s0, r)
    rms = float(np.sqrt(np.mean(residuals(res.parameters) ** 2)))
    return HestonCalibrationResult(params=p, rms_price_error=rms,
                                   iterations=res.iterations,
                                   converged=res.converged)
