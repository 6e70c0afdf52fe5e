"""Credit layer: survival curves, CDS pricing and bootstrap, the CIR++
stochastic default intensity, doubly-stochastic default simulation, and a
wrong-way-risk CVA engine that simulates Hull-White rates and the CIR++
intensity jointly with correlated Brownians.

Counterpart of ``finmath_tpu.models.credit`` (finmath-lib's survival
curves, CDS bootstrap and intensity-based default modelling,
Brigo-Mercurio part III: lambda(t) = y(t) + psi(t), CIR y and psi fitted
to the market survival curve, the credit twin of Hull-White's alpha(t)).

* Curves, CDS legs, the bootstrap and the CIR bond are host NumPy float64,
  the same arithmetic and errors as the JAX module.
* ``CIRPPSimulation`` is a float32 step loop over ``[paths]`` tensors on
  the device: full-truncation Euler on y with ``substeps`` sub-iterations
  a grid step, and the integral Lambda_y of y+ by the trapezoid rule in a
  float64 carry.
* ``WrongWayRiskCVAEngine`` advances (x, Y) by the exact Hull-White step
  (``hull_white._hw_paths``, the same float32 order) and then the CIR
  substeps, each credit normal ``z_c = rho / sqrt(s) z1 + sqrt(1 - rho^2 /
  s) z3_k`` correlated to the rate normal z1 of its step. This is the JAX
  module's split, kept for parity: the s substeps share z1, so the credit
  increment over a step has variance (1 + rho^2 (1 - 1/s)) dt, not dt, and
  the simulated survival leaves the fitted curve by a few 1e-3 at rho =
  0.6 and s = 4. One float64 function then reconstitutes the swap's bonds
  ``[E, J, paths]`` and returns the CVA decomposition in one transfer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.random_variable import ACC_DTYPE, FLOAT_DTYPE, RandomVariableTorch
from ..parallel.mesh import (check_mesh, gather_paths, mesh_device,
                             path_block, path_means)
from ..utils.config import select_device
from .curves import DiscountCurve
from .hull_white import (HullWhiteModel, _b, _f64, _hw_paths, _injected,
                         _normal_block, _step_cov)
from .time_discretization import TimeDiscretization


# ---------------------------------------------------------------------------
# survival curve (piecewise-constant hazard)
# ---------------------------------------------------------------------------

class SurvivalCurve:
    """Piecewise-constant hazard rates: lambda = hazards[i] on
    [times[i], times[i+1]) with the last value extended to infinity.
    Q(t) = exp(-int_0^t lambda) is continuous and strictly decreasing.
    Host float64 throughout."""

    def __init__(self, hazard_times: Sequence[float],
                 hazard_rates: Sequence[float], name: str = "survivalCurve"):
        t = np.asarray(hazard_times, dtype=np.float64)
        h = np.asarray(hazard_rates, dtype=np.float64)
        if t.ndim != 1 or h.shape != t.shape or t.size == 0:
            raise ValueError("hazard_times and hazard_rates must be equal-"
                             "length 1-d sequences")
        if t[0] != 0.0 or np.any(np.diff(t) <= 0):
            raise ValueError("hazard_times must start at 0 and increase")
        if np.any(h < 0):
            raise ValueError("hazard rates must be nonnegative")
        self.times = t
        self.hazards = h
        self.name = name
        # cumulative hazard at the segment starts
        seg = np.diff(t) * h[:-1]
        self._cum = np.concatenate([[0.0], np.cumsum(seg)])

    def cumulative_hazard(self, time) -> np.ndarray:
        """int_0^t lambda(s) ds, vectorized over t."""
        t = np.asarray(time, dtype=np.float64)
        i = np.clip(np.searchsorted(self.times, t, side="right") - 1,
                    0, self.times.size - 1)
        return self._cum[i] + self.hazards[i] * (t - self.times[i])

    def get_survival_probability(self, time) -> np.ndarray:
        return np.exp(-self.cumulative_hazard(time))

    def get_hazard_rate(self, time) -> np.ndarray:
        t = np.asarray(time, dtype=np.float64)
        i = np.clip(np.searchsorted(self.times, t, side="right") - 1,
                    0, self.times.size - 1)
        return self.hazards[i]

    def default_probability(self, t0, t1) -> np.ndarray:
        """P(t0 < tau <= t1) unconditionally = Q(t0) - Q(t1)."""
        return (self.get_survival_probability(t0)
                - self.get_survival_probability(t1))

    getSurvivalProbability = get_survival_probability

    def __repr__(self):
        return f"SurvivalCurve({self.name}, segments={self.hazards.size})"


# ---------------------------------------------------------------------------
# CDS pricing (host float64)
# ---------------------------------------------------------------------------

def _cds_schedule(maturity: float, payment_interval: float) -> np.ndarray:
    n = int(round(maturity / payment_interval))
    if abs(n * payment_interval - maturity) > 1e-9 or n < 1:
        raise ValueError(f"maturity {maturity} is not a whole number of "
                         f"payment intervals {payment_interval}")
    return np.arange(1, n + 1, dtype=np.float64) * payment_interval


def _cds_legs_from_survival(discount_curve: DiscountCurve, grid, q,
                            recovery: float):
    """(protection, rpv01) on the schedule ``grid`` (0 first) given the
    survival ``q`` at its dates: default mid-period, accrual half-period."""
    pay = grid[1:]
    deltas = np.diff(grid)
    dq = q[:-1] - q[1:]                       # P(default in bucket i)
    df_pay = discount_curve.get_discount_factor(pay)
    df_mid = discount_curve.get_discount_factor(0.5 * (grid[:-1] + grid[1:]))
    rpv01 = float(np.sum(deltas * df_pay * q[1:])
                  + np.sum(0.5 * deltas * df_pay * dq))
    protection = float((1.0 - recovery) * np.sum(df_mid * dq))
    return protection, rpv01


def cds_legs(discount_curve: DiscountCurve, survival_curve: SurvivalCurve,
             maturity: float, recovery: float = 0.4,
             payment_interval: float = 0.25):
    """(protection_leg, rpv01) of a spot-start CDS per unit notional.

    rpv01 (the premium leg per unit running spread) = sum_i delta_i
    D(t_i) Q(t_i) + accrual-on-default sum_i (delta_i/2) D(t_i)
    (Q(t_{i-1}) - Q(t_i)); protection = (1-R) sum_i D(t_i^mid)
    (Q(t_{i-1}) - Q(t_i)), the quarterly ISDA-style discretization."""
    if not 0.0 <= recovery < 1.0:
        raise ValueError("recovery must be in [0, 1)")
    grid = np.concatenate([[0.0], _cds_schedule(maturity, payment_interval)])
    return _cds_legs_from_survival(
        discount_curve, grid, survival_curve.get_survival_probability(grid),
        recovery)


def cds_par_spread(discount_curve: DiscountCurve,
                   survival_curve: SurvivalCurve, maturity: float,
                   recovery: float = 0.4,
                   payment_interval: float = 0.25) -> float:
    """Running spread that prices the CDS to zero."""
    protection, rpv01 = cds_legs(discount_curve, survival_curve, maturity,
                                 recovery, payment_interval)
    return protection / rpv01


def cds_value(discount_curve: DiscountCurve, survival_curve: SurvivalCurve,
              maturity: float, spread: float, recovery: float = 0.4,
              payment_interval: float = 0.25,
              protection_buyer: bool = True) -> float:
    """PV of a running-spread CDS (protection leg minus premium leg for
    the protection buyer)."""
    protection, rpv01 = cds_legs(discount_curve, survival_curve, maturity,
                                 recovery, payment_interval)
    v = protection - spread * rpv01
    return v if protection_buyer else -v


def bootstrap_survival_curve(discount_curve: DiscountCurve,
                             maturities: Sequence[float],
                             spreads: Sequence[float],
                             recovery: float = 0.4,
                             payment_interval: float = 0.25,
                             name: str = "bootstrappedSurvival"
                             ) -> SurvivalCurve:
    """Strip a piecewise-constant hazard term structure from quoted CDS par
    spreads, shortest maturity first: each quote pins the hazard on
    [previous maturity, its maturity) by bisection so the quoted CDS
    reprices to zero."""
    mats = np.asarray(maturities, dtype=np.float64)
    sp = np.asarray(spreads, dtype=np.float64)
    if mats.ndim != 1 or sp.shape != mats.shape or mats.size == 0:
        raise ValueError("maturities and spreads must align")
    if np.any(np.diff(mats) <= 0) or mats[0] <= 0:
        raise ValueError("maturities must be positive and increasing")
    times = [0.0]
    hazards: list = []
    for m, s in zip(mats, sp):
        lo, hi = 0.0, 10.0

        def value(h: float) -> float:
            curve = SurvivalCurve(np.asarray(times),
                                  np.asarray(hazards + [h]))
            return cds_value(discount_curve, curve, float(m), float(s),
                             recovery, payment_interval)

        # the protection buyer's value increases in the hazard; bisect
        if value(lo) > 0.0:
            raise ValueError(f"CDS quote {s} at {m}y implies negative "
                             "hazard given the shorter quotes")
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if value(mid) > 0.0:
                hi = mid
            else:
                lo = mid
            if hi - lo < 1e-15 * max(1.0, hi):
                break
        hazards.append(0.5 * (lo + hi))
        times.append(float(m))
    return SurvivalCurve(np.asarray(times[:-1]), np.asarray(hazards),
                         name=name)


# ---------------------------------------------------------------------------
# CIR++ intensity model
# ---------------------------------------------------------------------------

def _cir_bond(kappa: float, theta: float, sigma: float, y0: float, t):
    """E[exp(-int_0^t y ds)] for CIR dy = kappa(theta - y)dt
    + sigma sqrt(y) dW: the closed-form affine bond A e^{-B y0}
    (Brigo-Mercurio 3.2.3)."""
    t = np.asarray(t, dtype=np.float64)
    h = math.sqrt(kappa * kappa + 2.0 * sigma * sigma)
    eht = np.expm1(h * t)                      # e^{ht} - 1
    denom = 2.0 * h + (kappa + h) * eht
    a = np.power(2.0 * h * np.exp(0.5 * (kappa + h) * t) / denom,
                 2.0 * kappa * theta / (sigma * sigma))
    b = 2.0 * eht / denom
    return a * np.exp(-b * y0)


class CIRPPIntensityModel:
    """Shifted CIR default intensity lambda(t) = y(t) + psi(t), with
    ``dy = kappa (theta - y) dt + sigma sqrt(y) dW`` and psi the
    deterministic shift that fits the model survival exactly to the market
    curve: int_0^t psi = ln(P_CIR(0,t) / Q_mkt(t)). psi >= 0 (hence lambda
    >= 0 pathwise up to the CIR floor) iff the market hazard dominates the
    CIR forward hazard; check with ``min_psi_on_grid``."""

    def __init__(self, survival_curve: SurvivalCurve, kappa: float,
                 theta: float, sigma: float, y0: float):
        if min(kappa, theta, sigma) <= 0 or y0 < 0:
            raise ValueError("kappa/theta/sigma must be positive, y0 >= 0")
        self.curve = survival_curve
        self.kappa = float(kappa)
        self.theta = float(theta)
        self.sigma = float(sigma)
        self.y0 = float(y0)

    @property
    def feller_satisfied(self) -> bool:
        """2 kappa theta >= sigma^2 keeps the CIR factor strictly positive
        (the simulation truncates either way)."""
        return 2.0 * self.kappa * self.theta >= self.sigma * self.sigma

    def cir_survival(self, t) -> np.ndarray:
        return _cir_bond(self.kappa, self.theta, self.sigma, self.y0, t)

    def psi_integral(self, t) -> np.ndarray:
        """int_0^t psi(s) ds (exact, host float64)."""
        q = self.curve.get_survival_probability(t)
        return np.log(self.cir_survival(t)) - np.log(q)

    def survival_probability(self, t) -> np.ndarray:
        """Model survival: the market curve by construction."""
        return self.curve.get_survival_probability(t)

    def min_psi_on_grid(self, grid) -> float:
        """min psi over the grid midpoints (finite-difference forward
        hazards); negative means lambda can dip below zero there."""
        g = np.asarray(grid, dtype=np.float64)
        pi = self.psi_integral(g)
        return float(np.min(np.diff(pi) / np.diff(g)))


# ---------------------------------------------------------------------------
# doubly-stochastic simulation of the CIR++ intensity
# ---------------------------------------------------------------------------

def _f32(v: float) -> float:
    """``v`` rounded to float32 (exact as a tensor scalar of that type)."""
    return float(np.float32(v))


def _cir_lambda(normal, dts, substeps: int, model: CIRPPIntensityModel,
                num_paths: int, device) -> torch.Tensor:
    """Full-truncation Euler on the CIR factor, ``substeps`` a grid step,
    in float32: ``y' = y + kappa (theta - y+) h + sigma sqrt(y+) sqrt(h) z``
    with ``h = float32(dt / substeps)``; ``Lambda_y += float64(h / 2) (y+ +
    y'+)`` in float64. ``normal(s, k)``: the float32 ``[paths]`` normal of
    substep k of step s. Returns Lambda_y ``[steps + 1, paths]``."""
    kappa, theta, sigma = (_f32(v) for v in (model.kappa, model.theta,
                                             model.sigma))
    y = torch.full((num_paths,), _f32(model.y0), dtype=FLOAT_DTYPE,
                   device=device)
    lams = torch.zeros((len(dts) + 1, num_paths), dtype=ACC_DTYPE,
                       device=device)
    lam = lams[0]
    for s, dt in enumerate(dts):
        h = np.float32(dt / substeps)
        sq, half_h = float(np.sqrt(h)), float(np.float32(0.5) * h)
        for k in range(substeps):
            yp = torch.clamp_min(y, 0.0)
            y_new = (y + kappa * (theta - yp) * float(h)
                     + sigma * torch.sqrt(yp) * sq * normal(s, k))
            lam = lam + half_h * (yp + torch.clamp_min(y_new, 0.0)).to(
                ACC_DTYPE)
            y = y_new
        lams[s + 1] = lam
    return lams


def _second_generator(seed: int, device) -> torch.Generator:
    """A generator for a second stream of ``seed``, independent of
    ``manual_seed(seed)``'s."""
    seq = np.random.SeedSequence((seed, 1))
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint32)[0]))


class CIRPPSimulation:
    """Doubly-stochastic default simulation on a time grid: pathwise
    conditional survival S(t) = exp(-Lambda(t)) with Lambda = int (y+ +
    psi), and default times by the exponential-threshold construction tau
    = inf{t : Lambda(t) >= E}, E ~ Exp(1) independent a path.

    The normals: one ``[steps, substeps, num_paths / 2]`` float32 block
    from ``torch.Generator(device).manual_seed(seed)`` (``num_paths`` without
    ``antithetic``), mirrored ``[z, -z]`` when antithetic, or the caller's
    ``normals=`` ``[steps, substeps, num_paths]``. The Exp(1) thresholds:
    ``[num_paths]`` float64, drawn once at construction from a second
    generator of ``seed``, or the caller's ``exponentials=``; the same draws
    serve every t, so the indicators are monotone pathwise. ``device``
    defaults to ``select_device()``."""

    def __init__(self, model: CIRPPIntensityModel,
                 time_discretization: TimeDiscretization, num_paths: int,
                 seed: int = 2718, antithetic: bool = False,
                 substeps: int = 4, *, device=None, normals=None,
                 exponentials=None):
        if antithetic and num_paths % 2:
            raise ValueError("antithetic needs an even num_paths")
        if substeps < 1:
            raise ValueError("substeps must be >= 1")
        self.model = model
        self.td = time_discretization
        self.num_paths = int(num_paths)
        self.seed = int(seed)
        self.antithetic = bool(antithetic)
        self.substeps = int(substeps)
        self.device = torch.device(device) if device is not None \
            else select_device()
        times = time_discretization.as_array()
        if times[0] != 0.0:
            raise ValueError("simulation grid must start at 0")
        self._times = times
        self._psi_int = model.psi_integral(times)      # exact, float64
        dts, dev = np.diff(times), self.device
        shape = (dts.size, self.substeps, self.num_paths)
        if normals is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            z = _normal_block(gen, shape, self.antithetic, dev)
        else:
            z = _injected(normals, shape, dev, "normals")
        if exponentials is None:
            self._exp = torch.empty(self.num_paths, dtype=ACC_DTYPE,
                                    device=dev).exponential_(
                generator=_second_generator(self.seed, dev))
        else:
            self._exp = _injected(exponentials, (self.num_paths,), dev,
                                  "exponentials", ACC_DTYPE)
        self._lam_y = _cir_lambda(lambda s, k: z[s, k], dts, self.substeps,
                                  model, self.num_paths, dev)

    def _index(self, time: float) -> int:
        ti = self.td.get_time_index(time)
        if ti < 0:
            raise ValueError(f"time {time} not on the simulation grid")
        return ti

    def _lambda(self, i: int) -> torch.Tensor:
        return self._lam_y[i] + float(self._psi_int[i])

    def survival(self, time: float) -> RandomVariableTorch:
        """Pathwise conditional survival S(t) = exp(-Lambda(t))."""
        i = self._index(time)
        return RandomVariableTorch.of(
            self._times[i], torch.exp(-self._lambda(i)).to(FLOAT_DTYPE))

    def expected_survival(self, time: float) -> float:
        """E[S(t)]: converges to the market Q(t) as the Euler substeps
        refine (the martingale test)."""
        return float(torch.mean(torch.exp(-self._lambda(self._index(time)))))

    def default_indicators(self, time: float) -> RandomVariableTorch:
        """1{tau <= t} per path by the threshold construction."""
        i = self._index(time)
        return RandomVariableTorch.of(
            self._times[i], (self._lambda(i) >= self._exp).to(FLOAT_DTYPE))

    def mc_cds_legs(self, discount_curve: DiscountCurve, maturity: float,
                    recovery: float = 0.4,
                    payment_interval: float = 0.25):
        """(protection, rpv01) by Monte Carlo on the pathwise survival
        (deterministic rates): ``cds_legs``' buckets with E[S] from the
        simulation, all dates in one transfer."""
        grid = np.concatenate([[0.0], _cds_schedule(maturity,
                                                    payment_interval)])
        idx = [self._index(t) for t in grid]
        lam = self._lam_y[idx] + _f64(self._psi_int[idx], self.device)[:, None]
        q = torch.mean(torch.exp(-lam), dim=1).cpu().numpy()
        return _cds_legs_from_survival(discount_curve, grid, q, recovery)


# ---------------------------------------------------------------------------
# wrong-way-risk CVA: joint Hull-White x CIR++ simulation
# ---------------------------------------------------------------------------

def _wwr_collect(xs, yys, lams, psi_int, a_int, alive, leads, bbs, wts,
                 sign: float, lgd: float, mesh=None) -> torch.Tensor:
    """Per-observation CVA contributions, packed, in float64.

    ``xs``, ``yys`` ``[E + 1, paths]`` float32 at the observation dates
    (index 0 is t0), ``lams`` likewise in float64; ``psi_int``, ``a_int``
    ``[E + 1]``; ``alive`` ``[E]`` 1 while the swap has payments left;
    ``leads``, ``bbs``, ``wts`` ``[E, J]`` the bond reconstitution and the
    fixed-leg weights masked to the remaining payments (the terminal column
    carries the float leg's notional); ``sign`` +1 payer, -1 receiver.
    Returns ``[2 + 2E]``: cva, cva_independent, E contributions and E
    expected survivals. Under a ``mesh`` the paths are this rank's block
    and the four path means are one all-reduce."""
    xa = xs[1:].to(ACC_DTYPE)                               # [E, paths]
    bonds = leads[:, :, None] * torch.exp(
        -bbs[:, :, None] * xa[:, None, :])                  # [E, J, paths]
    value = sign * (alive[:, None]
                    - torch.sum(wts[:, :, None] * bonds, dim=1))
    inv_n = torch.exp(-yys[1:].to(ACC_DTYPE) - a_int[1:, None])
    dpe = torch.clamp_min(value, 0.0) * inv_n               # discounted V+
    s = torch.exp(-(lams + psi_int[:, None]))               # [E + 1, paths]
    ds = s[:-1] - s[1:]                                     # [E, paths]
    m_dpe_ds, m_dpe, m_ds, es = path_means([dpe * ds, dpe, ds, s[1:]], mesh)
    contrib = lgd * m_dpe_ds                                # [E]
    cva = torch.sum(contrib)
    # independence control: the product of means on the same survival
    cva_indep = lgd * torch.sum(m_dpe * m_ds)
    return torch.cat([torch.stack([cva, cva_indep]), contrib, es])


@dataclass(frozen=True)
class WWRCVAResult:
    cva: float
    cva_independent: float
    contributions: np.ndarray        # per observation bucket
    expected_survival: np.ndarray    # E[S(t_i)] diagnostics
    observation_times: np.ndarray

    @property
    def wwr_ratio(self) -> float:
        """CVA / independent CVA: > 1 is wrong-way, < 1 right-way."""
        return self.cva / self.cva_independent


class WrongWayRiskCVAEngine:
    """CVA of an interest-rate swap under a simulated default intensity
    correlated with the rate factor.

    Rates: Hull-White (exact per-step transitions and pathwise numeraire).
    Credit: CIR++ fitted to the market survival curve. ``correlation``
    couples the credit Brownian to the rate Brownian a step. The swap
    exposure is exact pathwise (affine bond reconstitution), so the
    estimator's errors are Monte-Carlo noise and the CIR Euler bias.

    CVA = (1-R) sum_i E[(V(t_i)/N(t_i))+ (S(t_{i-1}) - S(t_i))], default in
    (t_{i-1}, t_i] valued at the bucket's right edge.

    The normals: ``z1``, ``z2`` ``[steps, num_paths / 2]`` and ``z3``
    ``[steps, substeps, num_paths / 2]`` float32, in that order from
    ``torch.Generator(device).manual_seed(seed)``, mirrored when
    antithetic; or the caller's ``normals=(z1, z2, z3)`` at full width.
    ``device`` defaults to ``select_device()``.

    ``mesh``: a ``parallel.PathMesh``. Every rank draws (or is given) the
    global blocks above, the unmeshed stream, and keeps its block of the
    paths (``num_paths`` divisible by the world size); the substep split
    is the one above, unchanged; the CVA's path means are all-reduced and
    ``simulate()`` gathers the histories, so every rank returns the
    unsharded results up to the order of the float64 sums."""

    def __init__(self, hw_model: HullWhiteModel,
                 intensity_model: CIRPPIntensityModel,
                 payment_times: Sequence[float], fixed_rate: float,
                 num_paths: int = 100_000, payer: bool = True,
                 recovery: float = 0.4, correlation: float = 0.0,
                 seed: int = 777, antithetic: bool = True,
                 substeps: int = 4,
                 time_discretization: Optional[TimeDiscretization] = None,
                 mesh=None, path_axis: str = "paths", *, device=None,
                 normals=None):
        self.mesh = check_mesh(mesh)
        self.path_axis = path_axis
        if not -1.0 <= correlation <= 1.0:
            raise ValueError("correlation must be in [-1, 1]")
        if antithetic and num_paths % 2:
            raise ValueError("antithetic needs an even num_paths")
        if self.mesh is not None:
            self.mesh.local_count(num_paths)
        pt = np.asarray(payment_times, dtype=np.float64)
        if pt.ndim != 1 or pt.size < 1 or pt[0] <= 0 \
                or np.any(np.diff(pt) <= 0):
            raise ValueError("payment_times must be positive, increasing")
        self.hw = hw_model
        self.intensity = intensity_model
        self.payment_times = pt
        self.fixed_rate = float(fixed_rate)
        self.num_paths = int(num_paths)
        self.payer = bool(payer)
        self.recovery = float(recovery)
        self.rho = float(correlation)
        self.seed = int(seed)
        self.antithetic = bool(antithetic)
        self.substeps = int(substeps)
        self.device = mesh_device(self.mesh, device)

        td = time_discretization or TimeDiscretization(
            np.concatenate([[0.0], pt]))
        times = td.as_array()
        if times[0] != 0.0:
            raise ValueError("grid must start at 0")
        for t in pt:
            if td.get_time_index(t) < 0:
                raise ValueError(f"payment time {t} not on the grid")
        self.td = td
        self._times = times
        # observation dates: every grid time after t = 0
        obs_idx = np.arange(1, times.size)
        self._obs_idx = obs_idx

        a = hw_model.a
        dts = np.diff(times)
        for bt in hw_model.vol_times[1:]:
            if bt < times[-1] and td.get_time_index(bt) < 0:
                raise ValueError(
                    f"volatility breakpoint {bt} not on the time grid")
        sig = np.array([hw_model.sigma_at(t) for t in times[:-1]])
        cov = np.array([_step_cov(a, s, dt) for s, dt in zip(sig, dts)])
        lx = np.sqrt(cov[:, 0])
        lyx = cov[:, 2] / np.maximum(lx, 1e-300)
        ly = np.sqrt(np.maximum(cov[:, 1] - lyx * lyx, 0.0))

        st = np.array([hw_model.gaussian_state(t) for t in times])
        phi, c, v = st[:, 0], st[:, 1], st[:, 2]
        a_int = -np.log(hw_model.df(times)) + 0.5 * v

        # bond reconstitution at every observation date for every payment
        # column; weights = fixed coupons K delta_j plus the terminal
        # notional (float leg = 1 - P(t, T_n)); columns of payments at or
        # before the observation date are masked out
        E, J = obs_idx.size, pt.size
        deltas = np.diff(np.concatenate([[0.0], pt]))
        leads = np.zeros((E, J))
        bbs = np.zeros((E, J))
        wts = np.zeros((E, J))
        alive = np.zeros(E)
        for r, i in enumerate(obs_idx):
            t = times[i]
            live = pt > t + 1e-12
            if not np.any(live):
                continue
            alive[r] = 1.0
            mats = pt[live]
            bb = _b(a, mats - t)
            lead = (hw_model.df(mats) / hw_model.df(t)
                    * np.exp(-0.5 * bb * bb * phi[i] - bb * c[i]))
            w = self.fixed_rate * deltas[live]
            w[-1] += 1.0                       # terminal notional
            leads[r, live] = lead
            bbs[r, live] = bb
            wts[r, live] = w
        self._coef = np.stack([np.exp(-a * dts), _b(a, dts), lx, lyx, ly])
        self._dts = dts
        self._a_int = a_int
        self._leads, self._bbs, self._wts = leads, bbs, wts
        self._alive = alive
        self._psi_int = intensity_model.psi_integral(times)
        self._normals = None
        if normals is not None:
            steps, n, dev = dts.size, self.num_paths, self.device
            z1, z2, z3 = normals
            self._normals = tuple(path_block(z, self.mesh) for z in (
                _injected(z1, (steps, n), dev, "z1"),
                _injected(z2, (steps, n), dev, "z2"),
                _injected(z3, (steps, self.substeps, n), dev, "z3")))

    # ------------------------------------------------------------------
    def _draw(self):
        """(z1, z2, z3) of this engine's seed, mirrored when antithetic
        (this rank's block of them under a mesh)."""
        dev, steps, n = self.device, self._dts.size, self.num_paths
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        return tuple(path_block(_normal_block(gen, shape, self.antithetic,
                                              dev), self.mesh)
                     for shape in ((steps, n), (steps, n),
                                   (steps, self.substeps, n)))

    def credit_shares(self):
        """(rate share, idiosyncratic share) of each credit substep normal,
        ``z_c = rs z1 + io z3_k``, in float32: rho / sqrt(s) and sqrt(1 -
        rho^2 / s). The reference's split: every z_c is standard normal,
        but the s of a step share z1, so their sum over a step over sqrt(s)
        has variance 1 + rho^2 (1 - 1/s), not 1."""
        r_share = self.rho / math.sqrt(self.substeps)
        return _f32(r_share), _f32(math.sqrt(1.0 - r_share * r_share))

    def _simulate(self):
        """This rank's joint histories (``simulate``)."""
        z1, z2, z3 = self._normals or self._draw()
        dev = self.device
        xs, yys = _hw_paths(z1, z2, torch.as_tensor(
            self._coef.astype(np.float32), device=dev))
        rs, io = self.credit_shares()
        lams = _cir_lambda(lambda s, k: rs * z1[s] + io * z3[s, k],
                           self._dts, self.substeps, self.intensity,
                           z1.shape[-1], dev)
        return xs, yys, lams

    def simulate(self):
        """The joint histories ``[steps + 1, paths]``: x and Y (float32)
        and Lambda_y (float64); under a mesh every rank's paths, gathered
        in rank order."""
        return tuple(gather_paths(h, self.mesh) for h in self._simulate())

    def compute(self) -> WWRCVAResult:
        """Run the joint simulation and collect the CVA decomposition in
        one packed host transfer."""
        xs, yys, lams = self._simulate()
        full = np.concatenate([[0], self._obs_idx])
        dev = self.device
        idx = torch.as_tensor(full, device=dev)
        packed = _wwr_collect(
            xs[idx], yys[idx], lams[idx], _f64(self._psi_int[full], dev),
            _f64(self._a_int[full], dev), _f64(self._alive, dev),
            _f64(self._leads, dev), _f64(self._bbs, dev),
            _f64(self._wts, dev), 1.0 if self.payer else -1.0,
            1.0 - self.recovery, self.mesh).cpu().numpy()
        E = self._obs_idx.size
        return WWRCVAResult(
            cva=float(packed[0]), cva_independent=float(packed[1]),
            contributions=packed[2:2 + E],
            expected_survival=packed[2 + E:2 + 2 * E],
            observation_times=self._times[self._obs_idx])


def par_swap_rate(discount_curve: DiscountCurve,
                  payment_times: Sequence[float]) -> float:
    """Single-curve par rate of a spot-start swap with the given fixed
    payment dates: (1 - df(T_n)) / sum delta_j df(t_j)."""
    pt = np.asarray(payment_times, dtype=np.float64)
    deltas = np.diff(np.concatenate([[0.0], pt]))
    df = discount_curve.get_discount_factor(pt)
    return float((1.0 - df[-1]) / np.sum(deltas * df))
