"""Counterparty-exposure profiles and XVA on the LIBOR Market Model.

Counterpart of ``finmath_tpu.models.lmm.exposure`` (finmath-lib's
exposure layer, ``ExposureEstimator`` over ``SwapLeg`` and the swaption
products). Exposure is one more collector on the valuation engine's
simulation: the engine stops at every observation date with the live
forward curve and the numeraire, so the whole dated profile (every date,
every path) costs one pass over one path ensemble
(``LMMValuationEngine._simulate_collect``), not one simulation per date.

Conventions (as in the JAX module, test-asserted):

* ``ee``/``ene`` are DISCOUNTED expected (negative) exposures in today's
  money, ``EE(t) = N(0) E[max(V(t), 0) / N(t)]``, with the engine's
  deterministic numeraire adjustment ``E[1/N(T)] -> df(T)``.
* ``pfe`` quantiles are of the UNDISCOUNTED time-t value ``V(t)``.
* An observation at tenor index ``e`` sees the swap's remaining periods
  ``[max(e, first), last)``: collection happens at the step start, before
  the period fixing there is consumed.
* Swaption close-out values before expiry are Longstaff-Schwartz
  conditional expectations regressed on the underlying par rate; with a
  constant in the basis the regression preserves the mean, so
  ``forward_value`` stays a martingale diagnostic.
* CVA/DVA integrate the discounted EE/ENE profiles against a hazard curve;
  ``cva_forward_deltas`` differentiates the whole pipeline in one reverse
  pass.
* Collateral (``CSA``): the margin balance is computed pathwise on the
  observation grid (lagged requirement, two-way thresholds, minimum
  transfer amount, independent amount); EE/ENE/PFE become the residual
  exposure ``V(t) - C(t)`` and the uncollateralized profile is kept
  (``ee_gross``/``ene_gross``). Collateral is in time-t money (the
  balance accrues at the numeraire rate between margin dates).
* Funding (``fva_from_profile``): FCA - FBA on the discounted EE/ENE
  profiles with survival weighting.
* Initial margin (``im_profile`` + ``mva_from_im_profile``): dynamic IM by
  regression of the conditional variance of the netting set's clean
  one-period P&L on the netted value, Brownian-scaled to the margin
  period of risk and mapped to a Gaussian quantile; MVA integrates the
  discounted expected IM against the funding spread.

Layout in the port: the engine hands a collector only the live block of
the forwards (``L[j]`` is forward ``e + j``), so every per-trade table is
kept per observation date relative to its index ``e``, and the bond curve
is read as ``cp[k] = P(T_e, T_{e+k})`` with ``cp[0] = 1``. The bond curve
is a float64 ``cumprod`` in the collect dtype (the engine's
``_event_contrib``; the JAX package's compensated float32 scan is a TPU
workaround), and the annuities are one ``[trades, n - e] @ [n - e,
paths]`` product in the path dtype (float32 by default, TF32 off), cast to
float64, as in the JAX module. A profile's collection at each date is
``ops.exposure_collect``: on the card one launch of its kernel a date
(the curve, every trade's value and the buffer writes), on the CPU that
composition. The regressions are
``ops.conditional_expectation.regression_fit`` (float64 normal
equations); the expectations and quantiles are float64 over the path
axis. Each public call reads its result back in one transfer.

The netting-set engine writes each date's collected values into ``[dates,
...]`` buffers as the simulation reaches it (the underlyings' values in
float64, their par rates, the regressions' feature, in the path dtype), so
a profile holds them once: at 1,048,576 paths and 40 optionality
underlyings over 39 dates they are 13 GB, and 6.5 GB in float32 paths (13
GB in float64). ``reseed(seed)`` redraws the netting-set engine's paths
on the device from a new seed, bit for bit a new engine's, and keeps
every per-date table.

Spans (``utils.profiling.span``): ``finmath.xva.profile`` is the root of
one ``profile`` of either engine (attributes ``trades``, ``swaptions``,
``bermudans``, ``dates``, ``paths`` and ``regressions``, the fits it
made); inside it ``finmath.xva.simulate`` (the engine's step loop, with
one ``finmath.xva.collect`` a date, attribute ``kernel``: whether the
date took the collector kernel, then the discount factors),
``finmath.xva.regress`` (the swaptions' close-out values),
``finmath.xva.margin`` (the CSA's scan, with a CSA) and
``finmath.xva.reduce`` (the means, the sort and the quantiles).

Under a ``parallel.PathMesh`` (``mesh=`` on the netting-set engines, as in
the JAX module) each rank simulates its block of the paths: the
expectations are float64 path sums all-reduced and divided by the global
count, the regressions fit on all-reduced normal equations, the PFE sorts
the gathered ensemble, and the CSA's margin scan stays path-local. Every
rank returns the same profile. ``SwaptionExposureEngine`` takes no mesh,
as the JAX one takes none.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ...ops.conditional_expectation import regression_fit, regression_predict
from ...ops.exposure_collect import (
    CollectPlan,
    collect_buffers,
    exposure_collect,
    exposure_collect_reference,
    pack_rows,
    swap_values,
    zero_broken,
)
from ...ops.random_variable import ACC_DTYPE
from ...parallel.mesh import gather_paths, path_mean, path_means, replicated
from ...utils.profiling import span
from .model import (
    LIBORMarketModelTorch,
    LMMValuationEngine,
    SwaptionProduct,
    adjoint_dead_mask,
)

__all__ = [
    "CSA",
    "BermudanSwaptionTrade",
    "ExposureProfile",
    "IMProfile",
    "NettingSetExposureEngine",
    "SwapExposureEngine",
    "SwapTrade",
    "SwaptionExposureEngine",
    "SwaptionTrade",
    "bilateral_cva_from_profile",
    "cva_from_profile",
    "dva_from_profile",
    "fva_from_profile",
    "mva_from_im_profile",
]


def _default_probability_vector(times: np.ndarray,
                                hazard_rate: Optional[float],
                                default_probabilities) -> np.ndarray:
    """Per-interval default probabilities PD(t_{i-1}, t_i] on the
    observation grid from a flat hazard OR an explicit strip."""
    if (hazard_rate is None) == (default_probabilities is None):
        raise ValueError(
            "provide exactly one of hazard_rate / default_probabilities")
    if hazard_rate is not None:
        t = np.concatenate([[0.0], times])
        surv = np.exp(-float(hazard_rate) * t)
        return surv[:-1] - surv[1:]
    pd = np.asarray(default_probabilities, dtype=np.float64)
    if pd.shape != times.shape:
        raise ValueError(
            f"need one default probability per observation date "
            f"({times.shape[0]}), got {pd.shape}")
    if pd.min() < -1e-12 or pd.sum() > 1.0 + 1e-12:
        raise ValueError(
            "default probabilities must be a sub-probability vector")
    return pd


def cva_from_profile(profile: "ExposureProfile",
                     hazard_rate: Optional[float] = None,
                     recovery: float = 0.4,
                     default_probabilities: Optional[Sequence[float]] = None
                     ) -> float:
    """Unilateral CVA from a dated exposure profile:
    ``(1 - R) * sum_i EE(t_i) * PD(t_{i-1}, t_i]`` (rectangle rule on the
    discounted EE profile — the standard discretization of
    ``(1-R) \\int EE(t) dPD(t)``).

    Provide EITHER a flat ``hazard_rate`` (survival ``exp(-h t)``) OR
    explicit per-interval ``default_probabilities`` (one per observation
    date, summing to <= 1)."""
    pd = _default_probability_vector(profile.times, hazard_rate,
                                     default_probabilities)
    return float((1.0 - float(recovery)) * np.sum(profile.ee * pd))


def dva_from_profile(profile: "ExposureProfile",
                     own_hazard_rate: Optional[float] = None,
                     own_recovery: float = 0.4,
                     own_default_probabilities: Optional[Sequence[float]]
                     = None) -> float:
    """Debit valuation adjustment — the mirror integral on the NEGATIVE
    exposure profile (our own default extinguishes our liability):
    ``(1 - R_own) * sum_i (-ENE(t_i)) * PD_own(t_{i-1}, t_i]``. Positive
    by convention (a benefit to us); bilateral CVA = CVA - DVA."""
    pd = _default_probability_vector(profile.times, own_hazard_rate,
                                     own_default_probabilities)
    return float((1.0 - float(own_recovery)) * np.sum(-profile.ene * pd))


def bilateral_cva_from_profile(profile: "ExposureProfile",
                               counterparty_hazard_rate: float,
                               own_hazard_rate: float,
                               counterparty_recovery: float = 0.4,
                               own_recovery: float = 0.4) -> float:
    """Bilateral credit adjustment CVA - DVA on one profile (flat
    hazards; the standard no-first-to-default simplification — survival
    cross-terms are second order at these hazard levels)."""
    return (cva_from_profile(profile, counterparty_hazard_rate,
                             counterparty_recovery)
            - dva_from_profile(profile, own_hazard_rate, own_recovery))


def _survival_weights(times: np.ndarray, counterparty_hazard_rate: float,
                      own_hazard_rate: float) -> np.ndarray:
    """Joint survival S_c(t) * S_o(t) at each observation date — funding
    flows stop at the FIRST default of either party."""
    h = float(counterparty_hazard_rate) + float(own_hazard_rate)
    return np.exp(-h * times)


def fva_from_profile(profile: "ExposureProfile",
                     borrow_spread,
                     lend_spread=None,
                     counterparty_hazard_rate: float = 0.0,
                     own_hazard_rate: float = 0.0) -> float:
    """Funding valuation adjustment from a dated exposure profile:

    ``FVA = FCA - FBA``
    ``FCA = sum_i s_b(t_i) * EE(t_i)   * S(t_i) * dt_i``  (funding cost)
    ``FBA = sum_i s_l(t_i) * (-ENE(t_i)) * S(t_i) * dt_i``  (funding benefit)

    with ``S`` the joint survival of both parties (funding of the trade
    stops at the first default) and ``dt_i`` the observation-grid
    spacing — the rectangle-rule discretization of the standard
    discounted-expected-exposure funding integrals. Spreads are
    CONTINUOUS annualized rates, scalar or one per observation date;
    ``lend_spread`` defaults to ``borrow_spread`` (symmetric funding).
    Positive result = a cost to us.

    Run it on a COLLATERALIZED profile (engine built with a ``CSA``) to
    price the funding of the residual exposure only."""
    t = profile.times
    dt = np.diff(np.concatenate([[0.0], t]))
    s_b = np.broadcast_to(np.asarray(borrow_spread, dtype=np.float64),
                          t.shape)
    s_l = (s_b if lend_spread is None
           else np.broadcast_to(np.asarray(lend_spread, dtype=np.float64),
                                t.shape))
    surv = _survival_weights(t, counterparty_hazard_rate, own_hazard_rate)
    fca = float(np.sum(s_b * profile.ee * surv * dt))
    fba = float(np.sum(s_l * (-profile.ene) * surv * dt))
    return fca - fba


@dataclass(frozen=True)
class IMProfile:
    """Dynamic initial-margin profile (host-side numpy).

    ``times``: observation dates carrying an IM requirement (all but the
    last observation — IM covers the close-out period that follows).
    ``expected_im``: E[IM(t) / N(t)] * N(0) — the discounted expected IM
    in today's money (the MVA integrand).
    ``expected_im_tmoney``: E[IM(t)] undiscounted (the reporting view).
    ``dts``: the spacing of the observation grid (the holding interval
    of each IM value, used by the MVA rectangle rule).
    ``quantile`` / ``mpr``: the IM definition — a ``quantile`` Gaussian
    worst-case of the clean P&L over a margin period of risk ``mpr``
    (in years)."""

    times: np.ndarray
    expected_im: np.ndarray
    expected_im_tmoney: np.ndarray
    dts: np.ndarray
    quantile: float
    mpr: float

    def peak_im(self) -> float:
        return float(np.max(self.expected_im_tmoney))


def mva_from_im_profile(im: IMProfile, im_spread,
                        counterparty_hazard_rate: float = 0.0,
                        own_hazard_rate: float = 0.0) -> float:
    """Margin valuation adjustment: the funding cost of posting the
    initial margin over the life of the netting set,

    ``MVA = sum_i s(t_i) * E[IM(t_i)/N(t_i)]N(0) * S(t_i) * dt_i``

    (rectangle rule; ``s`` the continuous funding-vs-remuneration spread
    on posted IM, scalar or per-date; ``S`` the joint survival).
    Positive result = a cost to us."""
    s = np.broadcast_to(np.asarray(im_spread, dtype=np.float64),
                        im.times.shape)
    surv = _survival_weights(im.times, counterparty_hazard_rate,
                             own_hazard_rate)
    return float(np.sum(s * im.expected_im * surv * im.dts))


@dataclass(frozen=True)
class ExposureProfile:
    """Dated exposure profile (numpy, host-side).

    ``times``: observation dates (tenor times).
    ``ee`` / ``ene``: discounted expected exposure / expected negative
    exposure in today's money (ene <= 0 <= ee pointwise).
    ``forward_value``: discounted E[V(t)/N(t)] — by the martingale
    property this equals the t=0 value of the remaining swap at every
    observation date (the strongest internal consistency check; asserted
    by the tests against the analytic curve value).
    ``pfe``: {quantile: undiscounted V(t) quantile} per observation date.
    """

    times: np.ndarray
    ee: np.ndarray
    ene: np.ndarray
    forward_value: np.ndarray
    pfe: Dict[float, np.ndarray]
    #: sum of the trades' STANDALONE expected exposures (netting-set
    #: engines only; None for single-product profiles) — ``ee_standalone
    #: - ee`` is the netting benefit
    ee_standalone: Optional[np.ndarray] = None
    #: uncollateralized netted EE/ENE (present only when the engine was
    #: built with a ``CSA``; ``ee``/``ene``/``pfe`` are then the RESIDUAL
    #: exposure after variation margin)
    ee_gross: Optional[np.ndarray] = None
    ene_gross: Optional[np.ndarray] = None

    def max_pfe(self, q: float) -> float:
        """Peak PFE over the profile at quantile ``q``."""
        return float(np.max(self.pfe[q]))

    def epe(self, horizon: Optional[float] = None) -> float:
        """Expected positive exposure: the time-weighted average of EE
        over [0, horizon] (default: the last observation date) — left
        Riemann sum on the observation grid, the regulatory EPE
        definition (Basel counterparty credit risk)."""
        t = np.concatenate([[0.0], self.times])
        dt = np.diff(t)
        h = float(horizon) if horizon is not None else float(self.times[-1])
        if not 0.0 < h <= self.times[-1] + 1e-12:
            raise ValueError(f"horizon must lie in (0, {self.times[-1]}]")
        w = np.clip((h - t[:-1]) / np.where(dt > 0, dt, 1.0), 0.0, 1.0) * dt
        return float(np.sum(self.ee * w) / h)

    def effective_ee(self) -> np.ndarray:
        """Effective EE: the running maximum of EE (non-decreasing, the
        Basel roll-over assumption for maturing short-dated trades)."""
        return np.maximum.accumulate(self.ee)

    def effective_epe(self, horizon: Optional[float] = None) -> float:
        """Effective EPE: time-weighted average of effective EE — the
        exposure measure of the Basel internal model method (EAD =
        alpha * effective EPE)."""
        eff = ExposureProfile(self.times, self.effective_ee(), self.ene,
                              self.forward_value, self.pfe)
        return eff.epe(horizon)

    @property
    def netting_benefit(self) -> np.ndarray:
        """Per-date reduction of EE from netting (>= 0 pointwise)."""
        if self.ee_standalone is None:
            raise ValueError("profile carries no standalone decomposition")
        return self.ee_standalone - self.ee

    @property
    def collateral_benefit(self) -> np.ndarray:
        """Per-date reduction of EE from variation margin (>= 0
        pointwise under a one-way CSA; a two-way CSA can post collateral
        OUT and locally increase residual EE)."""
        if self.ee_gross is None:
            raise ValueError("profile was built without a CSA")
        return self.ee_gross - self.ee


@dataclass(frozen=True)
class SwapTrade:
    """One swap of a netting set: periods ``[first_index, last_index)``
    on the model tenor grid, fixed rate ``strike``, ``payer`` direction,
    signed by ``notional``."""

    first_index: int
    last_index: int
    strike: float
    payer: bool = True
    notional: float = 1.0


@dataclass(frozen=True)
class SwaptionTrade:
    """A European payer swaption inside a netting set: expiry at tenor
    index ``exercise_index`` into the swap over the following
    ``num_periods`` periods. ``notional`` > 0 = long (an asset before
    expiry), < 0 = short (a liability). Before expiry its close-out
    value is the Longstaff-Schwartz conditional expectation (regression
    on the underlying par rate, degree ``basis_degree``); after a
    ``physical`` exercise the underlying swap lives on the exercised
    paths."""

    exercise_index: int
    num_periods: int
    strike: float
    notional: float = 1.0
    physical: bool = True
    basis_degree: int = 2

    @property
    def last_index(self) -> int:
        return self.exercise_index + self.num_periods


@dataclass(frozen=True)
class BermudanSwaptionTrade:
    """A Bermudan payer swaption inside a netting set: the right to enter,
    at any tenor index in ``exercise_indices`` (ascending), the payer swap
    over the remaining periods up to ``last_index`` at ``strike``.

    The close-out value is EXERCISE-AWARE — the classic hard exposure
    problem finmath-lib's eager ``ExposureEstimator`` handles product by
    product (``BermudanSwaption`` + ``MonteCarloConditionalExpectation
    Regression``), here computed inside the one profile simulation:

    * the exercise policy is fitted by Longstaff-Schwartz backward
      induction over the exercise dates (same convention as
      ``BermudanSwaptionPricer``: exercise iff in the money AND above the
      regressed continuation);
    * every path carries its STOPPING TIME; after it, ``physical``
      exercise leaves the underlying swap's two-way exposure on the
      exercised paths (``physical=False``: the cash settlement is the
      exposure at the exercise date, nothing after);
    * before/between exercise dates the alive-path close-out value is the
      regressed conditional expectation of the policy's discounted stopped
      payoff — between dates the regression is RESTRICTED to the alive
      paths (masked normal equations), because the stopped payoff of an
      exercised path is no longer a sample of the option's future value.
    """

    exercise_indices: tuple
    last_index: int
    strike: float
    notional: float = 1.0
    physical: bool = True
    basis_degree: int = 2

    def __post_init__(self):
        xs = tuple(int(x) for x in self.exercise_indices)
        object.__setattr__(self, "exercise_indices", xs)
        if not xs or list(xs) != sorted(set(xs)):
            raise ValueError("exercise_indices must be non-empty, unique "
                             "and ascending")
        if xs[0] < 1 or xs[-1] >= self.last_index:
            raise ValueError("every exercise must lie in [1, last_index)")


@dataclass(frozen=True)
class CSA:
    """Credit-support annex (variation margin) terms of a netting set.

    ``threshold``: the counterparty posts collateral to us only above
    this mark-to-market (infinity = they never post).
    ``threshold_own``: we post above this negative mark (infinity = a
    one-way CSA in our favour).
    ``mta``: minimum transfer amount — a margin call is only made when
    the required balance differs from the held balance by at least this.
    ``independent_amount``: collateral held from inception on top of
    variation margin (reduces our exposure from day one; may be negative
    for an IA we posted).
    ``margin_lag``: the margin period of risk in OBSERVATION-GRID steps —
    the balance held at t_i was called against the value at
    t_{i - margin_lag} (0 = idealized instantaneous margining; >= 1
    models the close-out period during which the market moves but
    collateral does not).

    All amounts are in time-t money (the balance is assumed to accrue at
    the numeraire rate between margin dates)."""

    threshold: float = 0.0
    threshold_own: float = 0.0
    mta: float = 0.0
    independent_amount: float = 0.0
    margin_lag: int = 1

    def __post_init__(self):
        if self.threshold < 0 or self.threshold_own < 0:
            raise ValueError("CSA thresholds must be >= 0 (use inf to "
                             "disable a posting direction)")
        if self.mta < 0:
            raise ValueError("mta must be >= 0")
        if int(self.margin_lag) != self.margin_lag or self.margin_lag < 0:
            raise ValueError("margin_lag must be an integer >= 0")


def _path_dtype(dtype) -> torch.dtype:
    """The engine's path dtype for the JAX-style ``dtype=`` argument: None
    is float32; a NumPy or torch float32 or float64 maps to itself."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise ValueError(f"path dtype {dtype}: float32 or float64") from None


def _swap_geometry(specs, obs, deltas, n):
    """Static per-(observation, trade) swap geometry on the absolute tenor
    grid, as the JAX module builds it: fixed-leg pay mask ``[E, T, n]``,
    float-leg start bond row ``start - 1`` and whether the swap is still
    forward-starting, a 1/0 alive flag (0 once the last payment has
    passed), the end bond row ``last - 1`` and the strikes."""
    E, T = len(obs), len(specs)
    pay_mask = np.zeros((E, T, n), dtype=np.float64)
    start_m1 = np.zeros((E, T), dtype=np.int64)
    is_fwd = np.zeros((E, T), dtype=bool)
    alive = np.zeros((E, T), dtype=np.float64)
    end_m1 = np.zeros(T, dtype=np.int64)
    strikes = np.zeros(T, dtype=np.float64)
    for t, (first, last, strike) in enumerate(specs):
        end_m1[t] = last - 1
        strikes[t] = strike
        for ev, e in enumerate(obs):
            if e >= last:
                continue                     # matured: stays 0
            start = max(e, first)
            pay_mask[ev, t, start:last] = deltas[start:last]
            start_m1[ev, t] = max(start - 1, 0)
            is_fwd[ev, t] = start > e
            alive[ev, t] = 1.0
    return pay_mask, start_m1, is_fwd, alive, end_m1, strikes


def _relative_tables(obs, pay_mask, start_m1, is_fwd, end_m1, dtype, device):
    """Per observation date ``e``, the geometry relative to the live block:
    the pay mask over forwards ``e..n-1`` ``[T, n - e]`` in the path dtype,
    and the rows of ``cp[k] = P(T_e, T_{e+k})`` holding the start bond (0,
    which is 1, unless forward-starting) and the end bond (0 once
    matured, whose coefficient is 0)."""
    tables = []
    for ev, e in enumerate(obs):
        start = np.where(is_fwd[ev], start_m1[ev] + 1 - e, 0)
        end = np.maximum(end_m1 + 1 - e, 0)
        tables.append(dict(
            mask=torch.as_tensor(pay_mask[ev][:, e:], dtype=dtype,
                                 device=device),
            start=torch.as_tensor(start, device=device),
            end=torch.as_tensor(end, device=device)))
    return tables


def _bond_curve(engine: LMMValuationEngine, e: int, L: torch.Tensor,
                N: torch.Tensor, grad_safe: bool = False):
    """``cp[k] = P(T_e, T_{e+k})`` for k = 0..n-e, ``[n - e + 1, paths]``
    in the collect dtype, from the live block ``L`` (forwards ``e..n-1``):
    a leading 1, then the cumulative product of the bond ratios; and the
    dead-path mask (None unless ``grad_safe``).

    ``grad_safe`` (the CVA ladder's reverse mode): the paths that
    ``adjoint_dead_mask`` flags (from ``L`` and, under the spot measure,
    the numeraire ``N``) get forwards of 0.01 before the curve, which is
    formed as exp(cumsum(log r)) so that a row's cotangent reaches only
    the rows before it (the JAX package's ``bond_ratio_cumprod_adjoint``)."""
    cd = engine.collect_dtype
    d = engine._t["deltas64"][e:, None].to(cd)
    Lw = L.to(cd)
    dead = None
    if grad_safe:
        dead = adjoint_dead_mask(Lw, N, d, engine.model.measure == "spot")
        Lw = torch.where(dead[None, :], 0.01, Lw)
        r = 1.0 / (1.0 + d * Lw)
        cp = torch.exp(torch.cumsum(torch.log(torch.clamp_min(r, 1e-30)),
                                    dim=0))
    else:
        cp = torch.cumprod(1.0 / (1.0 + d * Lw), dim=0)
    return torch.cat([torch.ones_like(cp[:1]), cp]), dead


def _inv_numeraire(model, cp, N):
    """1/N(T_e) per path, float64: the spot account ``N`` or, under the
    terminal measure, 1/P(T_e, T_n) from the bond curve."""
    if model.measure == "spot":
        return 1.0 / N.to(ACC_DTYPE)
    return 1.0 / cp[-1].to(ACC_DTYPE)


def _numeraire_adjustment(model, mean_inv, df_obs):
    """The deterministic adjustment E[1/N(T)] -> df(T) per date."""
    if not model.use_numeraire_adjustment:
        return torch.ones_like(mean_inv)
    return torch.where(mean_inv > 0.0, df_obs / mean_inv, 0.0)


def _linear_quantiles(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Quantiles ``qs`` ``[Q]`` of ``x`` along its last axis with linear
    interpolation, ``[Q, *x.shape[:-1]]``: ``torch.quantile``'s arithmetic
    (and ``jnp.quantile``'s default method) from one sort, without
    ``torch.quantile``'s limit of 2**24 input elements, which an
    ``[E, paths]`` profile passes at about 430,000 paths over 39 dates.
    Under a mesh the caller passes the gathered ensemble
    (``parallel.mesh.gather_paths``): every rank then sorts the unsharded
    array, and the quantiles are the unsharded ones bit for bit."""
    s = torch.sort(x, dim=-1).values
    pos = qs * (s.shape[-1] - 1)
    lo = torch.floor(pos)
    below = s.index_select(-1, lo.long())
    above = s.index_select(-1, torch.ceil(pos).long())
    return torch.lerp(below, above, pos - lo).movedim(-1, 0)


def _stack(outs):
    """Per-event collector tuples -> one ``[E, ...]`` tensor per output."""
    return [torch.stack(col) for col in zip(*outs)]


class NettingSetExposureEngine:
    """Exposure profile of a NETTING SET of interest-rate trades (possibly
    forward-starting swaps, European and Bermudan swaptions) observed at
    every tenor date: the trades' pathwise close-out values are summed
    BEFORE the positive part (ISDA close-out netting), and the standalone
    (no-netting) EE sum is collected in the same pass for the netting
    benefit.

    Swap values are curve-analytic in the simulated forwards; swaption
    values before expiry are Longstaff-Schwartz conditional expectations
    (regression on the underlying par rate). One simulation gives the
    whole profile: every trade's V(t)/N(t) at every observation date (one
    ``[trades, n - e] @ [n - e, paths]`` annuity product a date), then all
    regressions and reductions, on the engine's ``device`` (default
    ``select_device()``).

    ``dtype``: the path dtype (None: float32; float64 is the parity
    engine). ``mesh``: a ``parallel.PathMesh``; the engine's paths are
    split over its ranks (the valuation engine's rules: ``num_paths``
    divisible by the world size, its own stream ``rank_seed(seed, rank)``,
    injected ``increments=`` the global array of which each rank keeps its
    block), and every public result is the same on every rank (module
    docstring). ``path_axis`` labels the mesh's axis. ``increments=``
    passes through to the engine.

    ``csa``: optional credit-support annex: EE/ENE/PFE become the RESIDUAL
    exposure after pathwise variation margin (lagged requirement,
    thresholds, MTA, independent amount), and the uncollateralized profile
    comes alongside as ``ee_gross``/``ene_gross``."""

    def __init__(self, model: LIBORMarketModelTorch,
                 trades: Sequence[SwapTrade], num_paths: int = 50_000,
                 num_factors: int = 1, seed: int = 31415,
                 antithetic: bool = False, increments=None,
                 observation_indices: Optional[Sequence[int]] = None,
                 quantiles: Sequence[float] = (0.95, 0.99), dtype=None,
                 mesh=None, path_axis: str = "paths",
                 csa: Optional[CSA] = None, *, device=None):
        n = model.num_libors
        trades = list(trades)
        if not trades:
            raise ValueError("need at least one trade")
        self.swaps = [t for t in trades if isinstance(t, SwapTrade)]
        self.swaptions = [t for t in trades if isinstance(t, SwaptionTrade)]
        self.bermudans = [t for t in trades
                          if isinstance(t, BermudanSwaptionTrade)]
        if (len(self.swaps) + len(self.swaptions) + len(self.bermudans)
                != len(trades)):
            raise ValueError("trades must be SwapTrade, SwaptionTrade or "
                             "BermudanSwaptionTrade")
        for tr in self.swaps:
            if not (1 <= tr.first_index < tr.last_index <= n):
                raise ValueError(f"invalid swap period range in {tr}")
        for tr in self.swaptions:
            if not (1 <= tr.exercise_index and tr.num_periods >= 1
                    and tr.last_index <= n):
                raise ValueError(f"swaption does not fit the grid: {tr}")
            if tr.basis_degree < 1:
                raise ValueError(f"basis_degree must be >= 1 in {tr}")
        for tr in self.bermudans:
            if tr.last_index > n:
                raise ValueError(
                    f"Bermudan does not fit on the tenor grid: {tr}")
            if tr.basis_degree < 1:
                raise ValueError(f"basis_degree must be >= 1 in {tr}")
        if csa is not None and not isinstance(csa, CSA):
            raise TypeError(f"csa must be a CSA, got {type(csa).__name__}")
        self.csa = csa
        self.model = model
        self.trades = trades
        self.quantiles = tuple(float(q) for q in quantiles)
        last = max(tr.last_index for tr in trades)
        if observation_indices is None:
            observation_indices = range(1, last)
        obs = sorted({int(e) for e in observation_indices})
        if not obs or obs[0] < 1 or obs[-1] >= last:
            raise ValueError(
                "observation indices must lie in [1, max(last_index)): "
                "the netting set has no exposure at/after its final payment")
        for tr in self.swaptions:
            if tr.exercise_index not in obs:
                raise ValueError(
                    f"swaption expiry index {tr.exercise_index} must be an "
                    "observation date (its payoff is fixed there)")
        for tr in self.bermudans:
            for x in tr.exercise_indices:
                if x not in obs:
                    raise ValueError(
                        f"Bermudan exercise index {x} must be an "
                        "observation date (the policy decision is taken "
                        "there)")
        self.observation_indices = obs

        # one placeholder product per observation date gives the valuation
        # engine its events at exactly the observation dates (their payoffs
        # are never evaluated: the exposure collector replaces them)
        products = [
            SwaptionProduct(e, last - e, 0.0, 0.0, value_unit="VALUE")
            for e in obs
        ]
        self.engine = LMMValuationEngine(
            model, products, num_paths, num_factors, seed=seed,
            device=device, increments=increments, dtype=_path_dtype(dtype),
            mesh=mesh, path_axis=path_axis, antithetic=antithetic)
        self.device = self.engine.device
        self.mesh = self.engine.mesh

        # the swaps' geometry, and the optionality underlyings' (European
        # swaptions, then Bermudans: the remaining payer swap
        # [max(e, first exercise), last) at every observation), each one
        # batch of one annuity product per date
        deltas = model.deltas
        swap_specs = [(tr.first_index, tr.last_index, tr.strike)
                      for tr in self.swaps]
        und_specs = ([(tr.exercise_index, tr.last_index, tr.strike)
                      for tr in self.swaptions]
                     + [(tr.exercise_indices[0], tr.last_index, tr.strike)
                        for tr in self.bermudans])
        (self._pay_mask_np, self._start_m1_np, self._is_fwd_np,
         sw_alive, self._end_m1_np, self._strikes_np) = _swap_geometry(
            swap_specs, obs, deltas, n)
        self._coef_np = sw_alive * np.asarray(
            [(1.0 if tr.payer else -1.0) * tr.notional
             for tr in self.swaps])[None, :]
        (u_pay_mask, u_start_m1, u_is_fwd, u_alive, u_end_m1,
         u_strikes) = _swap_geometry(und_specs, obs, deltas, n)
        self._ev_x_np = np.asarray(
            [obs.index(tr.exercise_index) for tr in self.swaptions],
            dtype=np.int64)
        dc = model.discount_curve
        self._df_obs_np = np.asarray(
            [float(dc.get_discount_factor(float(model.tenor_times[e])))
             for e in obs])
        self._obs_times = np.asarray(
            [float(model.tenor_times[e]) for e in obs])

        dev, pdt = self.device, self.engine.dtype

        def f64(a):
            return torch.as_tensor(a, dtype=ACC_DTYPE, device=dev)

        self._swap_tables = _relative_tables(
            obs, self._pay_mask_np, self._start_m1_np, self._is_fwd_np,
            self._end_m1_np, pdt, dev)
        self._coef = f64(self._coef_np)
        self._strikes = f64(self._strikes_np)
        self._df_obs = f64(self._df_obs_np)
        # the profile's collector (ops/exposure_collect.py): the dense
        # tables of its plain version, the kernel's packed table
        rows, reals, counts = pack_rows(obs, swap_specs, self._coef_np,
                                        und_specs, dev)
        K = len(und_specs)
        self._collect_plan = CollectPlan(
            dates=tuple(obs), deltas=self.engine._t["deltas64"],
            swap_tables=self._swap_tables, swap_strikes=self._strikes,
            swap_coefs=self._coef,
            und_tables=(_relative_tables(obs, u_pay_mask, u_start_m1,
                                         u_is_fwd, u_end_m1, pdt, dev)
                        if K else None),
            und_strikes=f64(u_strikes) if K else None,
            und_alive=f64(u_alive) if K else None,
            rows=rows, reals=reals, counts=counts, path_dtype=pdt,
            collect_dtype=self.engine.collect_dtype,
            spot=model.measure == "spot")
        self._qs = f64(self.quantiles)
        #: regressions the last ``profile`` fitted
        self.regressions = 0

    def reseed(self, seed: int) -> None:
        """Price every later call on fresh paths: the engine's increments
        redrawn on the device from ``seed`` (``LMMValuationEngine.reseed``:
        bit for bit those of an engine built with that seed), every
        per-date table kept."""
        self.engine.reseed(seed)

    # ------------------------------------------------------------------
    def _collect(self, e, ev, L, N):
        """Pathwise (netted swap V(t) in units of time t, standalone swap
        positive-part sum, swaption-underlying values, underlying par
        rates, 1/N(t)) at the observation with ordinal ``ev`` (tenor index
        ``e``): the plain version of the collector
        (``ops.exposure_collect.exposure_collect_reference``)."""
        return exposure_collect_reference(L, N, self._collect_plan, ev)

    def _simulate_into(self, x: torch.Tensor):
        """One simulation: the netted value, the standalone positive-part
        sum and 1/N ``[E, paths]`` float64, and with optionality the
        underlyings' values ``[E, K, paths]`` float64 and par rates in the
        path dtype (the regressions' feature, which they read in that
        dtype), written date by date into buffers (a stacked list of these
        would hold them twice). A path whose outputs at a date are not all
        finite reads 0 in each of them there
        (``ops.exposure_collect.zero_broken``)."""
        eng = self.engine
        out = collect_buffers(self._collect_plan, eng._local_paths,
                              self.device)

        def collect(e, ev, L, N):
            # one launch of the collector kernel on the card, the plain
            # version on the CPU
            with span("finmath.xva.collect", kernel=L.is_cuda):
                exposure_collect(L, N, self._collect_plan, ev, out)

        eng._simulate_collect(x, collect)
        zero_broken(out)
        return [out.net, out.plus, out.inv] + (
            [out.und, out.rates] if out.und is not None else [])

    def _profile_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``[4 (+2 with a CSA) + Q, E]`` float64: EE, ENE, forward value,
        standalone EE (, gross EE, gross ENE), then the PFE rows."""
        eng = self.engine
        model = self.model
        E_n = len(self.observation_indices)
        K_eur = len(self.swaptions)
        mesh = self.mesh
        regressions = 0
        with span("finmath.xva.simulate"):
            collected = self._simulate_into(x)
            v_t, s_plus, inv_n = collected[:3]
            if len(collected) > 3:
                v_und, srate = collected[3:]
            if model.measure != "spot":
                inv_n = inv_n * eng._p0_terminal
            adj = _numeraire_adjustment(model, path_mean(inv_n, mesh),
                                        self._df_obs)
            disc = inv_n * adj[:, None]

        def add(c_disc):
            nonlocal v_disc, s_plus_disc, v_undisc
            v_disc = v_disc + c_disc
            s_plus_disc = s_plus_disc + torch.clamp_min(c_disc, 0.0)
            v_undisc = v_undisc + torch.where(disc > 0.0, c_disc / disc, 0.0)

        def bases_of(k, degree, dates):
            """``[dates, degree + 1, paths]``: the monomials of underlying
            k's par rate (the path dtype) at the first ``dates`` dates; a
            date's row is that date's regression basis."""
            feature = srate[:dates, k]
            return torch.stack([feature ** d for d in range(degree + 1)],
                               dim=1)

        def fit(basis, y):
            """The regression's coefficients (the normal equations summed
            over the ranks under a mesh), counted."""
            nonlocal regressions
            regressions += 1
            return regression_fit(basis, y, mesh=mesh)

        def fitted(basis, y):
            """The regressed conditional expectation, float64."""
            return regression_predict(basis, fit(basis, y)).to(ACC_DTYPE)

        with span("finmath.xva.regress"):
            # observation ordinals as a column, against a path's stopping
            # ordinal
            ev_rows = torch.arange(E_n, dtype=torch.int32,
                                   device=disc.device)[:, None]
            v_disc = v_t * disc                               # today's money
            s_plus_disc = s_plus * disc
            v_undisc = v_t                                    # t-money (PFE)

            for k, tr in enumerate(self.swaptions):
                # discounted close-out value of swaption k at each observation:
                # the regressed conditional expectation before expiry, the
                # intrinsic value at expiry, then the exercised swap (physical)
                # or nothing (cash)
                evx = int(self._ev_x_np[k])
                h_disc = torch.clamp_min(v_und[evx, k], 0.0) * disc[evx]
                exercised = v_und[evx, k] > 0.0
                bases = bases_of(k, tr.basis_degree, evx)
                rows = [torch.clamp_min(fitted(bases[ev], h_disc), 0.0)
                        for ev in range(evx)] + [h_disc]
                if tr.physical:
                    after = torch.where(exercised,
                                        v_und[evx + 1:, k] * disc[evx + 1:],
                                        0.0)
                else:
                    after = torch.zeros_like(disc[evx + 1:])
                add(tr.notional * torch.cat([torch.stack(rows), after]))
            for kb, tr in enumerate(self.bermudans):
                # Longstaff-Schwartz backward induction fits the exercise
                # policy over the exercise dates; every path then carries its
                # stopping ordinal tau, and the close-out value at each date is
                # (physical) the live underlying swap on paths with tau <= ev,
                # plus the regressed continuation value on the alive paths
                u0 = K_eur + kb
                xs = [self.observation_indices.index(x)
                      for x in tr.exercise_indices]           # obs ordinals
                M = len(xs)
                bases = bases_of(u0, tr.basis_degree, xs[-1] + 1)
                z = [v_und[xs[m], u0] * disc[xs[m]] for m in range(M)]
                # all-paths regressions (the BermudanSwaptionPricer
                # convention): dec[m] = exercise at m if alive; y_from[m] = the
                # policy's discounted stopped payoff from exercise date m on
                dec, cont, y_from = [None] * M, [None] * M, [None] * M
                dec[M - 1] = z[M - 1] > 0.0
                cont[M - 1] = torch.zeros_like(z[M - 1])
                y_from[M - 1] = torch.clamp_min(z[M - 1], 0.0)
                for m in reversed(range(M - 1)):
                    cont[m] = fitted(bases[xs[m]], y_from[m + 1])
                    dec[m] = (z[m] > 0.0) & (z[m] > cont[m])
                    y_from[m] = torch.where(dec[m], z[m], y_from[m + 1])
                # stopping ordinal per path (E_n = never exercised); the first
                # exercise wins, matching y_from
                tau = torch.full_like(z[0], E_n, dtype=torch.int32)
                for m in reversed(range(M)):
                    tau = torch.where(dec[m], xs[m], tau)
                # exercised leg, all dates at once: the underlying's
                # remaining periods live on exercised paths (physical), or
                # only at the settlement instant (cash)
                live = v_und[:, u0] * disc                    # [E, paths]
                stopped = (tau <= ev_rows) if tr.physical else (tau == ev_rows)
                ex_val = torch.where(stopped, live, 0.0)
                # alive leg, a date at a time to the last exercise date: the
                # regressed continuation value, floored (a long option's
                # close-out value is nonnegative); nothing after it
                alive_vals = []
                for ev in range(xs[-1] + 1):
                    next_m = next(m for m in range(M) if xs[m] >= ev)
                    if xs[next_m] == ev:
                        alive_vals.append(torch.clamp_min(cont[next_m], 0.0))
                    elif next_m == 0:
                        # before the first exercise date every path is alive
                        alive_vals.append(torch.clamp_min(
                            fitted(bases[ev], y_from[0]), 0.0))
                    else:
                        # between exercise dates: the normal equations of the
                        # alive paths only (an exercised path's stopped payoff
                        # is no longer a sample of the option's future value)
                        alive = tau > ev
                        w = alive.to(bases.dtype)
                        pred = regression_predict(bases[ev], fit(
                            bases[ev] * w,
                            torch.where(alive, y_from[next_m], 0.0)))
                        alive_vals.append(
                            torch.clamp_min(pred.to(ACC_DTYPE), 0.0))
                alive_val = torch.cat([torch.stack(alive_vals),
                                       torch.zeros_like(live[xs[-1] + 1:])])
                add(tr.notional * (ex_val + torch.where(tau > ev_rows,
                                                        alive_val, 0.0)))
        extra_rows = []
        if self.csa is not None:
            with span("finmath.xva.margin"):
                # pathwise variation margin on the observation grid in time-t
                # money: the requirement from the LAGGED netted value (margin
                # period of risk), the MTA applied date by date along the grid
                c = self.csa
                lag = int(c.margin_lag)
                if lag > 0:
                    v_lag = torch.cat([torch.zeros_like(v_undisc[:lag]),
                                       v_undisc[:-lag]], dim=0)
                else:
                    v_lag = v_undisc
                req = (torch.clamp_min(v_lag - c.threshold, 0.0)
                       - torch.clamp_min(-v_lag - c.threshold_own, 0.0))
                if c.mta > 0.0:
                    bal, held = torch.zeros_like(req[0]), []
                    for target in req:
                        bal = torch.where(torch.abs(target - bal) >= c.mta,
                                          target, bal)
                        held.append(bal)
                    coll = torch.stack(held)
                else:
                    coll = req
                expo_u = v_undisc - coll - c.independent_amount
                e_disc = expo_u * disc
                extra_rows = [torch.clamp_min(v_disc, 0.0),
                              torch.clamp_max(v_disc, 0.0)]
                pfe_src = expo_u
        else:
            e_disc = v_disc
            pfe_src = v_undisc
        with span("finmath.xva.reduce"):
            # EE, ENE, forward value, standalone EE (, gross EE and ENE): one
            # all-reduce under a mesh
            means = path_means([torch.clamp_min(e_disc, 0.0),
                                torch.clamp_max(e_disc, 0.0), v_disc,
                                s_plus_disc] + extra_rows, mesh)
            pfe = _linear_quantiles(gather_paths(pfe_src, mesh),
                                    self._qs)  # [Q, E], t-money
            rows = torch.cat([torch.stack(means), pfe], dim=0)
        self.regressions = regressions
        return rows

    # ------------------------------------------------------------------
    def profile(self, params) -> ExposureProfile:
        """Full dated exposure profile at covariance parameters ``params``:
        one simulation, one transfer to the host, inside the span
        ``finmath.xva.profile`` (module docstring)."""
        with span("finmath.xva.profile", trades=len(self.trades),
                  swaptions=len(self.swaptions),
                  bermudans=len(self.bermudans),
                  dates=len(self.observation_indices),
                  paths=self.engine.num_paths) as sp, torch.no_grad():
            arr = self._profile_rows(self.engine._params(params)).cpu().numpy()
            sp.set(regressions=self.regressions)
        q0 = 6 if self.csa is not None else 4
        return ExposureProfile(
            times=self._obs_times.copy(),
            ee=arr[0],
            ene=arr[1],
            forward_value=arr[2],
            pfe={q: arr[q0 + i] for i, q in enumerate(self.quantiles)},
            ee_standalone=arr[3],
            ee_gross=arr[4] if self.csa is not None else None,
            ene_gross=arr[5] if self.csa is not None else None,
        )

    # ------------------------------------------------------------------
    def analytic_forward_values(self) -> np.ndarray:
        """t=0 curve value of the SWAP trades' remaining periods at each
        observation date: the analytic martingale benchmark for
        ``ExposureProfile.forward_value``. Swaption trades are excluded (no
        curve-analytic value; their martingale diagnostic is the constancy
        of the regressed forward value up to expiry), so for mixed sets
        compare against a swap-only profile."""
        model = self.model
        dc = model.discount_curve
        fc = model.forward_curve
        tenor = model.tenor_times
        deltas = model.deltas
        out = []
        for e in self.observation_indices:
            v = 0.0
            for tr in self.swaps:
                if e >= tr.last_index:
                    continue
                sign = 1.0 if tr.payer else -1.0
                for j in range(max(e, tr.first_index), tr.last_index):
                    f = float(fc.get_forward(tenor[j]))
                    v += sign * tr.notional * deltas[j] * (f - tr.strike) \
                        * float(dc.get_discount_factor(tenor[j + 1]))
            out.append(v)
        return np.asarray(out)

    # ------------------------------------------------------------------
    def cva(self, params, hazard_rate: Optional[float] = None,
            recovery: float = 0.4,
            default_probabilities: Optional[Sequence[float]] = None
            ) -> float:
        """Unilateral CVA, ``(1 - R) * sum_i EE(t_i) * PD(t_{i-1}, t_i]``
        over the observation grid (see ``cva_from_profile``): EITHER a flat
        ``hazard_rate`` OR explicit per-interval
        ``default_probabilities``."""
        return cva_from_profile(self.profile(params), hazard_rate,
                                recovery, default_probabilities)

    # ------------------------------------------------------------------
    def _cva_value(self, x, fwd0, pd):
        """CVA as a differentiable scalar of the initial forwards ``fwd0``:
        the profile's swap collector in its adjoint-safe form (dead paths
        masked before every reciprocal, the log-form bond curve; see
        ``_bond_curve``) on the engine's ``grad_safe`` sweep."""
        eng = self.engine
        model = self.model
        mesh = self.mesh
        spot = model.measure == "spot"
        if mesh is not None:
            # the replicated inputs' gradients collect every rank's paths
            fwd0 = replicated(fwd0, mesh)

        def collect(e, ev, L, N):
            cp, dead = _bond_curve(eng, e, L, N, grad_safe=True)
            # a safe primal before the reciprocal: its partial stays
            # finite on dead paths
            inv_n = 1.0 / torch.where(
                dead, 1.0, (N if spot else cp[-1]).to(ACC_DTYPE))
            raw, _ = swap_values(cp, self._swap_tables[ev], self._strikes,
                                 eng.dtype)
            v_net = torch.sum(self._coef[ev][:, None] * raw, dim=0)
            return (torch.where(dead, 0.0, v_net),
                    torch.where(dead, 0.0, inv_n))

        v_t, inv_n = _stack(eng._simulate_collect(x, collect, fwd0=fwd0,
                                                  grad_safe=True))
        finite = torch.isfinite(v_t) & torch.isfinite(inv_n)
        v_t = torch.where(finite, v_t, 0.0)
        inv_n = torch.where(finite, inv_n, 0.0)
        if not spot:
            # the fwd0-differentiable P(0, T_n), not the host constant
            inv_n = inv_n * torch.prod(1.0 / (1.0 + eng._t["deltas64"]
                                              * fwd0))
        mean_inv = path_mean(inv_n, mesh)
        if mesh is not None:
            # a global mean inside the per-path function: its cotangent is
            # one rank's partial, so it is all-reduced on its way back
            mean_inv = replicated(mean_inv, mesh)
        adj = _numeraire_adjustment(model, mean_inv, self._df_obs)
        v_disc = v_t * inv_n * adj[:, None]
        ee = path_mean(torch.clamp_min(v_disc, 0.0), mesh)
        return torch.sum(pd * ee)

    def cva_forward_deltas(self, params,
                           hazard_rate: Optional[float] = None,
                           recovery: float = 0.4,
                           default_probabilities=None):
        """CVA delta ladder ``(cva, dCVA/dL0 [num_libors])``: the
        sensitivity of the credit valuation adjustment to every
        forward-curve bucket from ONE reverse pass through the simulation
        and the exposure profile (curves and discounting held fixed, the
        bump semantics of ``LMMValuationEngine.forward_deltas``). Under a
        mesh the initial forwards and the numeraire mean enter each rank's
        paths through ``parallel.replicated`` and the path sums leave
        through ``sum_over_ranks``, so the ladder is the whole one on every
        rank."""
        if self.swaptions or self.bermudans:
            raise NotImplementedError(
                "cva_forward_deltas currently covers swap-only netting "
                "sets (the adjoint-safe delta core does not regress "
                "swaption conditional values)")
        if self.csa is not None:
            raise NotImplementedError(
                "cva_forward_deltas differentiates the UNCOLLATERALIZED "
                "CVA (the adjoint core does not model the margin "
                "balance); build the engine without a CSA")
        pd = _default_probability_vector(self._obs_times, hazard_rate,
                                         default_probabilities)
        pd = torch.as_tensor((1.0 - float(recovery)) * pd, dtype=ACC_DTYPE,
                             device=self.device)
        x, fwd0 = self.engine._delta_inputs(params)
        with torch.enable_grad():
            value = self._cva_value(x, fwd0, pd)
            (grad,) = torch.autograd.grad(value, fwd0)
        return float(value.detach()), grad.cpu().numpy()

    # ------------------------------------------------------------------
    def _im_rows(self, x, quantile: float, mpr: float, degree: int):
        """Dynamic IM ``[2, E-1]`` (discounted, undiscounted): the
        conditional variance of the netting set's CLEAN one-period P&L by
        least-squares regression on the netted value, Brownian-scaled from
        the observation interval to the margin period of risk, mapped to
        the Gaussian ``quantile``.

        Clean P&L over [t_i, t_{i+1}]: ``V(t_{i+1}) + CF_{i+1} - V(t_i)``
        with ``CF_{i+1}`` the period-i payment fixed at t_i, added back so
        that the known cashflow roll-off does not pass for risk; the
        deterministic accrual of V(t_i) drops out of the conditional
        variance, which is all IM uses."""
        eng = self.engine
        model = self.model
        obs = self.observation_indices
        E_n = len(obs)
        # the payment fixed at observation i (period e_i, paid at T_{i+1})
        # is a_i L_{e_i}(t_i) - b_i over the trades whose schedule still
        # holds period e_i
        a_np, b_np = np.zeros(E_n), np.zeros(E_n)
        for i, e in enumerate(obs):
            w = self._coef_np[i] * self._pay_mask_np[i, :, e]
            a_np[i] = w.sum()
            b_np[i] = (w * self._strikes_np).sum()
        dev = self.device
        a_cf, b_cf = (torch.as_tensor(v, dtype=ACC_DTYPE, device=dev)
                      for v in (a_np, b_np))
        scale = torch.as_tensor(
            float(NormalDist().inv_cdf(quantile))
            * np.sqrt(mpr / np.diff(self._obs_times)),
            dtype=ACC_DTYPE, device=dev)                          # [E-1]

        def collect(e, ev, L, N):
            cp, _ = _bond_curve(eng, e, L, N)
            raw, _ = swap_values(cp, self._swap_tables[ev], self._strikes,
                                 eng.dtype)
            v_net = torch.sum(self._coef[ev][:, None] * raw, dim=0)
            return v_net, L[0].to(ACC_DTYPE), _inv_numeraire(model, cp, N)

        v_t, fix, inv_n = _stack(eng._simulate_collect(x, collect))
        finite = (torch.isfinite(v_t) & torch.isfinite(fix)
                  & torch.isfinite(inv_n))
        v_t = torch.where(finite, v_t, 0.0)
        fix = torch.where(finite, fix, 0.0)
        inv_n = torch.where(finite, inv_n, 0.0)
        if model.measure != "spot":
            inv_n = inv_n * eng._p0_terminal
        mesh = self.mesh
        adj = _numeraire_adjustment(model, path_mean(inv_n, mesh),
                                    self._df_obs)
        disc = inv_n * adj[:, None]
        cf = a_cf[:, None] * fix - b_cf[:, None]                  # [E, paths]
        pnl = v_t[1:] + cf[:-1] - v_t[:-1]                        # [E-1, paths]
        im_disc, im_t = [], []
        for i in range(E_n - 1):
            xv = v_t[i]
            mu = path_mean(xv, mesh)
            sd = torch.sqrt(torch.clamp_min(path_mean((xv - mu) ** 2, mesh),
                                            1e-30))
            xn = ((xv - mu) / sd).to(eng.dtype)
            basis = torch.stack([xn ** k for k in range(degree + 1)])
            y = pnl[i]
            m1 = regression_predict(
                basis, regression_fit(basis, y, mesh=mesh)).to(ACC_DTYPE)
            m2 = regression_predict(
                basis, regression_fit(basis, y * y, mesh=mesh)).to(ACC_DTYPE)
            im_i = scale[i] * torch.sqrt(torch.clamp_min(m2 - m1 * m1, 0.0))
            im_disc.append(im_i * disc[i])
            im_t.append(im_i)
        means = path_means(im_disc + im_t, mesh)        # one all-reduce
        return torch.stack([torch.stack(means[:E_n - 1]),
                            torch.stack(means[E_n - 1:])])

    def im_profile(self, params, quantile: float = 0.99,
                   mpr: float = 14.0 / 365.0,
                   basis_degree: int = 2) -> IMProfile:
        """Dynamic initial-margin profile: at every observation date but the
        last, the Gaussian ``quantile`` of the netting set's clean P&L over
        a margin period of risk ``mpr`` (years), conditional on the date's
        information by least-squares regression (see ``_im_rows``): one
        simulation, one transfer. Feed the result to
        ``mva_from_im_profile``."""
        if self.swaptions or self.bermudans:
            raise NotImplementedError(
                "im_profile currently covers swap-only netting sets")
        if not 0.5 < quantile < 1.0:
            raise ValueError("quantile must lie in (0.5, 1)")
        if mpr <= 0.0:
            raise ValueError("mpr must be positive (years)")
        if basis_degree < 1:
            raise ValueError("basis_degree must be >= 1")
        obs = self.observation_indices
        if len(obs) < 2 or any(np.diff(obs) != 1):
            raise ValueError(
                "im_profile needs consecutive observation indices (the "
                "clean-P&L cashflow add-back assumes one period fixes "
                "between adjacent observations)")
        with torch.no_grad():
            arr = self._im_rows(self.engine._params(params), float(quantile),
                                float(mpr), int(basis_degree)).cpu().numpy()
        return IMProfile(
            times=self._obs_times[:-1].copy(),
            expected_im=arr[0],
            expected_im_tmoney=arr[1],
            dts=np.diff(self._obs_times),
            quantile=float(quantile),
            mpr=float(mpr),
        )

    def mva(self, params, im_spread, quantile: float = 0.99,
            mpr: float = 14.0 / 365.0,
            counterparty_hazard_rate: float = 0.0,
            own_hazard_rate: float = 0.0) -> float:
        """Margin valuation adjustment of the netting set: the dynamic IM
        profile integrated against the IM funding spread (see
        ``mva_from_im_profile``)."""
        return mva_from_im_profile(
            self.im_profile(params, quantile=quantile, mpr=mpr),
            im_spread, counterparty_hazard_rate, own_hazard_rate)


class SwapExposureEngine(NettingSetExposureEngine):
    """Exposure profile of a single (possibly forward-starting) swap over
    periods ``[first_index, last_index)`` at fixed rate ``strike``: the
    one-trade netting set.

    ``payer=True``: we receive float and pay fixed (exposure rises with
    rates); ``payer=False`` mirrors the sign."""

    def __init__(self, model: LIBORMarketModelTorch, first_index: int,
                 last_index: int, strike: float, payer: bool = True,
                 notional: float = 1.0, num_paths: int = 50_000,
                 num_factors: int = 1, seed: int = 31415,
                 antithetic: bool = False, increments=None,
                 observation_indices: Optional[Sequence[int]] = None,
                 quantiles: Sequence[float] = (0.95, 0.99), dtype=None,
                 mesh=None, path_axis: str = "paths",
                 csa: Optional[CSA] = None, *, device=None):
        n = model.num_libors
        if not (1 <= first_index < last_index <= n):
            raise ValueError("invalid swap period range")
        self.first_index = int(first_index)
        self.last_index = int(last_index)
        self.strike = float(strike)
        self.payer = bool(payer)
        self.notional = float(notional)
        super().__init__(
            model,
            [SwapTrade(first_index, last_index, strike, payer, notional)],
            num_paths=num_paths, num_factors=num_factors, seed=seed,
            antithetic=antithetic, increments=increments,
            observation_indices=observation_indices, quantiles=quantiles,
            dtype=dtype, mesh=mesh, path_axis=path_axis, csa=csa,
            device=device)


class SwaptionExposureEngine:
    """Exposure profile of a European (payer) swaption, whose value is not
    analytic in the time-t curve: before expiry it is a conditional
    expectation, estimated pathwise by least-squares regression on the
    time-t par rate of the underlying (Longstaff-Schwartz; finmath-lib's
    ``ExposureEstimator`` over ``MonteCarloConditionalExpectation
    Regression``), on the engine's ``device`` (default
    ``select_device()``).

    ``physical=True``: exercise at ``T_x`` into the underlying swap on the
    in-the-money paths, so exposure continues on the exercised swap until
    its final payment (and can go NEGATIVE: the exercised swap is a
    two-way obligation). ``physical=False`` (cash settlement): exposure
    dies at expiry.

    As ``SwapExposureEngine``; besides, ``ee`` uses the FLOORED regression
    estimate ``max(E[H|F_t], 0)`` before expiry, and ``forward_value`` the
    RAW regression mean: with a constant in the basis least squares
    preserves the mean, so ``forward_value`` is CONSTANT (= the swaption
    value) at every observation up to expiry."""

    def __init__(self, model: LIBORMarketModelTorch, exercise_index: int,
                 num_periods: int, strike: float, physical: bool = True,
                 notional: float = 1.0, num_paths: int = 50_000,
                 num_factors: int = 1, seed: int = 31415,
                 antithetic: bool = False, increments=None,
                 basis_degree: int = 2,
                 quantiles: Sequence[float] = (0.95, 0.99), dtype=None,
                 *, device=None):
        n = model.num_libors
        x, m = int(exercise_index), int(num_periods)
        if not (1 <= x and m >= 1 and x + m <= n):
            raise ValueError("swaption does not fit on the tenor grid")
        if basis_degree < 1:
            raise ValueError("basis_degree must be >= 1")
        self.model = model
        self.exercise_index = x
        self.num_periods = m
        self.strike = float(strike)
        self.physical = bool(physical)
        self.notional = float(notional)
        self.basis_degree = int(basis_degree)
        self.quantiles = tuple(float(q) for q in quantiles)
        last = x + m
        obs = list(range(1, last if physical else x + 1))
        self.observation_indices = obs
        self._ev_x = obs.index(x)

        products = [
            SwaptionProduct(e, last - e, self.strike, 0.0,
                            value_unit="VALUE")
            for e in obs
        ]
        self.engine = LMMValuationEngine(
            model, products, num_paths, num_factors, seed=seed,
            device=device, increments=increments, dtype=_path_dtype(dtype),
            antithetic=antithetic)
        self.device = self.engine.device

        # the underlying's remaining periods [max(e, x), last) at each
        # observation: a forward-starting swap with first_index = x
        pay_mask, start_m1, is_fwd, _, end_m1, _ = _swap_geometry(
            [(x, last, self.strike)], obs, model.deltas, n)
        self._tables = _relative_tables(obs, pay_mask, start_m1, is_fwd,
                                        end_m1, self.engine.dtype,
                                        self.device)
        self._strikes = torch.as_tensor([self.strike], dtype=ACC_DTYPE,
                                        device=self.device)
        dc = model.discount_curve
        self._df_obs_np = np.asarray(
            [float(dc.get_discount_factor(float(model.tenor_times[e])))
             for e in obs])
        self._obs_times = np.asarray(
            [float(model.tenor_times[e]) for e in obs])
        self._df_obs = torch.as_tensor(self._df_obs_np, dtype=ACC_DTYPE,
                                       device=self.device)
        self._qs = torch.as_tensor(self.quantiles, dtype=ACC_DTYPE,
                                   device=self.device)
        #: regressions the last ``profile`` fitted
        self.regressions = 0

    # ------------------------------------------------------------------
    def _collect(self, e, ev, L, N):
        """(V_swap(t) in units of time t, 1/N(t), par rate of the remaining
        underlying) at the observation with ordinal ``ev``."""
        cp, _ = _bond_curve(self.engine, e, L, N)
        raw, ann = swap_values(cp, self._tables[ev], self._strikes,
                               self.engine.dtype)
        v_t, ann = raw[0], ann[0]                                  # [paths]
        srate = (v_t + self.strike * ann) / torch.clamp_min(ann, 1e-12)
        return v_t, _inv_numeraire(self.model, cp, N), srate

    def _profile_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``[3 + Q, E]`` float64: EE, ENE, forward value, PFE rows."""
        eng = self.engine
        with span("finmath.xva.simulate"):
            v_t, inv_n, srate = _stack(eng._simulate_collect(
                x, self._collect))
        self.regressions = self._ev_x
        finite = (torch.isfinite(v_t) & torch.isfinite(inv_n)
                  & torch.isfinite(srate))
        v_t = torch.where(finite, v_t, 0.0)
        inv_n = torch.where(finite, inv_n, 0.0)
        srate = torch.where(finite, srate, 0.0)
        if self.model.measure != "spot":
            inv_n = inv_n * eng._p0_terminal
        adj = _numeraire_adjustment(self.model, inv_n.mean(dim=-1),
                                    self._df_obs)
        scale = self.notional
        ev_x = self._ev_x
        # discounted exercise value (today's money) and the exercise set
        h_disc = (torch.clamp_min(v_t[ev_x], 0.0)
                  * inv_n[ev_x] * adj[ev_x] * scale)              # [paths]
        exercised = v_t[ev_x] > 0.0
        ee, ene, fwd, pfe = [], [], [], []
        for ev in range(len(self.observation_indices)):
            if ev < ev_x:
                # the discounted payoff regressed on the underlying's par
                # rate at this observation
                feature = srate[ev].to(eng.dtype)
                basis = torch.stack([feature ** k
                                     for k in range(self.basis_degree + 1)])
                pred = regression_predict(
                    basis, regression_fit(basis, h_disc)).to(ACC_DTYPE)
                expo = torch.clamp_min(pred, 0.0)
                fwd.append(pred.mean())
            elif ev == ev_x:
                expo = h_disc
                fwd.append(h_disc.mean())
            else:
                # physical exercise: the swap lives on the exercised paths
                expo = torch.where(exercised,
                                   v_t[ev] * inv_n[ev] * adj[ev] * scale, 0.0)
                fwd.append(expo.mean())
            ee.append(torch.clamp_min(expo, 0.0).mean())
            ene.append(torch.clamp_max(expo, 0.0).mean())
            # undiscounted time-t exposure for the PFE quantiles
            undisc = torch.where(inv_n[ev] > 0.0,
                                 expo / (inv_n[ev] * adj[ev]), 0.0)
            pfe.append(_linear_quantiles(undisc, self._qs))
        return torch.cat([torch.stack([torch.stack(ee), torch.stack(ene),
                                       torch.stack(fwd)]),
                          torch.stack(pfe, dim=-1)], dim=0)

    # ------------------------------------------------------------------
    def profile(self, params) -> ExposureProfile:
        """Full dated exposure profile: one simulation (all regressions and
        reductions on the device), one transfer to the host, inside the
        span ``finmath.xva.profile``."""
        with span("finmath.xva.profile", trades=1, swaptions=1, bermudans=0,
                  dates=len(self.observation_indices),
                  paths=self.engine.num_paths) as sp, torch.no_grad():
            arr = self._profile_rows(self.engine._params(params)).cpu().numpy()
            sp.set(regressions=self.regressions)
        return ExposureProfile(
            times=self._obs_times.copy(),
            ee=arr[0],
            ene=arr[1],
            forward_value=arr[2],
            pfe={q: arr[3 + i] for i, q in enumerate(self.quantiles)},
        )

    # ------------------------------------------------------------------
    def cva(self, params, hazard_rate: Optional[float] = None,
            recovery: float = 0.4,
            default_probabilities: Optional[Sequence[float]] = None
            ) -> float:
        """Unilateral CVA of the swaption (see ``cva_from_profile``)."""
        return cva_from_profile(self.profile(params), hazard_rate,
                                recovery, default_probabilities)
