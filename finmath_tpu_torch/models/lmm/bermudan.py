"""Bermudan swaption by Longstaff-Schwartz on the LMM engine, with
duality bounds.

Counterpart of ``finmath_tpu.models.lmm.bermudan`` (BASELINE
configuration 3, ``bench.py:982 bench_bermudan``). The pricer runs the
engine's simulation once (``LMMValuationEngine._simulate_collect``),
collects the discounted swap value and the regression features at each
exercise date, and runs the backward induction as a fixed chain of float64
regression solves (``ops.conditional_expectation``) and ``torch.where``
selections over the path axis, on the engine's device.

Measure: spot (cash flows discounted by the rolling account) or terminal
(discounted by the zero bond P(T_e, T_n), read off the live bond curve,
and the value scaled by P(0, T_n)), as the JAX pricer does.

Precision: the collector forms the bond ratios, their cumulative product,
the annuity (a float32 product, TF32 off), the swap value and the
features in float32, and the discounted values ``z = swap / N`` and
``h = max(z, 0)`` in float64 (the numeraire is float64), exactly as the
JAX collector does. The port's European collector works in float64
instead, but the exercise decision ``z > continuation`` is a
discontinuity: with the JAX package's arithmetic a path can decide
differently in the two packages only where the two sides lie within
float32 rounding of each other, so the prices agree pathwise up to such
near-ties.

Accuracy (the estimate is bounded from both sides):

* lower bound: the policy fitted on one path set, applied to an
  independent one (engine seed + 1); any fixed policy is sub-optimal, so
  the out-of-sample value is biased low;
* upper bound: Haugh-Kogan duality, V_0 <= E[max_e (h_e - M_e)] for any
  martingale M, built from the same regression's value surrogates
  (M_e = M_{e-1} + Vhat_e - Chat_{e-1}) on the independent path set.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.conditional_expectation import regression_fit, regression_predict
from ...ops.random_variable import ACC_DTYPE, FLOAT_DTYPE
from .model import LIBORMarketModelTorch, LMMValuationEngine, SwaptionProduct


@dataclass(frozen=True)
class BermudanSwaption:
    """Right to enter, at any exercise date T_e (e in exercise_indices),
    the payer swap running from T_e to T_maturity at the given strike."""

    exercise_indices: tuple       # tenor indices, ascending
    maturity_index: int           # tenor index of the final payment
    strike: float

    def __post_init__(self):
        if any(e >= self.maturity_index for e in self.exercise_indices):
            raise ValueError("every exercise must precede maturity")


class BermudanSwaptionPricer:
    """(model, product, paths, factors, seed) -> Bermudan value of the
    covariance parameter vector, on one device: the pricing and the bounds
    engines draw their paths from ``seed`` and ``seed + 1`` on ``device``
    (default ``select_device()``)."""

    def __init__(self, model: LIBORMarketModelTorch, product: BermudanSwaption,
                 num_paths: int, num_factors: int, seed: int = 31415,
                 basis_degree: int = 2, *, device=None):
        self.model = model
        self.product = product
        self.num_paths = int(num_paths)
        self.num_factors = int(num_factors)
        self.seed = int(seed)
        self.basis_degree = int(basis_degree)
        # the exercise dates posed as the engine's exercise events
        dummy = [SwaptionProduct(e, product.maturity_index - e,
                                 product.strike, 0.0)
                 for e in product.exercise_indices]
        self._engine = LMMValuationEngine(
            model, dummy, num_paths, num_factors, seed, device=device)
        self._bounds_engine = None

    # ------------------------------------------------------------------
    def _collect_exercise_data(self, engine, params) -> list:
        """Simulate once; per exercise date (z, h, features): the
        discounted payer swap value (not floored, float64), the exercise
        payoff h = max(z, 0) and the regression basis {1, annuity, swap,
        swap^2, ...} [B, paths] float32. Under the terminal measure the
        numeraire is P(T_e, T_n), the float32 bond curve's last row."""
        d32 = engine._t["deltas32"]
        strike = self.product.strike
        mat = self.product.maturity_index
        spot = self.model.measure == "spot"

        def collect(e, ev, L, N):
            # L holds the forwards from e on: rows e..mat-1 reach the swap
            d = d32[e:mat]
            cp = torch.cumprod(1.0 / (1.0 + d[:, None] * L[:mat - e]), dim=0)
            p_end = cp[-1]                                # P(T_e, T_mat)
            ann = d @ cp
            swap_value = 1.0 - p_end - strike * ann       # payer swap at T_e
            if not spot:
                # the numeraire P(T_e, T_n) from the whole live curve
                d_all = d32[e:e + L.shape[0]]
                N = torch.cumprod(1.0 / (1.0 + d_all[:, None] * L),
                                  dim=0)[-1]
            return swap_value, ann, p_end, N

        data = []
        for swap_value, ann, p_end, N in engine._simulate_collect(
                params, collect):
            z = swap_value * (1.0 / N)          # float64 (spot), float32
            # a wild float32 path (accrual near the -1/delta pole or past
            # the +-1e3 clamp) makes the bond curve inf - inf, and a
            # finite but astronomical one overflows the squared feature:
            # drop the path's exercise value and features, as the
            # valuation collector's finite mask does; unit-notional swap
            # values beyond +-1e4 carry no price information
            finite = (torch.isfinite(z) & torch.isfinite(swap_value)
                      & torch.isfinite(ann) & torch.isfinite(p_end)
                      & (torch.abs(z) < 1e4) & (torch.abs(swap_value) < 1e4)
                      & (torch.abs(ann) < 1e4) & (torch.abs(p_end) < 1e4))
            z = torch.where(finite, z, 0.0)
            swap_value = torch.where(finite, swap_value, 0.0)
            h = torch.clamp_min(z, 0.0)
            # p_end is left out: swap = 1 - p_end - K ann makes {1, ann,
            # p_end, swap} exactly collinear
            feats = [finite.to(FLOAT_DTYPE), torch.where(finite, ann, 0.0)]
            p = swap_value
            for _ in range(self.basis_degree):
                feats.append(p)
                p = p * swap_value
            data.append((z, h, torch.stack(feats)))
        return data

    def _betas(self, betas, device) -> tuple:
        return tuple(torch.as_tensor(b, dtype=ACC_DTYPE).to(device)
                     for b in betas)

    def _price(self, params, betas=None):
        """(price tensor, fitted betas in date order, first-exercise date
        index per path, len(dates) where never exercised)."""
        engine = self._engine
        data = self._collect_exercise_data(engine, engine._params(params))
        E = len(data)
        if betas is not None:
            betas = self._betas(betas, engine.device)
        value, fitted = data[-1][1], []
        stop = torch.where(data[-1][1] > 0.0, E - 1, E)
        for k in reversed(range(E - 1)):
            z, _, feats = data[k]
            beta = regression_fit(feats, value) if betas is None else betas[k]
            fitted.append(beta)
            continuation = regression_predict(feats, beta)
            # exercise only in the money and above the continuation: a
            # regression artifact must not lock in a negative exercise
            exercise = (z > 0.0) & (z > continuation)
            value = torch.where(exercise, z, value)
            stop = torch.where(exercise, k, stop)
        price0 = torch.mean(value.to(ACC_DTYPE)) * self._scale()
        return price0, tuple(reversed(fitted)), stop

    def _scale(self) -> float:
        """P(0, T_n) under the terminal measure (numeraire at t = 0), 1
        under the spot measure."""
        return 1.0 if self.model.measure == "spot" \
            else self._engine._p0_terminal

    def _bounds(self, params, betas):
        if self._bounds_engine is None:
            e = self._engine
            self._bounds_engine = LMMValuationEngine(
                self.model, list(e.products), self.num_paths,
                self.num_factors, self.seed + 1, device=e.device)
        engine = self._bounds_engine
        data = self._collect_exercise_data(engine, engine._params(params))
        E = len(data)
        conts = [regression_predict(data[k][2], betas[k]) for k in range(E - 1)]

        # lower bound: the frozen policy applied forward
        value = data[E - 1][1]
        for k in reversed(range(E - 1)):
            z = data[k][0]
            value = torch.where((z > 0.0) & (z > conts[k]), z, value)
        lower = torch.mean(value.to(ACC_DTYPE)) * self._scale()

        # upper bound: Haugh-Kogan dual with the value surrogates
        # Vhat_e = max(h_e, Chat_e) (no continuation at the last date)
        vhat = [torch.maximum(data[k][1], conts[k]) for k in range(E - 1)]
        vhat.append(data[E - 1][1])
        m = torch.zeros_like(vhat[0])
        gap = data[0][1] - m
        for k in range(1, E):
            m = m + vhat[k] - conts[k - 1]
            gap = torch.maximum(gap, data[k][1] - m)
        upper = torch.mean(torch.clamp_min(gap, 0.0).to(ACC_DTYPE)) \
            * self._scale()
        return lower, upper

    # ------------------------------------------------------------------
    def get_value(self, params, betas=None) -> float:
        """The in-sample Longstaff-Schwartz value; with ``betas`` (one
        float64 vector per exercise date but the last, in date order), the
        value of that policy on the pricing paths instead."""
        return float(self._price(params, betas)[0])

    def get_value_bounds(self, params, betas=None) -> tuple:
        """(lower, upper) on an independent path set (engine seed + 1):
        the out-of-sample policy value (biased low) and the regression
        martingale's dual (biased high). ``betas`` applies a policy fitted
        elsewhere instead of this pricer's pricing pass."""
        if len(self.product.exercise_indices) < 2:
            v = self.get_value(params)
            return v, v
        if betas is None:
            betas = self._price(params)[1]
        lo, hi = self._bounds(params,
                              self._betas(betas, self._engine.device))
        return float(lo), float(hi)

    getValue = get_value
