"""Analytic swaption-volatility approximation from the LMM covariance.

Counterpart of ``finmath_tpu.models.lmm.analytic_approximation`` —
finmath's ``SwaptionGeneralizedAnalyticApproximation`` (StateSpace.NORMAL,
ValueUnit.VOLATILITY), the ANALYTIC calibration-product variant of the
reference's ATM test (LIBORMarketModelCalibrationATMTest.java:507-515) and
the warm start of its Monte-Carlo calibration.

Frozen-weights approximation: the swap rate S = (1 - P_end)/A is linearized
in the forwards at t=0, w_i = dS/dL_i|_{t=0}, so its normal volatility is

    sigma_N^2 T_e = int_0^{T_e} | sum_i w_i lambda_i(t) |^2 dt

with lambda the (local-vol-frozen) factor loadings. Everything after the
static weight computation is a tiny float64 tensor function of the
covariance parameters; its Jacobian is ``torch.func.jacfwd``.

These functions run on CPU tensors by design, wherever the Monte-Carlo
engine runs: they have no path axis (a few hundred numbers), so a device
would spend more on launches and transfers than on the arithmetic. The JAX
package pins the same programs to its host backend for the same reason.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch.func import jacfwd

from .model import LIBORMarketModelTorch, SwaptionProduct

_CPU = torch.device("cpu")


def _swap_rate_from_forwards(forwards: np.ndarray, deltas: np.ndarray,
                             e: int, m: int) -> float:
    """S = (1 - P_end) / annuity on the sub-tenor [e, e+m] (single curve)."""
    df = 1.0
    annuity = 0.0
    for k in range(e, e + m):
        df = df / (1.0 + deltas[k] * forwards[k])
        annuity += deltas[k] * df
    return (1.0 - df) / annuity


def swap_rate_weights(forwards: np.ndarray, deltas: np.ndarray,
                      e: int, m: int, eps: float = 1e-7) -> np.ndarray:
    """dS/dL_i at t=0 by central differences (host float64, build time)."""
    n = len(forwards)
    w = np.zeros(n)
    for i in range(e, e + m):
        fp = forwards.copy()
        fm = forwards.copy()
        fp[i] += eps
        fm[i] -= eps
        w[i] = (_swap_rate_from_forwards(fp, deltas, e, m)
                - _swap_rate_from_forwards(fm, deltas, e, m)) / (2 * eps)
    return w


class LMMAnalyticSwaptionEngine:
    """Same residuals/jacobian API as LMMValuationEngine, but quotes come
    from the integrated-covariance approximation instead of Monte Carlo."""

    def __init__(self, model: LIBORMarketModelTorch,
                 products: Sequence[SwaptionProduct]):
        self.model = model
        n = model.num_libors
        kept = [p for p in products
                if p.exercise_index + p.num_periods <= n and p.exercise_index >= 1]
        if not kept:
            raise ValueError("no products fit on the tenor grid")
        self.products = sorted(kept, key=lambda p: (p.exercise_index, p.num_periods))
        unit = {p.value_unit for p in self.products}
        if len(unit) != 1 or unit.pop() not in ("VOLATILITYNORMAL",
                                                "VOLATILITYLOGNORMAL"):
            raise NotImplementedError(
                "analytic approximation supports VOLATILITYNORMAL and "
                "VOLATILITYLOGNORMAL quotes")
        #: lognormal quotes via the frozen-coefficient map sigma_LN ~=
        #: sigma_N / S0 (the swap rate's absolute volatility divided by
        #: today's par rate)
        self.value_unit = self.products[0].value_unit
        if (model.simulation_td.get_number_of_time_steps()
                != model.libor_td.get_number_of_time_steps()):
            raise NotImplementedError(
                "analytic approximation requires simulation grid == tenor "
                "grid; use the Monte-Carlo engine for refined grids")

        deltas = model.deltas
        L0 = model.initial_forwards
        dts = model.libor_td.get_step_sizes()
        P = len(self.products)

        # static: weight matrix [P, n], per-step integration mask [P, steps]
        W = np.zeros((P, n))
        texp = np.zeros(P)
        s0 = np.ones(P)
        steps_mask = np.zeros((P, len(dts)))
        for k, p in enumerate(self.products):
            W[k] = swap_rate_weights(L0, deltas, p.exercise_index, p.num_periods)
            texp[k] = model.tenor_times[p.exercise_index]
            s0[k] = _swap_rate_from_forwards(np.asarray(L0), deltas,
                                             p.exercise_index, p.num_periods)
            steps_mask[k, : p.exercise_index] = dts[: p.exercise_index]

        def cpu64(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                   device=_CPU)

        self._s0 = cpu64(s0)
        self._W = cpu64(W)
        self._texp = cpu64(texp)
        self._steps_dt = cpu64(steps_mask)          # [P, steps] (dt or 0)
        self._targets = np.asarray([p.target for p in self.products])
        self._weights = np.asarray([p.weight for p in self.products])
        # the local factor is evaluated on the float32 initial forwards, as
        # in the JAX engine
        self._L0_col = torch.as_tensor(np.asarray(L0)[:, None],
                                       dtype=torch.float32, device=_CPU)

    def _quotes(self, params: torch.Tensor) -> torch.Tensor:
        cov = self.model.covariance
        prep = cov.prepare(params)
        vol = cov.vol_table(prep)                       # [steps, n]
        R = cov.factor_matrix(prep)                     # [n, F]
        # freeze local vol at the initial forwards
        local0 = cov.local_factor(prep, self._L0_col, self._L0_col)[:, 0]
        lam = (vol * local0[None, :].to(vol.dtype))[:, :, None] * R[None]
        # per product: x[p, s, f] = sum_i W[p,i] lam[s,i,f]
        x = torch.einsum("pi,sif->psf", self._W, lam)
        inst_var = torch.sum(x * x, dim=2)              # [P, steps]
        total_var = torch.sum(inst_var * self._steps_dt, dim=1)
        sigma_n = torch.sqrt(torch.clamp_min(total_var, 1e-20) / self._texp)
        if self.value_unit == "VOLATILITYLOGNORMAL":
            return sigma_n / self._s0
        return sigma_n

    def _residuals(self, params: torch.Tensor) -> torch.Tensor:
        targets = torch.as_tensor(self._targets, dtype=torch.float64)
        weights = torch.as_tensor(self._weights, dtype=torch.float64)
        return weights * (self._quotes(params) - targets)

    @staticmethod
    def _params(params) -> torch.Tensor:
        return torch.as_tensor(np.asarray(params, dtype=np.float64),
                               device=_CPU)

    # ------------------------------------------------------------------
    def residuals(self, params) -> np.ndarray:
        return self._residuals(self._params(params)).numpy()

    def jacobian(self, params) -> np.ndarray:
        return jacfwd(self._residuals)(self._params(params)).numpy()

    def implied_vols(self, params) -> np.ndarray:
        """Model quotes computed directly (NOT by un-scaling the weighted
        residuals, which is 0/0 for a legitimately de-weighted product)."""
        return self._quotes(self._params(params)).numpy()

    @property
    def targets(self) -> np.ndarray:
        return self._targets
