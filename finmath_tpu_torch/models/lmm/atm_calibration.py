"""The reference's ATM swaption calibration workload, packaged.

Counterpart of ``finmath_tpu.models.lmm.atm_calibration``. Market data
snapshot (EUR, 2016-09-30) and workload assembly matching
LIBORMarketModelCalibrationATMTest.java:188-358:

* bootstrap the EUR discount curve from 21 par swap rates (:526-536),
* build the ATM swaption surface (196 quotes, normal vols :185-236),
* round expiries/tenors onto the idealized 0.25 grid, drop expiries < 1Y
  (:246-254),
* 40Y x dt=0.5 simulation/tenor grid, piecewise-constant vol over the
  {0,1,2,5,10,20,30,40} x {0,1,2,5,10,20,30,40} buckets, initial 0.50/100,
  exponential-decay correlation a=0.05 (:275-291),
* calibrate with Levenberg-Marquardt (lambda=0.1, accuracy 1e-7, <=200
  iterations :317-339),
* report mean/RMS deviation of model implied normal vols vs targets
  (assert |mean| < 2e-4, :466).

Products whose payments extend beyond the 40Y grid cannot be valued on it;
the reference's own valuation loop skips them via try/catch (:387-401) —
they are excluded up front.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..calibration import LevenbergMarquardt, LMResult
from ..curves import (DiscountCurve, ForwardCurve, get_calibrated_eur_curve,
                      par_swap_rate)
from ..time_discretization import TimeDiscretization
from .covariance import (DisplacedLocalVolatilityModel,
                         LIBORCorrelationModelExponentialDecay,
                         LIBORCovarianceModelFromVolatilityAndCorrelation,
                         LIBORVolatilityModelPiecewiseConstant)
from .model import LIBORMarketModelTorch, LMMValuationEngine, SwaptionProduct

# ATM swaption surface (normal vols), ref. :185-236.
ATM_EXPIRIES = (
    ["1M"] * 14 + ["3M"] * 14 + ["6M"] * 14 + ["1Y"] * 14 + ["2Y"] * 14
    + ["3Y"] * 14 + ["4Y"] * 14 + ["5Y"] * 14 + ["7Y"] * 14 + ["10Y"] * 14
    + ["15Y"] * 14 + ["20Y"] * 14 + ["25Y"] * 14 + ["30Y"] * 14
)
ATM_TENORS = (["1Y", "2Y", "3Y", "4Y", "5Y", "6Y", "7Y", "8Y", "9Y", "10Y",
               "15Y", "20Y", "25Y", "30Y"] * 14)
ATM_NORMAL_VOLS = [
    0.00151, 0.00169, 0.0021, 0.00248, 0.00291, 0.00329, 0.00365, 0.004,
    0.00437, 0.00466, 0.00527, 0.00571, 0.00604, 0.00625, 0.0016, 0.00174,
    0.00217, 0.00264, 0.00314, 0.00355, 0.00398, 0.00433, 0.00469, 0.00493,
    0.00569, 0.00607, 0.00627, 0.00645, 0.00182, 0.00204, 0.00238, 0.00286,
    0.00339, 0.00384, 0.00424, 0.00456, 0.00488, 0.0052, 0.0059, 0.00623,
    0.0064, 0.00654, 0.00205, 0.00235, 0.00272, 0.0032, 0.00368, 0.00406,
    0.00447, 0.00484, 0.00515, 0.00544, 0.00602, 0.00629, 0.0064, 0.00646,
    0.00279, 0.00319, 0.0036, 0.00396, 0.00436, 0.00469, 0.00503, 0.0053,
    0.00557, 0.00582, 0.00616, 0.00628, 0.00638, 0.00641, 0.00379, 0.00406,
    0.00439, 0.00472, 0.00504, 0.00532, 0.0056, 0.00582, 0.00602, 0.00617,
    0.0063, 0.00636, 0.00638, 0.00639, 0.00471, 0.00489, 0.00511, 0.00539,
    0.00563, 0.00583, 0.006, 0.00618, 0.0063, 0.00644, 0.00641, 0.00638,
    0.00635, 0.00634, 0.00544, 0.00557, 0.00572, 0.00591, 0.00604, 0.00617,
    0.0063, 0.00641, 0.00651, 0.00661, 0.00645, 0.00634, 0.00627, 0.00624,
    0.00625, 0.00632, 0.00638, 0.00644, 0.0065, 0.00655, 0.00661, 0.00667,
    0.00672, 0.00673, 0.00634, 0.00614, 0.00599, 0.00593, 0.00664, 0.00671,
    0.00675, 0.00676, 0.00676, 0.00675, 0.00676, 0.00674, 0.00672, 0.00669,
    0.00616, 0.00586, 0.00569, 0.00558, 0.00647, 0.00651, 0.00651, 0.00651,
    0.00652, 0.00649, 0.00645, 0.0064, 0.00637, 0.00631, 0.00576, 0.00534,
    0.00512, 0.00495, 0.00615, 0.0062, 0.00618, 0.00613, 0.0061, 0.00607,
    0.00602, 0.00596, 0.00591, 0.00586, 0.00536, 0.00491, 0.00469, 0.0045,
    0.00578, 0.00583, 0.00579, 0.00574, 0.00567, 0.00562, 0.00556, 0.00549,
    0.00545, 0.00538, 0.00493, 0.00453, 0.00435, 0.0042, 0.00542, 0.00547,
    0.00539, 0.00532, 0.00522, 0.00516, 0.0051, 0.00504, 0.005, 0.00495,
    0.00454, 0.00418, 0.00404, 0.00394,
]

SWAP_PERIOD_LENGTH = 0.5
LAST_TIME, DT = 40.0, 0.5
VOL_BUCKET_GRID = np.asarray([0.0, 1.0, 2.0, 5.0, 10.0, 20.0, 30.0, 40.0])


def _offset_to_years(code: str) -> float:
    n, unit = int(code[:-1]), code[-1]
    return n / 12.0 if unit == "M" else float(n)


@dataclass
class ATMCalibrationSetup:
    """Everything needed to run the ATM calibration workload."""

    engine: LMMValuationEngine
    model: LIBORMarketModelTorch
    covariance: LIBORCovarianceModelFromVolatilityAndCorrelation
    discount_curve: DiscountCurve
    forward_curve: ForwardCurve
    products: List[SwaptionProduct]
    jacobian_engine: LMMValuationEngine = None

    def calibrate(self, max_iterations: int = 200, accuracy: float = 1e-7,
                  lambda0: float = 0.1,
                  warm_start: Optional[str] = None,
                  residual_backend=None) -> LMResult:
        """Levenberg-Marquardt on the Monte-Carlo residuals.

        The Jacobian only steers the step, so it may come from a path
        subsample (``jacobian_engine``) while the residuals — which define
        convergence and the reported fit — stay at full resolution (the
        standard inexact-Jacobian LM). ``residual_backend`` (e.g. an
        ``ATMKernelCalibration`` on this engine) supplies those full-path
        residuals from the kernel. ``warm_start="analytic"`` first
        calibrates the analytic approximation (no Monte Carlo) and starts
        the Monte-Carlo LM from its optimum."""
        x0 = np.asarray(self.covariance.initial_parameters, dtype=np.float64)
        if warm_start == "analytic":
            lm_a = LevenbergMarquardt(
                self.analytic_engine.residuals, self.analytic_engine.jacobian,
                lambda0=lambda0, max_iterations=60,
                accuracy=max(accuracy, 1e-7), lower_bound=0.0,
            )
            x0 = lm_a.run(x0).parameters
        elif warm_start is not None:
            raise ValueError(f"unknown warm_start {warm_start!r}")
        jac = (self.jacobian_engine or self.engine).jacobian
        res_fn = (residual_backend.residuals if residual_backend is not None
                  else self.engine.residuals)
        lm = LevenbergMarquardt(
            res_fn, jac,
            lambda0=lambda0, max_iterations=max_iterations, accuracy=accuracy,
            lower_bound=0.0,
        )
        return lm.run(x0)

    @property
    def analytic_engine(self):
        """Lazily-built analytic-approximation engine over the same
        products (``warm_start="analytic"`` and the ANALYTIC variant)."""
        if getattr(self, "_analytic_engine", None) is None:
            from .analytic_approximation import LMMAnalyticSwaptionEngine

            self._analytic_engine = LMMAnalyticSwaptionEngine(
                self.model, self.products)
        return self._analytic_engine

    def deviations(self, params) -> np.ndarray:
        """Per-product implied-vol deviation from target (the reference's
        reported statistic, ATM test :376-401)."""
        return self.engine.implied_vols(params) - self.engine.targets


def build_atm_calibration(num_paths: int = 10_000, num_factors: int = 1,
                          seed: int = 31415,
                          model_type: str = "NORMAL",
                          discount_curve: Optional[DiscountCurve] = None,
                          calibration_product_type: str = "MONTECARLO",
                          jacobian_paths: Optional[int] = None,
                          device=None) -> ATMCalibrationSetup:
    """Assemble the full ATM workload (curves -> surface -> products ->
    model -> engine) on ``device`` (default: ``select_device()``).
    ``model_type``: NORMAL | DISPLACED (ref. :296-306);
    ``calibration_product_type``: MONTECARLO (SwaptionSimple) | ANALYTIC
    (SwaptionGeneralizedAnalyticApproximation) — ref. :108-118, :505-521."""
    dc = discount_curve or get_calibrated_eur_curve()
    fc = ForwardCurve(dc, SWAP_PERIOD_LENGTH)

    libor_td = TimeDiscretization(initial=0.0, num_steps=int(LAST_TIME / DT), step=DT)
    tenor = np.asarray([libor_td.get_time(i) for i in range(len(libor_td))])

    products: List[SwaptionProduct] = []
    for exp_code, ten_code, vol in zip(ATM_EXPIRIES, ATM_TENORS, ATM_NORMAL_VOLS):
        exercise = round(_offset_to_years(exp_code) / 0.25) * 0.25
        tenor_len = round(_offset_to_years(ten_code) / 0.25) * 0.25
        if exercise < 1.0:
            continue  # ref. :252-254
        if (exercise + tenor_len) > LAST_TIME:
            continue  # payments beyond the model grid (ref. skips via try/catch)
        e = int(round(exercise / DT))
        m = int(round(tenor_len / SWAP_PERIOD_LENGTH))
        strike = par_swap_rate(fc, dc, tenor[e : e + m + 1])
        products.append(SwaptionProduct(
            exercise_index=e, num_periods=m, strike=strike,
            target=vol, weight=1.0, value_unit="VOLATILITYNORMAL",
        ))

    vol_model = LIBORVolatilityModelPiecewiseConstant(
        libor_td, libor_td, VOL_BUCKET_GRID, VOL_BUCKET_GRID,
        initial_volatility=0.50 / 100,
    )
    corr_model = LIBORCorrelationModelExponentialDecay(
        libor_td, num_factors, decay=0.05
    )
    covariance = LIBORCovarianceModelFromVolatilityAndCorrelation(
        vol_model, corr_model
    )
    if model_type == "DISPLACED":
        covariance = DisplacedLocalVolatilityModel(
            covariance, displacement=1.0 / 0.25, is_calibrateable=False
        )
    elif model_type != "NORMAL":
        raise ValueError(f"unknown model_type {model_type}")

    model = LIBORMarketModelTorch(
        libor_td, fc, dc, covariance,
        measure="spot", state_space="normal", use_numeraire_adjustment=True,
    )
    jacobian_engine = None
    if calibration_product_type == "ANALYTIC":
        from .analytic_approximation import LMMAnalyticSwaptionEngine

        engine = LMMAnalyticSwaptionEngine(model, products)
    elif calibration_product_type == "MONTECARLO":
        engine = LMMValuationEngine(model, products, num_paths, num_factors,
                                    seed, device=device)
        if jacobian_paths is not None and jacobian_paths < num_paths:
            jacobian_engine = LMMValuationEngine(
                model, products, jacobian_paths, num_factors, seed,
                device=device)
    else:
        raise ValueError(
            f"unknown calibration_product_type {calibration_product_type}"
        )
    return ATMCalibrationSetup(
        engine=engine, model=model, covariance=covariance,
        discount_curve=dc, forward_curve=fc, products=products,
        jacobian_engine=jacobian_engine,
    )
