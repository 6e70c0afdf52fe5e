"""Kernel-backed calibration and a book priced with one host transfer.

Run: python finmath_tpu_torch/examples/16_kernel_calibration_and_portfolio.py [--cpu]

Counterpart of ``examples/16_kernel_calibration_and_portfolio.py``.

1. ``StochVolKernelCalibration``: the calibration's hot loop on the
   stoch-vol products kernel (``csrc/lmm_stochvol_products.cu``). The
   residuals are one path sweep; the Jacobian is central finite
   differences under common random numbers, and residuals and Jacobian
   together are one launch over 2 * 8 + 1 = 17 parameter sets that share
   one realization. On the card this is the benchmark configuration at
   81,920 Sobol paths; on the CPU the kernel's plain version runs a
   reduced model built here (12 libors, 3 factors and the volatility
   factor, four products, 256 Sobol paths).
2. ``price_portfolio``: a ten-product book whose values stay on the
   device until one copy of the stacked ``[10, 2]`` result.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import time  # noqa: E402

import numpy as np  # noqa: E402

# the reduced benchmark-family model of the CPU run: its libors, factors,
# paths, Sobol seed, products (exercise index, periods, strike offset from
# the par rate) and parameter point
SMALL_LIBORS, SMALL_FACTORS, SMALL_PATHS, SMALL_SEED = 12, 3, 256, 5
SMALL_PRODUCTS = ((2, 8, 0.0), (4, 4, 0.0), (6, 4, -0.005), (6, 6, 0.005))
SMALL_X = np.asarray([0.20, 0.05, 0.10, 0.05, 0.10, 0.2, 0.25, 0.15])


def small_setup(device, paths=SMALL_PATHS, seed=SMALL_SEED):
    """The reduced stoch-vol model on ``device``: ``(engine, increments)``,
    the engine pricing the injected Sobol increments."""
    from finmath_tpu_torch.models.curves import (
        DiscountCurveFromForwardCurve, ForwardCurveFromForwards,
        par_swap_rate)
    from finmath_tpu_torch.models.lmm.covariance import (
        BlendedLocalVolatilityModel,
        LIBORCovarianceModelExponentialForm5Param,
        LIBORCovarianceModelStochasticVolatility)
    from finmath_tpu_torch.models.lmm.model import (LIBORMarketModelTorch,
                                                    LMMValuationEngine,
                                                    SwaptionProduct)
    from finmath_tpu_torch.models.qmc import sobol_brownian_increments
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    fix = np.arange(0.0, 10.5, 0.5)
    fc = ForwardCurveFromForwards(fix, 0.02 + 0.002 * np.sin(fix), 0.5)
    dc = DiscountCurveFromForwardCurve(fc, horizon=12.0)
    td = TimeDiscretization(initial=0.0, num_steps=SMALL_LIBORS, step=0.5)
    cov = LIBORCovarianceModelExponentialForm5Param(
        td, td, SMALL_FACTORS, (0.20, 0.05, 0.10, 0.05, 0.10))
    cov = BlendedLocalVolatilityModel(cov, blend=0.2, is_calibrateable=True)
    cov = LIBORCovarianceModelStochasticVolatility(
        cov, nu=0.25, rho=0.15, is_calibrateable=True)
    model = LIBORMarketModelTorch(td, fc, dc, cov, measure="spot",
                                  state_space="normal",
                                  use_numeraire_adjustment=False)
    tenor = model.tenor_times
    products = [SwaptionProduct(
        exercise_index=e, num_periods=m,
        strike=dk + par_swap_rate(fc, dc, tenor[e:e + m + 1]),
        target=0.30, weight=1.0, value_unit="VOLATILITYLOGNORMAL")
        for e, m, dk in SMALL_PRODUCTS]
    inc = sobol_brownian_increments(np.full(SMALL_LIBORS, 0.5),
                                    SMALL_FACTORS + 1, paths, seed=seed)
    engine = LMMValuationEngine(model, products, paths, SMALL_FACTORS,
                                seed=seed, device=device, increments=inc)
    return engine, inc


def kernel_calibration(device, num_paths=81_920) -> dict:
    """One warm-up call, then one timed ``residuals_and_jacobian``: on
    the card one ``lmm_stochvol_products`` launch."""
    import torch

    from finmath_tpu_torch.models.lmm.kernel_backend import (
        StochVolKernelCalibration)
    from finmath_tpu_torch.ops import lmm_stochvol_kernel

    if device.type == "cuda":
        from finmath_tpu_torch.models.lmm.benchmark_calibration import (
            CURATED_BASINS, build_benchmark_calibration)

        s = build_benchmark_calibration(num_paths=num_paths,
                                        brownian="sobol", seed=0,
                                        device=device)
        engine, increments = s.engine, s.engine.increments
        x = np.asarray(CURATED_BASINS[0])
    else:
        engine, increments = small_setup(device)
        x = SMALL_X
    kb = StochVolKernelCalibration(engine, [increments])

    kb.residuals_and_jacobian(x)          # warm-up: builds the kernel
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = lmm_stochvol_kernel.LAUNCHES
    t0 = time.perf_counter()
    r0, J = kb.residuals_and_jacobian(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = lmm_stochvol_kernel.LAUNCHES - launches
    sets = 2 * len(x) + 1
    route = ("one launch" if device.type == "cuda"
             else "the kernel's plain version")
    print(f"kernel residuals+Jacobian ({J.shape}) in {ms:.1f} ms "
          f"({route}, {sets} parameter sets x {engine.num_paths:,} paths)")
    r_e = engine.residuals(x)
    gap = float(np.abs(r0 - r_e).max())
    print(f"  vs engine residuals: max abs dev {gap:.2e} (the engine "
          f"collects in float64, the kernel in float32)")
    return {"residuals": r0, "jacobian": J, "engine_residuals": r_e,
            "gap": gap, "ms": ms, "launches": launches,
            "parameter_sets": sets, "x": x}


def portfolio(device, num_paths=1_000_000) -> dict:
    """A mixed ten-product book on one Black-Scholes facade, one copy."""
    from finmath_tpu_torch.models import (AsianOption, BarrierOption,
                                          DigitalOption, LookbackOption,
                                          price_portfolio)
    from finmath_tpu_torch.models.black_scholes import (
        BlackScholesModel, EuropeanOption, MonteCarloBlackScholesModel)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    td = TimeDiscretization(initial=0.0, num_steps=50, step=0.02)
    sim = MonteCarloBlackScholesModel(
        td, num_paths, BlackScholesModel(100.0, 0.05, 0.3), seed=5,
        device=device)
    dates = [round(0.2 * (i + 1), 2) for i in range(5)]
    book = [EuropeanOption(1.0, 95.0), EuropeanOption(1.0, 105.0),
            EuropeanOption(1.0, 100.0, is_call=False),
            DigitalOption(1.0, 100.0),
            AsianOption(dates, 100.0),
            BarrierOption(1.0, 100.0, 130.0, "up-out"),
            BarrierOption(1.0, 100.0, 80.0, "down-in", is_call=False),
            LookbackOption(1.0, "floating-call"),
            LookbackOption(1.0, "fixed-put", strike=100.0),
            DigitalOption(1.0, 110.0, is_call=False)]
    results = price_portfolio(sim, book)
    print(f"\n{len(book)}-product book at {num_paths:,} paths "
          f"(one packed transfer):")
    for p, (v, e) in zip(book, results):
        print(f"  {type(p).__name__:<16s} {v:10.4f} +- {e:.4f}")
    return {"results": results, "book": book, "model": sim}


def main(num_paths: int = 81_920, book_paths: int = 1_000_000,
         device=None) -> dict:
    """Both parts on ``device`` (default: the CUDA card): on the card the
    benchmark configuration at ``num_paths``, on the CPU the reduced
    model; returns what each printed."""
    import torch

    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    return {"calibration": kernel_calibration(device, num_paths),
            "book": portfolio(device, book_paths)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
