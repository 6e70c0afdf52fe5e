"""Lazy execution, quasi-Monte-Carlo paths, the reference's bit-exact
Brownian realization, Bermudan bounds and realization swapping.

Run: python finmath_tpu_torch/examples/06_lazy_qmc_and_reference_stream.py [--cpu]

Counterpart of ``examples/06_lazy_qmc_and_reference_stream.py``. Its
last part also exports and reloads the compiled programs
(``export_aot`` / ``load_aot``); the port has no such export. Its
counterpart is the build cache of ``ops._cuda_build``: each kernel
library is named by a hash of its source, headers, defines and flags, so
a fresh process reuses a library built before and compiles nothing.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import time  # noqa: E402

import numpy as np  # noqa: E402


def lazy_eager(device, num_paths=100_000) -> dict:
    """Record eager operations and flush them as one program (on the card
    one CUDA graph a structure, ``ops/lazy.py``)."""
    from finmath_tpu_torch import (RandomVariableTorch,
                                   RandomVariableTorchLazy, averages)

    x = np.random.default_rng(0).uniform(0.5, 2.0, num_paths).astype(
        np.float32)
    lazy = RandomVariableTorchLazy(0.0, x, device=device)

    # nothing runs here: the chain is recorded
    y = lazy.mult(1.01).add(0.02).exp().log().discount(lazy, 0.5)
    print("pending:", repr(y))
    # the reduction flushes the chain and returns the float64 mean
    average = y.get_average()
    print("average:", average)

    # portfolio idiom: many products, one flush and one host read
    chains = [lazy.mult(k).exp().cap(3.0) for k in (0.5, 0.7, 0.9)]
    portfolio = averages(*chains)
    print("portfolio averages (one flush):", portfolio)

    # strict and lazy interoperate through finmath type priorities
    strict = RandomVariableTorch(0.0, x, device=device)
    mixed = strict.mult(2.0).add(lazy.exp())
    print("mixed strict/lazy type:", type(mixed).__name__)
    return {"average": average, "portfolio": list(portfolio),
            "mixed_type": type(mixed).__name__}


def reference_realization(device, num_paths=4096) -> np.ndarray:
    """Price on the exact Brownian realization of the reference benchmark:
    its host Mersenne stream rebuilt bit for bit and injected into the
    engine (``models/brownian_motion.py``,
    ``LMMValuationEngine(increments=...)``)."""
    from finmath_tpu_torch.models.lmm.benchmark_calibration import (
        build_benchmark_calibration)

    setup = build_benchmark_calibration(num_paths=num_paths,
                                        brownian="finmath_mersenne",
                                        device=device)
    x0 = setup.covariance.initial_parameters
    vols = setup.engine.implied_vols(x0)
    print(f"implied vols on finmath's own {num_paths}-path realization:",
          np.round(vols[:5], 4))
    return vols


def quasi_monte_carlo(device, num_paths=4096) -> dict:
    """Scrambled Sobol with a Brownian bridge (``models/qmc.py``): the
    terminal level of every path rides the best-stratified dimension."""
    from finmath_tpu_torch.models.lmm.benchmark_calibration import (
        build_benchmark_calibration)
    from finmath_tpu_torch.models.qmc import sobol_brownian_increments

    dts = np.full(16, 1.0 / 16)
    inc = sobol_brownian_increments(dts, 1, num_paths, seed=7)
    w_T = inc.sum(axis=0)[0]
    variance = float(w_T.var())
    print("QMC terminal variance (want 1.0):", round(variance, 5))

    setup = build_benchmark_calibration(num_paths=num_paths, brownian="sobol",
                                        antithetic=True, device=device)
    vols = setup.engine.implied_vols(setup.covariance.initial_parameters)
    print("stoch-vol quotes on QMC paths:", np.round(vols[:5], 4))
    return {"terminal_variance": variance, "vols": vols}


def bermudan_bounds(device, num_paths=8192) -> dict:
    """Longstaff-Schwartz point estimate bracketed from both sides:
    out-of-sample policy (low) and Haugh-Kogan dual (high)."""
    from finmath_tpu_torch.models.curves import par_swap_rate
    from finmath_tpu_torch.models.lmm.atm_calibration import (
        build_atm_calibration)
    from finmath_tpu_torch.models.lmm.bermudan import (BermudanSwaption,
                                                       BermudanSwaptionPricer)

    setup = build_atm_calibration(num_paths=num_paths, num_factors=1,
                                  device=device)
    model = setup.model
    strike = par_swap_rate(model.forward_curve, model.discount_curve,
                           model.tenor_times[8:17])
    pricer = BermudanSwaptionPricer(
        model, BermudanSwaption((8, 10, 12), 16, strike), num_paths, 1,
        device=device)
    p0 = setup.covariance.initial_parameters
    v = pricer.get_value(p0)
    lo, hi = pricer.get_value_bounds(p0)
    print(f"Bermudan LS value {v:.6f}, bounds [{lo:.6f}, {hi:.6f}], "
          f"duality gap {hi - lo:.2e}")
    return {"value": v, "lower": lo, "upper": hi}


def realization_swapping(device, num_paths=4096) -> dict:
    """The injected realization is overwritten in place
    (``set_increments``): swapping the Sobol scrambling, or any stream of
    the same shape, builds nothing anew, which makes multi-realization
    calibration and bootstrap resampling cheap."""
    import torch

    from finmath_tpu_torch.models.lmm.benchmark_calibration import (
        build_benchmark_calibration)
    from finmath_tpu_torch.models.qmc import sobol_brownian_increments

    setup = build_benchmark_calibration(num_paths=num_paths,
                                        brownian="sobol", seed=0,
                                        device=device)
    engine = setup.engine
    p0 = setup.covariance.initial_parameters
    v0 = engine.values(p0)
    swapped = []
    t0 = time.perf_counter()
    for k in (1, 2, 3):     # three more scramblings on the same engine
        setup.set_increments(sobol_brownian_increments(
            np.full(40, 0.5), engine.num_factors + int(engine.stoch_vol),
            num_paths, seed=k))
        vk = engine.values(p0)
        swapped.append(vk)
        print(f"scrambling {k}: first quote {vk[0]:.6f} "
              f"(vs {v0[0]:.6f} on scrambling 0)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    print(f"3 realization swaps + revaluations: {seconds:.2f} s, "
          f"nothing rebuilt")
    return {"values": v0, "swapped": swapped, "seconds": seconds}


def main(lazy_paths: int = 100_000, reference_paths: int = 4096,
         qmc_paths: int = 4096, bermudan_paths: int = 8192,
         swap_paths: int = 4096, device=None) -> dict:
    """The five parts in the JAX script's order on ``device`` (default: the
    CUDA card); returns what each printed."""
    import torch

    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    return {"lazy": lazy_eager(device, lazy_paths),
            "reference_vols": reference_realization(device, reference_paths),
            "qmc": quasi_monte_carlo(device, qmc_paths),
            "bermudan": bermudan_bounds(device, bermudan_paths),
            "swapping": realization_swapping(device, swap_paths)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
