"""Risk ladders: bucketed portfolio deltas with respect to the initial
forward curve from one reverse-mode pass through the whole LMM Euler
sweep (drift, local and stochastic vol, payoff, numeraire).

Run: python finmath_tpu_torch/examples/07_risk_ladders.py [--cpu]

Counterpart of ``examples/07_risk_ladders.py``. The reference's route to
these numbers is finmath-lib's host tape over some 10^5 eagerly
dispatched operations a valuation; here ``torch.autograd`` runs the
pathwise adjoint of the engine's sweep (``LMMValuationEngine.
forward_deltas`` and ``forward_delta_matrix``).
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import time  # noqa: E402

import numpy as np  # noqa: E402


def _clock(device) -> float:
    """The host clock after the device's queue has drained."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    return time.perf_counter()


def portfolio_ladder(device, num_paths=20_000) -> dict:
    """Equal-weight ATM swaption portfolio: value and all dV/dL_i(0)."""
    from finmath_tpu_torch.models.lmm.atm_calibration import (
        build_atm_calibration)

    setup = build_atm_calibration(num_paths=num_paths, num_factors=1,
                                  seed=3141, device=device)
    eng = setup.engine
    p0 = np.asarray(setup.covariance.initial_parameters)

    t0 = _clock(device)
    value, ladder = eng.forward_deltas(p0)     # one forward + one backward
    cold = _clock(device) - t0
    t0 = _clock(device)
    value, ladder = eng.forward_deltas(p0)
    warm = _clock(device) - t0

    print(f"portfolio of {len(eng.products)} swaptions, "
          f"{eng.model.num_libors} curve buckets")
    print(f"value {value:.6f}; ladder cold {cold:.1f}s warm "
          f"{warm * 1e3:.0f}ms")
    top = np.argsort(-np.abs(ladder))[:5]
    for i in top:
        print(f"  bucket {i:2d} (T={eng.model.tenor_times[i]:5.1f}y): "
              f"dV/dL = {ladder[i]:+.4f}")
    return {"value": float(value), "ladder": np.asarray(ladder),
            "cold_s": cold, "warm_s": warm}


def per_product_matrix(device, num_paths=8_192) -> dict:
    """The [products, buckets] delta matrix: one forward sweep, one
    backward sweep a product."""
    from finmath_tpu_torch.models.lmm.benchmark_calibration import (
        build_benchmark_calibration)

    setup = build_benchmark_calibration(num_paths=num_paths, seed=7,
                                        device=device)
    eng = setup.engine
    p0 = np.asarray(setup.covariance.initial_parameters)

    M = eng.forward_delta_matrix(p0)
    _, g = eng.forward_deltas(p0)
    # float32 paths: the one-product rows and the single equal-weight pass
    # add in different orders, so they agree to float32 resolution
    rows_sum = bool(np.allclose(M.sum(axis=0), g, rtol=1e-4, atol=1e-6))
    print(f"\nstoch-vol benchmark: delta matrix {M.shape}, "
          f"rows sum to portfolio ladder: {rows_sum}")

    # hedging view: which bucket carries each product's risk
    dominant = {}
    for p in (0, 7, 14):
        i = int(np.argmax(np.abs(M[p])))
        dominant[p] = i
        print(f"  product {p:2d}: dominant bucket {i} "
              f"(dV/dL = {M[p, i]:+.5f})")
    return {"matrix": np.asarray(M), "ladder": np.asarray(g),
            "rows_sum_to_ladder": rows_sum, "dominant": dominant}


def main(ladder_paths: int = 20_000, matrix_paths: int = 8_192,
         device=None) -> dict:
    """Both ladders in the JAX script's order on ``device`` (default: the
    CUDA card); returns what each printed."""
    import torch

    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else torch.device(device)
    return {"portfolio": portfolio_ladder(device, ladder_paths),
            "matrix": per_product_matrix(device, matrix_paths)}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
