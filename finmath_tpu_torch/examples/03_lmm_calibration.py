"""LIBOR Market Model swaption calibration: the north-star workload.

Run: python finmath_tpu_torch/examples/03_lmm_calibration.py [--cpu] [checkpoint.npz]

Counterpart of ``examples/03_lmm_calibration.py``. Bootstraps the EUR
curve, builds the 144-product ATM swaption surface, calibrates the
piecewise-constant volatility in two stages (analytic warm start, then
Monte-Carlo Levenberg-Marquardt with forward-mode Jacobians), then
checkpoints and re-prices deterministically.
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import tempfile  # noqa: E402

import numpy as np  # noqa: E402


def main(checkpoint_path=None, num_paths: int = 4_000,
         jacobian_paths: int = 2_000, max_iterations: int = 10,
         device=None) -> dict:
    """Calibrate on ``device`` (default: the CUDA card), write the
    checkpoint to ``checkpoint_path`` (default: a temporary directory,
    removed afterwards) and re-price from it; returns the deviations, the
    parameters and the Jacobian's shape."""
    from finmath_tpu_torch.models.lmm.atm_calibration import (
        build_atm_calibration)
    from finmath_tpu_torch.utils.serialization import (load_checkpoint,
                                                       save_checkpoint)

    setup = build_atm_calibration(num_paths=num_paths, num_factors=1,
                                  jacobian_paths=jacobian_paths,
                                  device=device)
    print(f"{len(setup.products)} calibration products on the 40Y grid")

    result = setup.calibrate(max_iterations=max_iterations, accuracy=1e-7,
                             warm_start="analytic")
    dev = setup.deviations(result.parameters)
    print(f"converged in {result.iterations} MC iterations; "
          f"mean deviation {dev.mean():.2e}, rms {np.sqrt((dev**2).mean()):.2e} "
          f"(reference contract: |mean| < 2e-4)")
    assert abs(dev.mean()) < 2e-4

    # checkpoint / resume: revaluation after the round trip is bit-exact
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint_path or os.path.join(tmp, "lmm_calibrated.npz")
        save_checkpoint(path, result.parameters,
                        metadata={"paths": num_paths,
                                  "rms": float(result.rms_error)})
        reloaded, meta = load_checkpoint(path)
    assert np.array_equal(
        setup.engine.implied_vols(result.parameters),
        setup.engine.implied_vols(reloaded),
    )
    print("checkpoint round-trip: revaluation bit-exact")

    # greeks of all 144 model quotes with respect to all 43 parameters:
    # one forward-mode pass on the device
    J = setup.engine.jacobian(result.parameters)
    print(f"model-to-parameter Jacobian {J.shape} via jacfwd "
          f"(max |dvol/dparam| = {np.abs(J).max():.4f})")
    return {"deviations": dev, "parameters": np.asarray(result.parameters),
            "metadata": meta, "jacobian_shape": tuple(J.shape)}


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main(args[0] if args else None,
         device="cpu" if "--cpu" in sys.argv[1:] else None)
