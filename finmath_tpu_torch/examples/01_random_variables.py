"""Eager RandomVariable vector API: the reference's core surface.

Run: python finmath_tpu_torch/examples/01_random_variables.py [--cpu]

Counterpart of ``examples/01_random_variables.py``. Mirrors the finmath
workflow: immutable float32 path vectors with a filtration time,
arithmetic dispatched to the device, float64-accumulated reductions, and
the CPU float oracle for parity checks (ref. RandomVariableCuda /
RandomVariableFromFloatArray).
"""

import os
import sys

# allow running straight from a source checkout (inserts the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402


def main(num_paths: int = 100_000, device=None) -> dict:
    """The chained vector operations on ``num_paths`` paths on ``device``
    (default: the CUDA card, ``utils.config.select_device``) against the
    float oracle; returns the averages."""
    from finmath_tpu_torch.ops.random_variable import RandomVariableTorch
    from finmath_tpu_torch.ops.random_variable_float import (
        RandomVariableFloat)
    from finmath_tpu_torch.utils.config import select_device

    device = select_device() if device is None else device
    paths = np.random.default_rng(0).uniform(0.5, 2.0, num_paths)
    x = RandomVariableTorch(0.0, paths.astype(np.float32), device=device)

    # chained eager ops (each one device operation)
    y = x.mult(1.01).add(0.02).exp().log().discount(x, 0.5)
    y = y.add_product(x, x).cap(3.0).floor(0.1).sqrt()

    print(f"average            {y.get_average():.8f}  (f64-accumulated)")
    print(f"standard error     {y.get_standard_error():.2e}")
    print(f"5%/95% quantiles   {y.get_quantile(0.05):.5f} / {y.get_quantile(0.95):.5f}")

    # CPU float oracle: the identical chain with Kahan-compensated
    # reductions, the parity contract of the reference
    # (RandomVariableCuda.java:67-68)
    x_cpu = RandomVariableFloat(0.0, paths.astype(np.float32))
    y_cpu = x_cpu.mult(1.01).add(0.02).exp().log().discount(x_cpu, 0.5)
    y_cpu = y_cpu.add_product(x_cpu, x_cpu).cap(3.0).floor(0.1).sqrt()
    print(f"oracle average     {y_cpu.get_average():.8f}")
    assert abs(y_cpu.get_average() - y.get_average()) < 1e-5

    # deterministic fast path: scalars never touch the device
    d = RandomVariableTorch(0.0, 5.0)
    assert d.is_deterministic() and d.mult(2.0).double_value() == 10.0

    # type-priority promotion: float oracle op device vector -> device type
    mixed = y_cpu.sub(x)
    assert isinstance(mixed, RandomVariableTorch)
    print("mixed-priority op promotes to the device type: OK")

    # camelCase aliases work (finmath naming)
    assert y.getAverage() == y.get_average()
    return {"average": y.get_average(), "oracle_average": y_cpu.get_average()}


if __name__ == "__main__":
    main(device="cpu" if "--cpu" in sys.argv[1:] else None)
