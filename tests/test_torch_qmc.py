"""The port's quasi-Monte-Carlo module (``finmath_tpu_torch/models/qmc.py``)
against finmath_tpu's on the same arguments.

Tolerance: none. Both are host NumPy and scipy, and the port's copy must
give the JAX module's increments bit for bit: the bridge on and off,
scrambled and unscrambled, seeds 0-2, antithetic (adjacent pairs), float32
and float64, a non-uniform grid. The benchmark setup built with
``brownian="sobol"`` injects the same realization in both packages (the
port's engine increments equal the JAX engine's ``_inc_np`` on the steps
it simulates)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu.models import qmc as jqmc  # noqa: E402
from finmath_tpu.models.lmm import benchmark_calibration as jbench  # noqa: E402

from finmath_tpu_torch.models import qmc as tqmc  # noqa: E402
from finmath_tpu_torch.models.lmm import (  # noqa: E402
    benchmark_calibration as tbench)

UNIFORM = np.full(8, 0.5)
NON_UNIFORM = np.asarray([0.25, 0.25, 0.5, 1.0, 0.125, 0.375, 0.5])


@pytest.mark.parametrize("times", [
    np.concatenate([[0.0], np.cumsum(UNIFORM)]),
    np.concatenate([[0.0], np.cumsum(NON_UNIFORM)]),
    np.asarray([0.0, 1.0]),
])
def test_brownian_bridge_plan_equal(times):
    assert tqmc.brownian_bridge_plan(times) == jqmc.brownian_bridge_plan(times)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scramble", [True, False])
@pytest.mark.parametrize("bridge", [True, False])
def test_sobol_increments_bit_equal(seed, scramble, bridge):
    args = (UNIFORM, 3, 96)
    kw = dict(seed=seed, scramble=scramble, bridge=bridge)
    got = tqmc.sobol_brownian_increments(*args, **kw)
    want = jqmc.sobol_brownian_increments(*args, **kw)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (8, 3, 96)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sobol_antithetic_non_uniform_bit_equal(dtype):
    kw = dict(seed=1, antithetic=True, dtype=dtype)
    got = tqmc.sobol_brownian_increments(NON_UNIFORM, 2, 50, **kw)
    want = jqmc.sobol_brownian_increments(NON_UNIFORM, 2, 50, **kw)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    # adjacent mirror pairs: a path prefix keeps whole pairs
    np.testing.assert_array_equal(got[..., 0::2], -got[..., 1::2])
    with pytest.raises(ValueError, match="even"):
        tqmc.sobol_brownian_increments(NON_UNIFORM, 2, 51, antithetic=True)


def test_sobol_setup_realization_equals_jax():
    sj = jbench.build_benchmark_calibration(num_paths=128, num_factors=2,
                                            brownian="sobol", seed=1,
                                            scan_mode="fused")
    st = tbench.build_benchmark_calibration(num_paths=128, num_factors=2,
                                            brownian="sobol", seed=1,
                                            device="cpu")
    inc = np.asarray(sj.engine._inc_np)
    assert inc.shape == (40, 3, 128)
    assert st.engine.injected and not st.engine.antithetic
    steps = st.engine.steps_needed
    np.testing.assert_array_equal(st.engine.increments.numpy(), inc[:steps])
