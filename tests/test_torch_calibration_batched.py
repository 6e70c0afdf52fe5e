"""The port's lockstep multistart and realization swap against finmath_tpu.

* ``BatchedLevenbergMarquardt``: the port's copy gives the JAX class's
  results bit for bit (parameters, rms, iterations, converged, damping;
  ``assert_array_equal``) on the JAX tests' NumPy problems
  (``tests/test_calibration_batched.py``): the exponential fit from four
  starts, with bounds, a start that never improves (and the same number
  of residual and Jacobian calls).
* The engine's batched API on the benchmark setup at 512 paths and 2
  factors: ``residuals_batched`` within rtol 1e-6 and ``jacobian_batched``
  within rtol 1e-5 of the per-set calls, the JAX test's tolerances
  (``torch.func.vmap`` over the residual function and over its
  ``jacfwd``).
* A tiny ``sweep_mode="batched"`` multistart reaches a finite optimum:
  the reduced benchmark-family model of ``tests/test_torch_stochvol_models
  .py`` (12 libors, seven quotes, 64 injected paths, 2 starts).
* ``set_increments``: after a swap the engine's values and residuals, the
  sweep engine's, and a kernel backend's realization 0 equal those of a
  setup built fresh on the new increments, bit for bit; a wrong shape or
  dtype, or an engine built without ``increments=``, raises."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu.models.calibration import (  # noqa: E402
    BatchedLevenbergMarquardt as JaxBatchedLM)

from finmath_tpu_torch.models.calibration import (  # noqa: E402
    BatchedLevenbergMarquardt)
from finmath_tpu_torch.models.lmm import (  # noqa: E402
    StochVolKernelCalibration, build_benchmark_calibration)
from finmath_tpu_torch.models.lmm.benchmark_calibration import (  # noqa: E402
    CURATED_BASINS)
from finmath_tpu_torch.models.qmc import (  # noqa: E402
    sobol_brownian_increments)
from finmath_tpu_torch.models import curves as tcurves  # noqa: E402
from finmath_tpu_torch.models import time_discretization as ttd  # noqa: E402
from finmath_tpu_torch.models.lmm import covariance as tcov  # noqa: E402
from finmath_tpu_torch.models.lmm import model as tmodel  # noqa: E402
from finmath_tpu_torch.models.lmm.benchmark_calibration import (  # noqa: E402
    BenchmarkCalibrationSetup)
from test_torch_stochvol_models import (  # noqa: E402
    FACTORS as REDUCED_FACTORS, _reduced_setup, reduced_increments)

T = np.linspace(0.0, 4.0, 25)
TRUE = np.asarray([2.0, 1.3, 0.5])


def _exp_residuals(X):
    X = np.atleast_2d(X)
    a, b, c = X[:, 0:1], X[:, 1:2], X[:, 2:3]
    target = TRUE[0] * np.exp(-TRUE[1] * T) + TRUE[2]
    return a * np.exp(-b * T[None, :]) + c - target[None, :]


def _exp_jacobian(X):
    X = np.atleast_2d(X)
    a, b = X[:, 0:1], X[:, 1:2]
    e = np.exp(-b * T[None, :])
    return np.stack([e, -a * T[None, :] * e, np.ones_like(e)], axis=-1)


def _stuck_problem():
    calls = {"jac": 0, "res": 0}

    def residuals(X):
        calls["res"] += 1
        return np.ones((np.atleast_2d(X).shape[0], 4))

    def jacobian(X):
        calls["jac"] += 1
        return np.tile(np.eye(4)[:, :2], (np.atleast_2d(X).shape[0], 1, 1))
    return residuals, jacobian, calls


STARTS = np.asarray([[1.0, 1.0, 0.0], [3.0, 0.5, 1.0], [0.5, 2.0, 0.2],
                     [2.5, 1.5, 0.8]])


@pytest.mark.parametrize("case", ["four_starts", "bounds", "stuck"])
def test_batched_lm_iterates_bit_equal(case):
    if case == "four_starts":
        args = (_exp_residuals, _exp_jacobian)
        kw, x0 = dict(max_iterations=100, accuracy=1e-12), STARTS
    elif case == "bounds":
        args = (_exp_residuals, _exp_jacobian)
        kw = dict(max_iterations=50, lower_bound=0.6, upper_bound=5.0)
        x0 = np.asarray([[1.0, 1.0, 0.7], [4.0, 0.7, 0.9]])
    else:
        kw, x0 = dict(max_iterations=40, accuracy=1e-12,
                      reject_patience=5), np.zeros((2, 2))
    runs = []
    for cls in (JaxBatchedLM, BatchedLevenbergMarquardt):
        if case == "stuck":
            res_fn, jac_fn, calls = _stuck_problem()
            args = (res_fn, jac_fn)
        runs.append((cls(*args, **kw).run(x0),
                     dict(calls) if case == "stuck" else None))
    (want, want_calls), (got, got_calls) = runs
    assert len(got) == len(want) == x0.shape[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.parameters, w.parameters)
        assert (g.rms_error, g.iterations, g.converged, g.lambda_final) == \
            (w.rms_error, w.iterations, w.converged, w.lambda_final)
    if case == "four_starts":
        for g in got:
            np.testing.assert_allclose(g.parameters, TRUE, atol=1e-6)
    if case == "stuck":
        # the same calls (the Jacobian reused while no start moves)
        assert got_calls == want_calls
        assert got_calls["jac"] == 1
    with pytest.raises(ValueError):
        BatchedLevenbergMarquardt(_exp_residuals, _exp_jacobian).run(
            np.asarray([1.0, 1.0, 0.0]))


@pytest.fixture(scope="module")
def small_setup():
    return build_benchmark_calibration(num_paths=512, num_factors=2,
                                       device="cpu")


def test_engine_batched_matches_single(small_setup):
    eng = small_setup.engine
    p0 = np.asarray(small_setup.covariance.initial_parameters)
    X = np.stack([p0, p0 * 1.1, CURATED_BASINS[0]])
    R = eng.residuals_batched(X)
    J = eng.jacobian_batched(X)
    assert R.shape == (3, 15) and J.shape == (3, 15, 8)
    for k, x in enumerate(X):
        np.testing.assert_allclose(R[k], eng.residuals(x), rtol=1e-6, atol=0)
        np.testing.assert_allclose(J[k], eng.jacobian(x), rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="expected"):
        eng.residuals_batched(p0)


def test_multistart_batched_sweep_runs():
    grid = [(1, 4, 0.0), (2, 4, 0.0), (3, 4, 0.0), (4, 4, 0.0),
            (4, 6, 0.0), (2, 4, -0.005), (2, 4, 0.005)]
    model, products = _reduced_setup(tcurves, ttd, tcov, tmodel, grid)
    engine = tmodel.LMMValuationEngine(
        model, products, 64, REDUCED_FACTORS, device="cpu",
        increments=reduced_increments(paths=64))
    setup = BenchmarkCalibrationSetup(engine=engine, model=model,
                                      covariance=model.covariance,
                                      products=products)
    res = setup.calibrate_multistart(max_starts=2, max_nfev=5,
                                     sweep_mode="batched")
    assert res.stages["sweep_mode"] == "batched"
    assert res.stages["sweep_candidates"] == 2
    assert np.all(np.isfinite(res.parameters))
    assert np.isfinite(res.rms_error)
    with pytest.raises(ValueError):
        setup.calibrate_multistart(sweep_mode="nope")


def _sobol(seed, paths=16_384, factors=2):
    return sobol_brownian_increments(np.full(40, 0.5), factors + 1, paths,
                                     seed=seed)


def test_set_increments_equals_fresh_engine():
    paths = 16_384
    setup = build_benchmark_calibration(num_paths=paths, num_factors=2,
                                        brownian="sobol", seed=0,
                                        device="cpu")
    sweep = setup.sweep_engine()
    assert sweep is not setup.engine and sweep.num_paths == 8_192
    kb = StochVolKernelCalibration(setup.engine)
    inc1 = _sobol(1)
    setup.set_increments(inc1)
    fresh = build_benchmark_calibration(num_paths=paths, num_factors=2,
                                        brownian="sobol", seed=1,
                                        device="cpu")
    x = CURATED_BASINS[0]
    assert torch.equal(setup.engine.increments, fresh.engine.increments)
    np.testing.assert_array_equal(setup.engine.values(x),
                                  fresh.engine.values(x))
    np.testing.assert_array_equal(sweep.residuals(x),
                                  fresh.sweep_engine().residuals(x))
    # the backend reads the engine's tensor: realization 0 moved with it
    np.testing.assert_array_equal(
        kb.residuals(x), StochVolKernelCalibration(fresh.engine).residuals(x))

    with pytest.raises(ValueError, match="shape"):
        setup.set_increments(inc1[:, :, :-2])
    with pytest.raises(ValueError, match="dtype"):
        setup.set_increments(inc1.astype(np.float64))
    own = build_benchmark_calibration(num_paths=64, num_factors=2,
                                      device="cpu")
    with pytest.raises(ValueError, match="without injected"):
        own.engine.set_increments(np.zeros((40, 3, 64), np.float32))
