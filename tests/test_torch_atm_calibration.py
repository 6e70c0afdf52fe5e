"""Slice A end to end: the port's ATM swaption calibration against
finmath_tpu's at full width — 80 libors, 144 products, 43 parameters — on
one injected realization of 512 paths (seeded NumPy, sqrt(dt)-scaled),
fed to the JAX ``LMMValuationEngine(..., increments=inc,
scan_mode="segmented")`` and to the port's engine alike. The Jacobian
engines of both calibrations price the realization's first 128 paths (the
inexact-Jacobian LM of the main path, at test size).

Tolerances: values rtol 1e-5 and implied vols atol 1e-6 (float32
simulation on both sides; the port collects in float64, JAX in compensated
float32), Jacobian 1e-3 column-scaled, the analytic approximation 1e-10
(float64 on both sides)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu.models.lmm import atm_calibration as jatm  # noqa: E402
from finmath_tpu.models.lmm.model import (  # noqa: E402
    LMMValuationEngine as JaxEngine)

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models.lmm import atm_calibration as tatm  # noqa: E402
from finmath_tpu_torch.models.lmm.kernel_backend import (  # noqa: E402
    ATMKernelCalibration)
from finmath_tpu_torch.models.lmm.model import (  # noqa: E402
    LMMValuationEngine as TorchEngine)

PATHS, JAC_PATHS, STEPS = 512, 128, 60


def _setups(inc):
    sj = jatm.build_atm_calibration(num_paths=PATHS, num_factors=1, seed=1)
    st = tatm.build_atm_calibration(num_paths=PATHS, num_factors=1, seed=1,
                                    device="cpu")
    jac_inc = np.ascontiguousarray(inc[:, :, :JAC_PATHS])
    je = JaxEngine(sj.model, sj.products, PATHS, 1, increments=inc,
                   scan_mode="segmented")
    jje = JaxEngine(sj.model, sj.products, JAC_PATHS, 1, increments=jac_inc,
                    scan_mode="segmented")
    te = TorchEngine(st.model, st.products, PATHS, 1, device="cpu",
                     increments=convert.increments_from_numpy(inc, "cpu"))
    tje = TorchEngine(st.model, st.products, JAC_PATHS, 1, device="cpu",
                      increments=jac_inc)
    sj = jatm.ATMCalibrationSetup(
        engine=je, model=sj.model, covariance=sj.covariance,
        discount_curve=sj.discount_curve, forward_curve=sj.forward_curve,
        products=sj.products, jacobian_engine=jje)
    st = tatm.ATMCalibrationSetup(
        engine=te, model=st.model, covariance=st.covariance,
        discount_curve=st.discount_curve, forward_curve=st.forward_curve,
        products=st.products, jacobian_engine=tje)
    return sj, st


@pytest.fixture(scope="module")
def setups():
    rng = np.random.default_rng(20161230)
    inc = (np.sqrt(0.5) * rng.standard_normal((STEPS, 1, PATHS))
           ).astype(np.float32)
    return _setups(inc)


@pytest.fixture(scope="module")
def calibrated(setups):
    sj, st = setups
    return (sj.calibrate(max_iterations=60, accuracy=1e-7,
                         warm_start="analytic"),
            st.calibrate(max_iterations=60, accuracy=1e-7,
                         warm_start="analytic"))


def _points(st):
    x0 = np.asarray(st.covariance.initial_parameters)
    return x0, x0 * np.linspace(0.8, 1.3, x0.size)


def test_full_width(setups):
    _, st = setups
    assert st.model.num_libors == 80
    assert len(st.engine.products) == 144
    assert st.covariance.n_params == 43
    assert len(st.engine.exercise_indices) == 11
    assert st.engine.steps_needed == STEPS


def test_engine_values_and_implied_vols(setups):
    sj, st = setups
    for x in _points(st):
        v_j, v_t = np.asarray(sj.engine.values(x)), st.engine.values(x)
        assert np.all(np.isfinite(v_t)) and np.all(v_t > 0)
        np.testing.assert_allclose(v_t, v_j, rtol=1e-5, atol=0)
        np.testing.assert_allclose(st.engine.implied_vols(x),
                                   np.asarray(sj.engine.implied_vols(x)),
                                   rtol=0, atol=1e-6)


def test_engine_jacobian(setups):
    sj, st = setups
    x = _points(st)[1]
    J_j = np.asarray(sj.jacobian_engine.jacobian(x))
    J_t = st.jacobian_engine.jacobian(x)
    assert J_t.shape == J_j.shape == (144, 43)
    scale = np.maximum(np.abs(J_j).max(axis=0), 1e-8)
    rel = np.abs(J_t - J_j) / scale[None, :]
    assert rel.max() < 1e-3, rel.max()


@pytest.mark.parametrize("model_type", ["NORMAL", "DISPLACED"])
def test_analytic_approximation(model_type):
    aj = jatm.build_atm_calibration(
        num_paths=8, model_type=model_type,
        calibration_product_type="ANALYTIC").engine
    at = tatm.build_atm_calibration(
        num_paths=8, model_type=model_type,
        calibration_product_type="ANALYTIC", device="cpu").engine
    x0 = np.asarray(at.model.covariance.initial_parameters)
    for x in (x0, x0 * np.linspace(0.8, 1.3, x0.size)):
        np.testing.assert_allclose(at.residuals(x), aj.residuals(x),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(at.jacobian(x), aj.jacobian(x),
                                   rtol=0, atol=1e-10)


def test_calibration_matches_jax(calibrated):
    rj, rt = calibrated
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.parameters, rj.parameters, rtol=0,
                               atol=1e-3 * np.abs(rj.parameters).max())
    assert abs(rt.rms_error - rj.rms_error) <= 1e-3 * rj.rms_error
    assert rt.rms_error < rt.history[0]


def test_kernel_backend_calibration(setups):
    _, st = setups
    kb = ATMKernelCalibration(st.engine)
    result = st.calibrate(max_iterations=60, accuracy=1e-7,
                          warm_start="analytic", residual_backend=kb)
    dev = st.deviations(result.parameters)
    assert np.all(np.isfinite(dev)) and dev.shape == (144,)
    assert abs(float(np.mean(dev))) < 2e-4      # ATM test's own assert
    np.testing.assert_allclose(kb.residuals(result.parameters),
                               st.engine.residuals(result.parameters),
                               atol=5e-5)
