"""The port's ATM kernel backend (plain version of the kernel on the CPU)
against the JAX package's scan engine on the same injected normals —
the port's mirror of tests/test_kernel_backend.py's ATM section: the same
small ATM-family model (12 libors, 2 factors, 250 paths, numeraire
adjustment on), residuals within 5e-5 (the JAX kernel-vs-engine envelope),
and the displaced variant's CRN central-FD Jacobian within 0.05
column-scaled of the engine's exact jacfwd Jacobian."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu.models import curves as jcurves  # noqa: E402
from finmath_tpu.models import time_discretization as jtd  # noqa: E402
from finmath_tpu.models.lmm import covariance as jcov  # noqa: E402
from finmath_tpu.models.lmm import model as jmodel  # noqa: E402

from finmath_tpu_torch.models import curves as tcurves  # noqa: E402
from finmath_tpu_torch.models import time_discretization as ttd  # noqa: E402
from finmath_tpu_torch.models.lmm import covariance as tcov  # noqa: E402
from finmath_tpu_torch.models.lmm import model as tmodel  # noqa: E402
from finmath_tpu_torch.models.lmm.kernel_backend import (  # noqa: E402
    ATMKernelCalibration)

N_LIBORS, FACTORS, PATHS, STEPS = 12, 2, 250, 6
PRODUCT_GRID = ((2, 4), (4, 4), (6, 4), (6, 6))


def _increments(seed=17):
    rng = np.random.default_rng(seed)
    return (np.sqrt(0.5) * rng.standard_normal((STEPS, FACTORS, PATHS))
            ).astype(np.float32)


def _setup(curves, td_mod, cov_mod, model_mod, displaced, unit="VOLATILITYNORMAL",
           deltas_grid=None):
    fix = np.arange(0.0, 10.5, 0.5)
    fc = curves.ForwardCurveFromForwards(fix, 0.02 + 0.002 * np.sin(fix), 0.5)
    dc = curves.DiscountCurveFromForwardCurve(fc, horizon=12.0)
    td = (td_mod.TimeDiscretization(deltas_grid) if deltas_grid is not None
          else td_mod.TimeDiscretization(initial=0.0, num_steps=N_LIBORS,
                                         step=0.5))
    buckets = np.asarray([0.0, 1.0, 2.0, 4.0, 6.0])
    vol = cov_mod.LIBORVolatilityModelPiecewiseConstant(
        td, td, buckets, buckets, initial_volatility=0.005)
    corr = cov_mod.LIBORCorrelationModelExponentialDecay(td, FACTORS, decay=0.1)
    cov = cov_mod.LIBORCovarianceModelFromVolatilityAndCorrelation(vol, corr)
    if displaced:
        cov = cov_mod.DisplacedLocalVolatilityModel(cov, 4.0,
                                                    is_calibrateable=False)
    model_cls = getattr(model_mod, "LIBORMarketModelTPU", None) or \
        model_mod.LIBORMarketModelTorch
    model = model_cls(td, fc, dc, cov, measure="spot", state_space="normal",
                      use_numeraire_adjustment=True)
    tenor = model.tenor_times
    products = [model_mod.SwaptionProduct(
        exercise_index=e, num_periods=m,
        strike=curves.par_swap_rate(fc, dc, tenor[e:e + m + 1]),
        target=0.005, weight=1.0, value_unit=unit) for e, m in PRODUCT_GRID]
    return model, cov, products


def _jax_engine(displaced, inc):
    model, cov, products = _setup(jcurves, jtd, jcov, jmodel, displaced)
    return jmodel.LMMValuationEngine(model, products, PATHS, FACTORS,
                                     scan_mode="segmented", increments=inc)


def _torch_engine(displaced, inc, **kw):
    model, cov, products = _setup(tcurves, ttd, tcov, tmodel, displaced, **kw)
    return tmodel.LMMValuationEngine(model, products, PATHS, FACTORS,
                                     device="cpu", increments=inc)


@pytest.fixture(scope="module")
def inc():
    return _increments()


def test_residuals_match_jax_engine_same_normals(inc):
    je = _jax_engine(False, inc)
    te = _torch_engine(False, inc)
    kb = ATMKernelCalibration(te)
    # the backend prices the engine's own device-resident realization
    assert kb._z.data_ptr() == te.increments.data_ptr()
    x0 = np.asarray(te.model.covariance.initial_parameters)
    x1 = x0 * np.linspace(0.7, 1.6, x0.size)
    for x in (x0, x1):
        r_e = np.asarray(je.residuals(x))
        np.testing.assert_allclose(kb.residuals(x), r_e, atol=5e-5)
        np.testing.assert_allclose(te.residuals(x), r_e, atol=5e-5)
    np.testing.assert_allclose(kb.implied_vols(x0), je.implied_vols(x0),
                               atol=5e-5)


def test_displaced_variant_and_fd_jacobian(inc):
    je = _jax_engine(True, inc)
    kb = ATMKernelCalibration(_torch_engine(True, inc))
    x0 = np.asarray(je.model.covariance.initial_parameters)
    r_k = kb.residuals(x0)
    r0, J_k = kb.residuals_and_jacobian(x0)
    np.testing.assert_allclose(r_k, np.asarray(je.residuals(x0)), atol=5e-5)
    np.testing.assert_allclose(r0, r_k, atol=1e-12)
    np.testing.assert_allclose(kb.jacobian(x0), J_k, atol=1e-12)
    J_e = np.asarray(je.jacobian(x0))
    assert J_k.shape == J_e.shape
    scale = np.maximum(np.abs(J_e).max(axis=0), 1e-4)
    rel = np.abs(J_k - J_e) / scale[None, :]
    assert rel.max() < 0.05, rel.max()


def test_guards(inc):
    with pytest.raises(ValueError, match="VOLATILITYNORMAL"):
        ATMKernelCalibration(_torch_engine(False, inc, unit="VALUE"))
    grid = np.concatenate([np.arange(0.0, 3.0, 0.5), np.arange(3.0, 6.5, 0.5)
                           ]) * np.r_[np.ones(6), 1.0 + 0.02 * np.arange(7)]
    with pytest.raises(ValueError, match="uniform time step"):
        ATMKernelCalibration(_torch_engine(False, inc, deltas_grid=grid))
    kb = ATMKernelCalibration(_torch_engine(False, inc))
    with pytest.raises(ValueError, match="params shape"):
        kb.residuals(np.ones(3))


def test_engine_rejects_what_this_slice_does_not_port(inc):
    """The engine takes the options the kernel does not implement; the
    kernel backend refuses an engine built with them. Sharding is not
    ported: the engine raises."""
    model, _, products = _setup(tcurves, ttd, tcov, tmodel, False)
    for kw in (dict(scheme="predictor_corrector"),
               dict(dtype=torch.float64)):
        engine = tmodel.LMMValuationEngine(model, products, PATHS, FACTORS,
                                           device="cpu", **kw)
        with pytest.raises(ValueError, match="Euler scheme on float32"):
            ATMKernelCalibration(engine)
    with pytest.raises(NotImplementedError, match="sharding"):
        tmodel.LMMValuationEngine(model, products, PATHS, FACTORS,
                                  device="cpu", mesh=object())
    model.measure = "terminal"
    with pytest.raises(ValueError, match="spot/NORMAL"):
        ATMKernelCalibration(tmodel.LMMValuationEngine(
            model, products, PATHS, FACTORS, device="cpu"))
    with pytest.raises(ValueError):          # increments of the wrong shape
        _torch_engine(False, inc[:, :1])


def test_engine_draws_its_realization_once_from_the_seed():
    model, _, products = _setup(tcurves, ttd, tcov, tmodel, False)
    a = tmodel.LMMValuationEngine(model, products, 300, FACTORS, seed=9,
                                  device="cpu")
    b = tmodel.LMMValuationEngine(model, products, 300, FACTORS, seed=9,
                                  device="cpu")
    c = tmodel.LMMValuationEngine(model, products, 300, FACTORS, seed=10,
                                  device="cpu")
    assert tuple(a.increments.shape) == (STEPS, FACTORS, 300)
    assert a.increments.dtype == torch.float32
    assert torch.equal(a.increments, b.increments)
    assert not torch.equal(a.increments, c.increments)
    # sqrt(dt)-scaled standard normals
    assert abs(float(a.increments.std()) - np.sqrt(0.5)) < 0.03
    x0 = model.covariance.initial_parameters
    np.testing.assert_array_equal(a.residuals(x0), a.residuals(x0))
    np.testing.assert_array_equal(a.residuals(x0), b.residuals(x0))
