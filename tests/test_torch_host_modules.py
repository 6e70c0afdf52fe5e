"""The port's host-side modules against finmath_tpu: the copied NumPy
modules agree bit for bit, Levenberg-Marquardt takes identical iterates,
the covariance tables agree in float64 at the ATM size, and importing the
port pulls in no JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu.models import calibration as jcal  # noqa: E402
from finmath_tpu.models import curves as jcurves  # noqa: E402
from finmath_tpu.models import time_discretization as jtd  # noqa: E402
from finmath_tpu.models.lmm import atm_calibration as jatm  # noqa: E402
from finmath_tpu.models.lmm import covariance as jcov  # noqa: E402

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import calibration as tcal  # noqa: E402
from finmath_tpu_torch.models import curves as tcurves  # noqa: E402
from finmath_tpu_torch.models import time_discretization as ttd  # noqa: E402
from finmath_tpu_torch.models.lmm import covariance as tcov  # noqa: E402
from finmath_tpu_torch.utils.config import (resolve_device_index,  # noqa: E402
                                            select_device)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCopiedModules:
    def test_time_discretization_identical(self):
        for kw in (dict(initial=0.0, num_steps=80, step=0.5),
                   dict(initial=0.25, num_steps=7, step=1.0 / 3.0)):
            a, b = jtd.TimeDiscretization(**kw), ttd.TimeDiscretization(**kw)
            np.testing.assert_array_equal(a.as_array(), b.as_array())
            np.testing.assert_array_equal(a.get_step_sizes(),
                                          b.get_step_sizes())
            for t in (0.0, 0.3, 1.0, 2.5, 39.9, 40.0, 55.0):
                assert a.get_time_index(t) == b.get_time_index(t)
                assert (a.get_time_index_nearest_less_or_equal(t)
                        == b.get_time_index_nearest_less_or_equal(t))
                assert (a.get_time_index_nearest_greater_or_equal(t)
                        == b.get_time_index_nearest_greater_or_equal(t))

    def test_curve_bootstrap_and_par_rates_identical(self):
        dj, dt = jcurves.get_calibrated_eur_curve(), \
            tcurves.get_calibrated_eur_curve()
        np.testing.assert_array_equal(dj.times, dt.times)
        np.testing.assert_array_equal(dj.factors, dt.factors)
        fj, ft = jcurves.ForwardCurve(dj, 0.5), tcurves.ForwardCurve(dt, 0.5)
        grid = np.arange(0.0, 60.5, 0.5)
        np.testing.assert_array_equal(fj.get_forward(grid),
                                      ft.get_forward(grid))
        np.testing.assert_array_equal(dj.get_discount_factor(grid),
                                      dt.get_discount_factor(grid))
        for e, m in ((2, 2), (10, 20), (60, 20), (20, 60)):
            assert jcurves.par_swap_rate(fj, dj, grid[e:e + m + 1]) == \
                tcurves.par_swap_rate(ft, dt, grid[e:e + m + 1])

    def test_levenberg_marquardt_identical_iterates(self):
        rng = np.random.default_rng(3)
        t = np.linspace(0.0, 3.0, 25)
        y = 1.7 * np.exp(-0.8 * t) + 0.3 + 1e-3 * rng.standard_normal(t.size)

        def res(x):
            return x[0] * np.exp(-x[1] * t) + x[2] - y

        def jac(x):
            e = np.exp(-x[1] * t)
            return np.stack([e, -x[0] * t * e, np.ones_like(t)], axis=1)

        x0 = np.asarray([1.0, 0.3, 0.0])
        kw = dict(lambda0=0.1, max_iterations=50, accuracy=1e-10,
                  lower_bound=0.0)
        rj = jcal.LevenbergMarquardt(res, jac, **kw).run(x0)
        rt = tcal.LevenbergMarquardt(res, jac, **kw).run(x0)
        np.testing.assert_array_equal(rj.parameters, rt.parameters)
        assert rj.history == rt.history
        assert (rj.iterations, rj.converged, rj.lambda_final) == \
            (rt.iterations, rt.converged, rt.lambda_final)


def _atm_covariances(module, displaced):
    td = module.TimeDiscretization(initial=0.0, num_steps=80, step=0.5)
    vol = module.LIBORVolatilityModelPiecewiseConstant(
        td, td, jatm.VOL_BUCKET_GRID, jatm.VOL_BUCKET_GRID,
        initial_volatility=0.005)
    corr = module.LIBORCorrelationModelExponentialDecay(td, 3, decay=0.05)
    cov = module.LIBORCovarianceModelFromVolatilityAndCorrelation(vol, corr)
    if displaced:
        cov = module.DisplacedLocalVolatilityModel(cov, 4.0,
                                                   is_calibrateable=True)
    return cov


class _JaxCov:
    TimeDiscretization = jtd.TimeDiscretization
    LIBORVolatilityModelPiecewiseConstant = \
        jcov.LIBORVolatilityModelPiecewiseConstant
    LIBORCorrelationModelExponentialDecay = \
        jcov.LIBORCorrelationModelExponentialDecay
    LIBORCovarianceModelFromVolatilityAndCorrelation = \
        jcov.LIBORCovarianceModelFromVolatilityAndCorrelation
    DisplacedLocalVolatilityModel = jcov.DisplacedLocalVolatilityModel


class _TorchCov:
    TimeDiscretization = ttd.TimeDiscretization
    LIBORVolatilityModelPiecewiseConstant = \
        tcov.LIBORVolatilityModelPiecewiseConstant
    LIBORCorrelationModelExponentialDecay = \
        tcov.LIBORCorrelationModelExponentialDecay
    LIBORCovarianceModelFromVolatilityAndCorrelation = \
        tcov.LIBORCovarianceModelFromVolatilityAndCorrelation
    DisplacedLocalVolatilityModel = tcov.DisplacedLocalVolatilityModel


@pytest.mark.parametrize("displaced", [False, True])
def test_covariance_tables_agree_f64(displaced):
    """vol_table, factor_matrix and local_factor at the ATM size (80
    libors, 43 vol parameters; 3 factors to exercise the factor axis)."""
    import jax.numpy as jnp

    cj = _atm_covariances(_JaxCov, displaced)
    ct = _atm_covariances(_TorchCov, displaced)
    assert cj.n_params == ct.n_params == 43 + int(displaced)
    rng = np.random.default_rng(11)
    x = 0.005 * (1.0 + rng.random(cj.n_params))
    if displaced:
        x[-1] = 3.5
    L = 0.01 + 0.02 * rng.standard_normal((80, 64))
    L0 = np.broadcast_to(0.01 + 0.001 * np.arange(80)[:, None], L.shape).copy()
    pj, pt = cj.prepare(jnp.asarray(x)), ct.prepare(convert.params_from_numpy(x))
    np.testing.assert_allclose(np.asarray(cj.vol_table(pj)),
                               ct.vol_table(pt).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(cj.factor_matrix(pj)),
                               ct.factor_matrix(pt).numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(cj.local_factor(pj, jnp.asarray(L), jnp.asarray(L0))),
        ct.local_factor(pt, torch.as_tensor(L), torch.as_tensor(L0)).numpy(),
        rtol=0, atol=1e-12)
    # a batch of parameter vectors gives the batch of tables
    X = np.stack([x, 1.3 * x])
    vt_b = ct.vol_table(ct.prepare(convert.params_from_numpy(X))).numpy()
    for k in range(2):
        np.testing.assert_allclose(
            vt_b[k], np.asarray(cj.vol_table(cj.prepare(jnp.asarray(X[k])))),
            rtol=0, atol=1e-12)


class TestPackage:
    def test_import_pulls_in_no_jax(self):
        code = ("import sys, finmath_tpu_torch, finmath_tpu_torch.models.lmm,"
                " finmath_tpu_torch.convert, finmath_tpu_torch.native,"
                " finmath_tpu_torch.models.brownian_motion,"
                " finmath_tpu_torch.models.lmm.benchmark_calibration,"
                " finmath_tpu_torch.ops.lmm_stochvol_kernel; "
                "bad = [m for m in sys.modules if m == 'jax' or "
                "m.startswith(('jax.', 'finmath_tpu.')) or m == 'finmath_tpu'];"
                " print(bad); sys.exit(1 if bad else 0)")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_precision_policy(self):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"

    def test_device_index_semantics(self, monkeypatch):
        assert resolve_device_index(0, 4) == 0
        assert resolve_device_index(-1, 4) == 3
        assert resolve_device_index(-4, 4) == 0
        for bad in (4, -5):
            with pytest.raises(ValueError):
                resolve_device_index(bad, 4)
        monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
        if torch.cuda.is_available():
            assert select_device().type == "cuda"
        else:
            # no quiet CPU fallback: the caller has to ask for the CPU
            with pytest.raises(RuntimeError, match='device="cpu"'):
                select_device()
            from finmath_tpu_torch.models.lmm import (
                build_atm_calibration, build_benchmark_calibration)

            for build in (build_atm_calibration, build_benchmark_calibration):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    build(num_paths=8)
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        monkeypatch.setenv("FINMATH_TPU_DEVICE_INDEX", str(count))
        with pytest.raises(ValueError):
            select_device()

    def test_convert_round_trip(self):
        rng = np.random.default_rng(5)
        x = rng.random(43)
        t = convert.params_from_numpy(x)
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        np.testing.assert_array_equal(convert.params_to_numpy(t), x)
        inc = rng.standard_normal((6, 2, 10))
        ti = convert.increments_from_numpy(inc, "cpu")
        assert ti.dtype == torch.float32 and tuple(ti.shape) == (6, 2, 10)
        np.testing.assert_array_equal(ti.numpy(), inc.astype(np.float32))
        with pytest.raises(ValueError):
            convert.increments_from_numpy(inc[0], "cpu")
