"""The port's stoch-vol calibration path against finmath_tpu: the kernel
backend (plain version of the kernel on the CPU) against the JAX engine on
the same injected normals — the port's mirror of
tests/test_kernel_backend.py's stoch-vol section (residuals within 5e-5 at
X0 and X1, the CRN central-FD Jacobian within 0.05 column-scaled of the
port's exact ``jacfwd``, realizations by index, scope guards) — and the
full-width benchmark setup and its multistart gate against the JAX
package's. As in tests/test_torch_stochvol_models.py, the JAX package
runs with its factors given the port's signs (``jax_fixed_signs``), but
for one comparison with the JAX package as it is, at a decay where its
eigensolver's signs are the port's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from finmath_tpu.models.lmm import benchmark_calibration as jbench  # noqa: E402
from finmath_tpu.models.lmm import covariance as jcov  # noqa: E402

from finmath_tpu_torch.models.lmm import benchmark_calibration as tbench  # noqa: E402
from finmath_tpu_torch.models.lmm.kernel_backend import (  # noqa: E402
    StochVolKernelCalibration)

from test_torch_stochvol_models import (  # noqa: E402, F401
    _JAX_FACTOR_REDUCE, FACTORS, N_LIBORS, PATHS, X0, X1, _reduced_setup,
    jax_fixed_signs, jax_reduced_engine, reduced_increments,
    torch_reduced_engine)


@pytest.fixture(scope="module")
def engines():
    inc = reduced_increments()
    return jax_reduced_engine(inc), torch_reduced_engine(inc), inc


def test_backend_residuals_match_jax_engine(engines):
    je, te, _ = engines
    kb = StochVolKernelCalibration(te)
    # the backend prices the engine's own device-resident realization
    assert kb.num_realizations == 1
    assert kb._z[0].data_ptr() == te.increments.data_ptr()
    for x in (X0, X1):
        r_e = np.asarray(je.residuals(x))
        np.testing.assert_allclose(kb.residuals(x), r_e, atol=5e-5)
        np.testing.assert_allclose(te.residuals(x), r_e, atol=5e-5)
    iv = kb.implied_vols(X0)
    np.testing.assert_allclose(iv, np.asarray(je.implied_vols(X0)), atol=5e-5)
    np.testing.assert_allclose(kb.deviations(X0), iv - je.targets, atol=1e-12)
    R = kb.residuals_batch(np.stack([X0, X1]))
    np.testing.assert_allclose(R[1], kb.residuals(X1), atol=1e-12)


def test_backend_matches_unpatched_jax_engine(monkeypatch):
    """The JAX package with its own eigensolver's factor signs. On the
    reduced model with two factors at X0's decay (0.10) those are the
    port's (+, +), so the port's engine and kernel backend price what the
    JAX engine prices, unpatched."""
    monkeypatch.setattr(jcov, "factor_reduce", _JAX_FACTOR_REDUCE)
    inc = reduced_increments(factors=2)
    je, te = jax_reduced_engine(inc), torch_reduced_engine(inc)
    from finmath_tpu.models import curves as jcurves
    from finmath_tpu.models import time_discretization as jtd
    from finmath_tpu.models.lmm import model as jmodel

    cov = _reduced_setup(jcurves, jtd, jcov, jmodel, factors=2)[0].covariance
    R = np.asarray(cov.factor_matrix(cov.prepare(jnp.asarray(X0))))
    np.testing.assert_array_equal(np.sign(R[0]), [1.0, 1.0])
    iv_j = np.asarray(je.implied_vols(X0))
    np.testing.assert_allclose(te.implied_vols(X0), iv_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(StochVolKernelCalibration(te).residuals(X0),
                               np.asarray(je.residuals(X0)), atol=5e-5)


def test_fd_jacobian_tracks_jacfwd(engines):
    _, te, _ = engines
    kb = StochVolKernelCalibration(te)
    r0, J_k = kb.residuals_and_jacobian(X0)
    np.testing.assert_allclose(r0, kb.residuals(X0), atol=1e-12)
    np.testing.assert_allclose(kb.jacobian(X0), J_k, atol=1e-12)
    J_e = te.jacobian(X0)
    assert J_k.shape == J_e.shape == (4, 8)
    scale = np.maximum(np.abs(J_e).max(axis=0), 1e-3)
    rel = np.abs(J_k - J_e) / scale[None, :]
    assert rel.max() < 0.05, (rel.max(), np.unravel_index(rel.argmax(),
                                                          rel.shape))


def test_realization_index(engines):
    _, te, _ = engines
    kb = StochVolKernelCalibration(te)
    inc2 = reduced_increments(seed=11)
    k = kb.add_realization(inc2)
    assert k == 1 and kb.num_realizations == 2
    r0, r1 = kb.residuals(X0), kb.residuals(X0, k=k)
    assert not np.allclose(r0, r1)
    np.testing.assert_allclose(r0, kb.residuals(X0, 0), atol=0)
    # the new realization matches the JAX engine on ITS stream
    np.testing.assert_allclose(
        r1, np.asarray(jax_reduced_engine(inc2).residuals(X0)), atol=5e-5)
    np.testing.assert_allclose(kb.jacobian(X0, k=k),
                               kb.residuals_and_jacobian(X0, k=k)[1],
                               atol=1e-12)
    # realizations given explicitly: k = 0 is the first of them
    kb2 = StochVolKernelCalibration(te, [inc2])
    np.testing.assert_allclose(kb2.residuals(X0), r1, atol=0)


def test_scope_guards(engines):
    _, te, inc = engines
    with pytest.raises(ValueError, match="realization shape"):
        StochVolKernelCalibration(
            te, [np.zeros((N_LIBORS, FACTORS + 1, 64), np.float32)])
    with pytest.raises(ValueError, match="params shape"):
        StochVolKernelCalibration(te).residuals(np.ones(3))
    from finmath_tpu_torch.models import curves as tcurves
    from finmath_tpu_torch.models import time_discretization as ttd
    from finmath_tpu_torch.models.lmm import covariance as tcov
    from finmath_tpu_torch.models.lmm import model as tmodel
    from finmath_tpu_torch.models.lmm.atm_calibration import (
        build_atm_calibration)

    atm = build_atm_calibration(num_paths=128, num_factors=1, seed=1,
                                device="cpu")
    with pytest.raises(ValueError):          # the ATM engine is refused
        StochVolKernelCalibration(atm.engine)

    def engine(**changes):
        model, products = _reduced_setup(tcurves, ttd, tcov, tmodel)
        for k, v in changes.items():
            setattr(model.covariance if k != "use_numeraire_adjustment"
                    else model, k, v)
        return tmodel.LMMValuationEngine(model, products, PATHS, FACTORS,
                                         device="cpu", increments=inc)

    with pytest.raises(ValueError, match="sqrt-scaling"):
        StochVolKernelCalibration(engine(scaling_exponent=1.0))
    with pytest.raises(ValueError, match="sqrt-scaling"):
        StochVolKernelCalibration(engine(martingale_correction=False))
    with pytest.raises(ValueError, match="numeraire"):
        StochVolKernelCalibration(engine(use_numeraire_adjustment=True))


@pytest.fixture(scope="module")
def full_width():
    kw = dict(num_paths=256, brownian="finmath_mersenne")
    return (jbench.build_benchmark_calibration(**kw),
            tbench.build_benchmark_calibration(device="cpu", **kw))


def test_full_width_setup_matches_jax(full_width):
    js, ts = full_width
    assert len(ts.engine.products) == len(js.engine.products) == 15
    assert ts.covariance.n_params == js.covariance.n_params == 8
    for name, key in (("_strike", "strike"), ("_target", "target"),
                      ("_ann0", "ann0"), ("_fwd0", "fwd0"),
                      ("_texp", "texp")):
        np.testing.assert_allclose(ts.engine._t[key].numpy(),
                                   np.asarray(getattr(js.engine, name)),
                                   rtol=0, atol=1e-12, err_msg=name)
    assert [(p.exercise_index, p.num_periods) for p in ts.engine.products] \
        == [(p.exercise_index, p.num_periods) for p in js.engine.products]
    np.testing.assert_array_equal(ts.engine.increments.numpy(),
                                  js.engine._inc_np[:20])
    for basin in (tbench.CURATED_BASINS, jbench.CURATED_BASINS):
        assert len(basin) == 4
    np.testing.assert_array_equal(np.stack(tbench.CURATED_BASINS),
                                  np.stack(jbench.CURATED_BASINS))


def test_multistart_gate_picks_the_same_basin(full_width):
    """With a loose target the gate fires on the best-scored curated basin
    after the four full-path evaluations, in both packages, with the same
    scores.

    On the first 256 reference paths no path of these basins leaves the
    float32 range in the JAX engine's collection. Further along the
    stream (path 419 at the first basin) rates reach hundreds of percent;
    there the JAX engine's compensated float32 bond product
    prod(1 + delta L) overflows and drops the path as NaN, while the
    port's float64 collection (and both packages' kernels) value it, and
    the scores differ by design."""
    js, ts = full_width
    rj = js.calibrate_multistart(target_rms19=10.0)
    rt = ts.calibrate_multistart(target_rms19=10.0)
    assert rt.stages["gate_fired"] is rj.stages["gate_fired"] is True
    np.testing.assert_array_equal(rt.parameters, rj.parameters)
    np.testing.assert_allclose(rt.history, rj.history, rtol=1e-5)
    np.testing.assert_allclose(rt.rms_error, rj.rms_error, rtol=1e-5)
    assert rt.stages["sweep_mode"] == "sequential"
    assert len(rt.history) == len(tbench.CURATED_BASINS)
    assert min(rt.history) == rt.stages["gate_best_rms"]


def test_short_multistart_finishes_finite():
    """Every stage of the multistart (gate, stage 1, sweep, rank, polish)
    on the reduced model with five ATM quotes (stage 1 fits five
    parameters to them) and two smile quotes, the full-path evaluations
    through the kernel backend."""
    from finmath_tpu_torch.models import curves as tcurves
    from finmath_tpu_torch.models import time_discretization as ttd
    from finmath_tpu_torch.models.lmm import covariance as tcov
    from finmath_tpu_torch.models.lmm import model as tmodel

    grid = [(1, 4, 0.0), (2, 4, 0.0), (3, 4, 0.0), (4, 4, 0.0), (4, 6, 0.0),
            (2, 4, -0.005), (2, 4, 0.005)]
    model, products = _reduced_setup(tcurves, ttd, tcov, tmodel, grid)
    te = tmodel.LMMValuationEngine(model, products, 128, FACTORS,
                                   device="cpu",
                                   increments=reduced_increments(paths=128))
    setup = tbench.BenchmarkCalibrationSetup(
        engine=te, model=model, covariance=model.covariance,
        products=products)
    assert setup.sweep_engine() is te          # too few paths to reduce
    res = setup.calibrate_multistart(max_starts=2, max_nfev=5,
                                     kernel_backend=StochVolKernelCalibration(te))
    assert np.all(np.isfinite(res.parameters))
    assert np.isfinite(res.rms_error)
    assert res.stages["gate_fired"] is False
    assert res.stages["sweep_candidates"] == 2
    for key in ("gate_s", "stage1_s", "sweep_s", "rank_s", "polish_s",
                "total_s"):
        assert res.stages[key] >= 0.0


def test_sweep_engine_and_unported_options():
    setup = tbench.build_benchmark_calibration(
        num_paths=33_000, brownian="finmath_mersenne", device="cpu")
    sweep = setup.sweep_engine()
    assert sweep.num_paths == 8_250 and sweep.injected
    # the Mersenne stream is path-outer: the prefix IS the smaller
    # realization
    np.testing.assert_array_equal(sweep.increments.numpy(),
                                  setup.engine.increments[:, :, :8_250].numpy())
    assert setup.sweep_engine() is sweep
    with pytest.raises(NotImplementedError, match="batched"):
        setup.calibrate_multistart(sweep_mode="batched")
    with pytest.raises(ValueError, match="sweep_mode"):
        setup.calibrate_multistart(sweep_mode="nope")
    with pytest.raises(NotImplementedError):
        setup.set_increments(None)
    with pytest.raises(NotImplementedError, match="qmc"):
        tbench.build_benchmark_calibration(num_paths=64, brownian="sobol",
                                           device="cpu")
    with pytest.raises(ValueError, match="brownian"):
        tbench.build_benchmark_calibration(num_paths=64, brownian="nope",
                                           device="cpu")
