"""The LMM engine's options (``finmath_tpu_torch/models/lmm/model.py``)
against finmath_tpu's engine on the same injected increments (seeded
NumPy, sqrt(dt)-scaled; the JAX engine in ``scan_mode="fused"``), on 10
libors, 2 factors and 1,500 paths: a piecewise-constant volatility with
exponential-decay correlation, or the benchmark's exponential form with
a blended local vol and stochastic volatility (the JAX factor reduction
given the port's factor signs, as in ``tests/test_torch_stochvol_models
.py``); six normal-vol swaptions, the numeraire adjustment on.

Tolerances:
* float32 paths: values rtol 1e-5 and implied vols atol 1e-6, as
  ``tests/test_torch_atm_calibration.py`` (the port collects in float64,
  the JAX engine in compensated float32);
* float64 paths: values rtol 1e-9, implied vols atol 1e-9;
* antithetic: the port's own antithetic increments injected into the JAX
  engine, float32 tolerances;
* the terminal-measure Bermudan (value, and the bounds under the JAX
  policy) within 1e-6 absolute of the JAX pricer's;
* ``forward_deltas`` and ``forward_delta_matrix``: rtol 1e-4 against the
  JAX ladders, with an absolute floor of 1e-4 of the largest bucket; the
  matrix's weighted rows within 1e-6 of the portfolio ladder (the
  backward sweep carries float32 cotangents); the ladder's value equal to
  the weighted ``values`` to 1e-12;
* the port's float32 against its own float64 on one stream: every value
  within 1e-6 relative (``tests/test_price_parity.py:28-56``) on the ATM
  setup (80 libors, 144 products, 2,000 paths) and the stoch-vol
  benchmark (2,048 paths) at their initial points; at the first curated
  basin the trimmed criterion (``tests/test_price_parity.py:58-86``):
  fewer than 0.5% of paths with a pathwise gap of 1e-3 or more, the kept
  mean within 1e-6; ``pathwise_values`` row means equal ``values`` to
  rtol 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from finmath_tpu.models import curves as jcurves  # noqa: E402
from finmath_tpu.models import time_discretization as jtd  # noqa: E402
from finmath_tpu.models.lmm import bermudan as jberm  # noqa: E402
from finmath_tpu.models.lmm import covariance as jcov  # noqa: E402
from finmath_tpu.models.lmm import model as jmodel  # noqa: E402

from finmath_tpu_torch.models import curves as tcurves  # noqa: E402
from finmath_tpu_torch.models import time_discretization as ttd  # noqa: E402
from finmath_tpu_torch.models.lmm import bermudan as tberm  # noqa: E402
from finmath_tpu_torch.models.lmm import covariance as tcov  # noqa: E402
from finmath_tpu_torch.models.lmm import model as tmodel  # noqa: E402
from finmath_tpu_torch.models.lmm import (  # noqa: E402
    build_atm_calibration, build_benchmark_calibration)
from finmath_tpu_torch.models.lmm.benchmark_calibration import (  # noqa: E402
    CURATED_BASINS)

HORIZON, DT, FACTORS, PATHS, CPU = 5.0, 0.5, 2, 1_500, "cpu"
FORWARDS = np.linspace(0.02, 0.035, 11)
SWAPTIONS = ((2, 4, 0.0), (2, 8, 0.002), (4, 2, 0.0), (4, 6, -0.003),
             (6, 4, 0.0), (8, 2, 0.001))
_JAX_FACTOR_REDUCE = jcov.factor_reduce


def _jax_factor_reduce_fixed_signs(corr, num_factors):
    """The JAX package's factor reduction with the port's column signs."""
    R = _JAX_FACTOR_REDUCE(corr, num_factors)
    signs = jnp.asarray(
        (tcov.FACTOR_SIGNS + (1.0,) * num_factors)[:num_factors])
    return R * jnp.where(R[..., :1, :] * signs < 0, -1.0, 1.0)


@pytest.fixture(scope="module", autouse=True)
def jax_fixed_signs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcov, "factor_reduce", _jax_factor_reduce_fixed_signs)
        yield


def _model(port, measure="spot", state_space="normal", sim_dt=None,
           stoch_vol=False):
    """(model, products, covariance) of one package."""
    curves, cov, mod, td = ((tcurves, tcov, tmodel, ttd) if port
                            else (jcurves, jcov, jmodel, jtd))
    n = int(HORIZON / DT)
    fc = curves.ForwardCurveFromForwards(
        np.arange(0.0, HORIZON + DT, DT), FORWARDS, DT)
    dc = curves.DiscountCurveFromForwardCurve(fc, horizon=HORIZON)
    libor_td = td.TimeDiscretization(initial=0.0, num_steps=n, step=DT)
    sim_td = (td.TimeDiscretization(initial=0.0,
                                    num_steps=int(HORIZON / sim_dt),
                                    step=sim_dt) if sim_dt else libor_td)
    normal = state_space == "normal"
    if stoch_vol:
        k = cov.LIBORCovarianceModelExponentialForm5Param(
            sim_td, libor_td, FACTORS, (0.20, 0.05, 0.10, 0.05, 0.10)
            if normal else (0.02, 0.005, 0.10, 0.01, 0.10))
        if normal:
            k = cov.BlendedLocalVolatilityModel(k, blend=0.2)
        k = cov.LIBORCovarianceModelStochasticVolatility(k, nu=0.3, rho=0.2)
    else:
        vol = cov.LIBORVolatilityModelPiecewiseConstant(
            sim_td, libor_td, np.asarray([0.0, 1.0, 2.0]),
            np.asarray([0.0, 1.0, 3.0]),
            initial_volatility=0.008 if normal else 0.3)
        corr = cov.LIBORCorrelationModelExponentialDecay(libor_td, FACTORS,
                                                         decay=0.1)
        k = cov.LIBORCovarianceModelFromVolatilityAndCorrelation(vol, corr)
    model_cls = (mod.LIBORMarketModelTorch if port
                 else mod.LIBORMarketModelTPU)
    model = model_cls(libor_td, fc, dc, k, measure=measure,
                      state_space=state_space, use_numeraire_adjustment=True,
                      simulation_td=sim_td)
    tenor = model.tenor_times
    products = [mod.SwaptionProduct(
        e, m, curves.par_swap_rate(fc, dc, tenor[e:e + m + 1]) + dk, 0.0,
        value_unit="VOLATILITYNORMAL") for e, m, dk in SWAPTIONS]
    return model, products, k


def _increments(model, stoch_vol, seed=11):
    dts = np.diff(model.sim_times)
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((len(dts), FACTORS + int(stoch_vol), PATHS))
    return (z * np.sqrt(dts)[:, None, None]).astype(np.float32)


def _engines(model_kw, dtype=torch.float32, collect_dtype=None,
             scheme="euler"):
    mj, pj, _ = _model(False, **model_kw)
    mt, pt, kt = _model(True, **model_kw)
    inc = _increments(mj, model_kw.get("stoch_vol", False))
    je = jmodel.LMMValuationEngine(
        mj, pj, PATHS, FACTORS, increments=inc, scan_mode="fused",
        scheme=scheme,
        dtype=jnp.float64 if dtype == torch.float64 else None,
        collect_dtype=jnp.float32 if collect_dtype == torch.float32 else None)
    te = tmodel.LMMValuationEngine(
        mt, pt, PATHS, FACTORS, device=CPU, increments=inc, scheme=scheme,
        dtype=dtype, collect_dtype=collect_dtype)
    return je, te, np.asarray(kt.initial_parameters) * 1.1


CASES = {
    "float64": (dict(), dict(dtype=torch.float64)),
    "collect_float32": (dict(), dict(collect_dtype=torch.float32)),
    "predictor_corrector": (dict(), dict(scheme="predictor_corrector")),
    "terminal": (dict(measure="terminal"), dict()),
    "lognormal": (dict(state_space="lognormal"), dict()),
    "refined_grid": (dict(sim_dt=0.25), dict()),
    "stochvol_refined_terminal": (
        dict(stoch_vol=True, sim_dt=0.25, measure="terminal"),
        dict(scheme="predictor_corrector")),
    "stochvol_lognormal_float64": (
        dict(stoch_vol=True, state_space="lognormal"),
        dict(dtype=torch.float64, scheme="predictor_corrector")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_option_matches_jax(case):
    model_kw, engine_kw = CASES[case]
    je, te, x = _engines(model_kw, **engine_kw)
    f64 = engine_kw.get("dtype") == torch.float64
    vj, vt = np.asarray(je.values(x)), te.values(x)
    assert vt.shape == (len(SWAPTIONS),) and np.all(vt > 0)
    np.testing.assert_allclose(vt, vj, rtol=1e-9 if f64 else 1e-5, atol=0)
    np.testing.assert_allclose(te.implied_vols(x),
                               np.asarray(je.implied_vols(x)), rtol=0,
                               atol=1e-9 if f64 else 1e-6)
    if model_kw.get("sim_dt"):
        assert te.num_steps == 20 and te.steps_needed == 16


def test_antithetic_matches_jax():
    mt, pt, kt = _model(True)
    te = tmodel.LMMValuationEngine(mt, pt, PATHS, FACTORS, seed=5,
                                   device=CPU, antithetic=True)
    inc = te.increments.numpy()
    half = PATHS // 2
    np.testing.assert_array_equal(inc[..., half:], -inc[..., :half])
    mj, pj, _ = _model(False)
    # the JAX fused scan reads one step past the last event: pad with steps
    # no collection sees
    padded = np.concatenate(
        [inc, np.zeros((te.num_steps - inc.shape[0],) + inc.shape[1:],
                       np.float32)])
    je = jmodel.LMMValuationEngine(mj, pj, PATHS, FACTORS,
                                   increments=padded, scan_mode="fused")
    x = np.asarray(kt.initial_parameters)
    np.testing.assert_allclose(te.values(x), np.asarray(je.values(x)),
                               rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="even"):
        tmodel.LMMValuationEngine(mt, pt, PATHS + 1, FACTORS, device=CPU,
                                  antithetic=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tmodel.LMMValuationEngine(mt, pt, PATHS, FACTORS, device=CPU,
                                  antithetic=True, increments=inc)


def test_option_errors():
    mt, pt, _ = _model(True, sim_dt=0.25)
    # a covariance on the tenor grid cannot drive a refined simulation grid
    tenor_cov = _model(True)[2]
    model = tmodel.LIBORMarketModelTorch(
        mt.libor_td, mt.forward_curve, mt.discount_curve, tenor_cov,
        simulation_td=mt.simulation_td)
    engine = tmodel.LMMValuationEngine(model, pt, 64, FACTORS, device=CPU)
    with pytest.raises(ValueError, match="simulation"):
        engine.values(tenor_cov.initial_parameters)
    with pytest.raises(ValueError, match="scheme"):
        tmodel.LMMValuationEngine(mt, pt, 64, FACTORS, device=CPU,
                                  scheme="milstein")
    with pytest.raises(NotImplementedError, match="sharding"):
        tmodel.LMMValuationEngine(mt, pt, 64, FACTORS, device=CPU,
                                  mesh=object())


def test_terminal_bermudan_matches_jax():
    exercises, maturity = (2, 4, 6), 10
    mj, _, _ = _model(False, measure="terminal")
    mt, _, kt = _model(True, measure="terminal")
    strike = float(tcurves.par_swap_rate(mt.forward_curve, mt.discount_curve,
                                         mt.tenor_times[2:11]))
    x = np.asarray(kt.initial_parameters)
    inc, inc2 = _increments(mj, False, 7), _increments(mj, False, 8)

    jp = jberm.BermudanSwaptionPricer(
        mj, jberm.BermudanSwaption(exercises, maturity, strike), PATHS,
        FACTORS)

    def injected(increments, seed):
        # the JAX pricer's collector passes no increments: route them
        engine = jmodel.LMMValuationEngine(
            mj, list(jp._engine.products), PATHS, FACTORS, seed,
            increments=increments, scan_mode="fused")
        simulate = engine._simulate_collect
        engine._simulate_collect = (
            lambda params, collect: simulate(params, collect,
                                             inc=engine._inc_dev))
        return engine

    jp._engine = injected(inc, jp.seed)
    jp._price_fn = jax.jit(jp._build_price_fn(jp._engine))
    jp._bounds_engine = injected(inc2, jp.seed + 1)
    jp._bounds_fn = jax.jit(jp._build_bounds_fn(jp._bounds_engine))
    value_j, betas_j = jp._price_fn(jnp.asarray(x))
    lo_j, hi_j = jp._bounds_fn(jnp.asarray(x), betas_j)

    tp = tberm.BermudanSwaptionPricer(
        mt, tberm.BermudanSwaption(exercises, maturity, strike), PATHS,
        FACTORS, device=CPU)
    products = list(tp._engine.products)
    tp._engine = tmodel.LMMValuationEngine(mt, products, PATHS, FACTORS,
                                           device=CPU, increments=inc)
    tp._bounds_engine = tmodel.LMMValuationEngine(
        mt, products, PATHS, FACTORS, device=CPU, increments=inc2)
    value_t = tp.get_value(x)
    assert 0.0 < value_t == pytest.approx(float(value_j), abs=1e-6)
    lo_t, hi_t = tp.get_value_bounds(
        x, betas=tuple(np.asarray(b) for b in betas_j))
    assert lo_t == pytest.approx(float(lo_j), abs=1e-6)
    assert hi_t == pytest.approx(float(hi_j), abs=1e-6)
    assert lo_t <= hi_t


DELTA_CASES = {
    "lognormal_refined": dict(state_space="lognormal", sim_dt=0.25),
    "stochvol_terminal": dict(stoch_vol=True, measure="terminal"),
}


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_forward_deltas_match_jax(case):
    je, te, x = _engines(DELTA_CASES[case])
    w = np.linspace(1.0, 2.0, len(SWAPTIONS))
    vj, gj = je.forward_deltas(x, weights=w)
    vt, gt = te.forward_deltas(x, weights=w)
    assert vt == pytest.approx(float(w @ te.values(x)), rel=1e-12)
    assert vt == pytest.approx(vj, rel=1e-4)
    gj = np.asarray(gj)
    assert gt.shape == (10,) and np.all(np.isfinite(gt)) and np.any(gt != 0)
    np.testing.assert_allclose(gt, gj, rtol=1e-4,
                               atol=1e-4 * np.abs(gj).max())
    if case == "stochvol_terminal":
        Mj = np.asarray(je.forward_delta_matrix(x))
        Mt = te.forward_delta_matrix(x)
        assert Mt.shape == (len(SWAPTIONS), 10)
        np.testing.assert_allclose(Mt, Mj, rtol=1e-4,
                                   atol=1e-4 * np.abs(Mj).max())
        # one ladder: the per-product rows weighted (float32 cotangents)
        np.testing.assert_allclose(w @ Mt, gt, rtol=1e-6,
                                   atol=1e-12 * np.abs(gt).max())


def _max_rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("setup", ["atm", "stochvol"])
def test_float32_within_1e6_of_float64(setup):
    if setup == "atm":
        build = dict(num_paths=2_000, num_factors=1, seed=31415, device=CPU)
        s32, s64 = (build_atm_calibration(**build, dtype=d)
                    for d in (torch.float32, torch.float64))
        assert len(s32.engine.products) == 144
    else:
        build = dict(num_paths=2_048, seed=314151, device=CPU)
        s32, s64 = (build_benchmark_calibration(**build, dtype=d)
                    for d in (torch.float32, torch.float64))
    assert s64.engine.increments.dtype == torch.float64
    # one stream: the float64 engine's normals are the float32 draws, so
    # its increments are the float32 engine's within float32 rounding
    torch.testing.assert_close(s64.engine.increments.float(),
                               s32.engine.increments, rtol=2.4e-7, atol=0)
    p0 = s32.covariance.initial_parameters
    assert _max_rel(s32.engine.values(p0), s64.engine.values(p0)) < 1e-6


def test_float32_parity_at_the_calibrated_basin():
    build = dict(num_paths=2_048, seed=314151, device=CPU)
    s32, s64 = (build_benchmark_calibration(**build, dtype=d)
                for d in (torch.float32, torch.float64))
    basin = CURATED_BASINS[0]
    c32 = s32.engine.pathwise_values(basin)
    c64 = s64.engine.pathwise_values(basin)
    assert c32.shape == (15, 2_048)
    np.testing.assert_allclose(c64.mean(axis=1), s64.engine.values(basin),
                               rtol=1e-12, atol=0)
    keep = np.abs(c32 - c64).max(axis=0) < 1e-3
    assert (~keep).sum() < 5e-3 * c32.shape[1]
    assert _max_rel(c32[:, keep].mean(axis=1),
                    c64[:, keep].mean(axis=1)) < 1e-6
