"""The port's stoch-vol model stack against finmath_tpu on the same seeded
inputs: the finmath Mersenne realization bit for bit, the 5-parameter,
blended and stochastic-volatility covariance tables in float64 (1e-12),
the Black implied-vol inversion (1e-10, deep in and out of the money and
at intrinsic), and the valuation engine with stochastic volatility on
identical injected normals (implied vols within 1e-6, the ``jacfwd``
Jacobian within 1e-3 column-scaled) on the reduced benchmark-family model
of tests/test_kernel_backend.py (12 libors, 3 factors, 4 products).

The port fixes the sign of each factor of the eigen-reduced correlation
(``covariance.factor_reduce``); the JAX package keeps its eigensolver's.
One test here shows the difference on the JAX package as it is, and
tests/test_torch_stochvol_calibration.py compares the engines unpatched
where the two agree; the others run the JAX package with its factors
given the port's signs (``jax_fixed_signs``, a patch of the loaded module
only), so that both packages price the same paths."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from finmath_tpu.models import brownian_motion as jbm  # noqa: E402
from finmath_tpu.models import curves as jcurves  # noqa: E402
from finmath_tpu.models import time_discretization as jtd  # noqa: E402
from finmath_tpu.models.lmm import covariance as jcov  # noqa: E402
from finmath_tpu.models.lmm import model as jmodel  # noqa: E402

from finmath_tpu_torch.models import brownian_motion as tbm  # noqa: E402
from finmath_tpu_torch.models import curves as tcurves  # noqa: E402
from finmath_tpu_torch.models import time_discretization as ttd  # noqa: E402
from finmath_tpu_torch.models.lmm import covariance as tcov  # noqa: E402
from finmath_tpu_torch.models.lmm import model as tmodel  # noqa: E402

N_LIBORS, FACTORS, PATHS = 12, 3, 256
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


X0 = np.asarray([0.20, 0.05, 0.10, 0.05, 0.10, 0.2, 0.25, 0.15])
X1 = np.asarray([0.25, 0.02, 0.15, 0.03, -0.08, 0.6, 0.8, -0.4])
BASIN = np.asarray([0.21772482, -0.00784758, -0.1260687, 0.14290155,
                    -0.14987065, 1.40476417, -1.45021006, -0.7604945])


def test_finmath_mersenne_increments_bit_equal():
    dts = np.full(40, 0.5)
    a = jbm.finmath_mersenne_increments(dts, 6, 64, 314151)
    b = tbm.finmath_mersenne_increments(dts, 6, 64, 314151)
    assert a.dtype == b.dtype == np.float32 and a.shape == (40, 6, 64)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        jbm.finmath_mersenne_increments(dts[:3], 2, 5, 7, dtype=np.float64),
        tbm.finmath_mersenne_increments(dts[:3], 2, 5, 7, dtype=np.float64))


def _benchmark_covariance(cov_mod, td_mod, num_factors=5, steps=40):
    td = td_mod.TimeDiscretization(initial=0.0, num_steps=steps, step=0.5)
    cov = cov_mod.LIBORCovarianceModelExponentialForm5Param(
        td, td, num_factors, (0.20, 0.05, 0.10, 0.05, 0.10))
    cov = cov_mod.BlendedLocalVolatilityModel(cov, blend=0.2,
                                              is_calibrateable=True)
    return cov_mod.LIBORCovarianceModelStochasticVolatility(
        cov, nu=0.15, rho=0.20, is_calibrateable=True)


@pytest.mark.parametrize("x", [X0, BASIN], ids=["initial", "basin"])
def test_covariance_tables_agree_f64(x):
    """vol_table, factor_matrix (eigenvector signs included), the blended
    local factor and stoch_vol_params at the benchmark size (40 libors, 5
    factors, 8 parameters), single and batched."""
    cj = _benchmark_covariance(jcov, jtd)
    ct = _benchmark_covariance(tcov, ttd)
    assert cj.n_params == ct.n_params == 8
    np.testing.assert_array_equal(cj.initial_parameters, ct.initial_parameters)
    assert (ct.scaling_exponent, ct.martingale_correction) == (0.5, True)
    pj, pt = cj.prepare(jnp.asarray(x)), ct.prepare(torch.as_tensor(x))
    for name in ("vol_table", "factor_matrix"):
        np.testing.assert_allclose(
            np.asarray(getattr(cj, name)(pj)),
            getattr(ct, name)(pt).numpy(), rtol=0, atol=1e-12, err_msg=name)
    rng = np.random.default_rng(13)
    L = 0.02 + 0.01 * rng.standard_normal((40, 32))
    L0 = np.broadcast_to(0.02 + 0.0005 * np.arange(40)[:, None], L.shape).copy()
    np.testing.assert_allclose(
        np.asarray(cj.local_factor(pj, jnp.asarray(L), jnp.asarray(L0))),
        ct.local_factor(pt, torch.as_tensor(L), torch.as_tensor(L0)).numpy(),
        rtol=0, atol=1e-12)
    for a, b in zip(cj.stoch_vol_params(pj), ct.stoch_vol_params(pt)):
        assert float(a) == float(b)
    X = np.stack([x, 1.1 * x])
    R_b = ct.factor_matrix(ct.prepare(torch.as_tensor(X))).numpy()
    for k in range(2):
        np.testing.assert_allclose(
            R_b[k], np.asarray(cj.factor_matrix(cj.prepare(jnp.asarray(X[k])))),
            rtol=0, atol=1e-12)


def test_factor_signs_fixed_where_the_eigensolver_flips_them():
    """The JAX package's factors carry LAPACK's signs: its dominant factor
    flips sign between decays 0.089 and 0.15 (and with it the sign of
    the rate-volatility correlation). The port's factors are the same up
    to those signs, which it fixes."""
    T = 0.5 * np.arange(40)
    for decay in (0.089, 0.15):
        corr = np.exp(-decay * np.abs(T[:, None] - T[None, :]))
        raw = np.asarray(_JAX_FACTOR_REDUCE(jnp.asarray(corr), 5))
        port = tcov.factor_reduce(torch.as_tensor(corr), 5).numpy()
        np.testing.assert_array_equal(np.sign(port[0]), [1, 1, -1, -1, 1])
        np.testing.assert_allclose(np.abs(port), np.abs(raw), rtol=0,
                                   atol=1e-12)
        if decay == 0.089:
            level = np.sign(raw[0, 0])
    assert np.sign(raw[0, 0]) == -level       # LAPACK flipped the level


def test_factor_matrix_jacobian_agrees():
    """The forward-mode derivative of the eigen-reduced factor matrix (the
    port's eigh tangent) against JAX's jacfwd."""
    import jax
    from torch.func import jacfwd

    cj = _benchmark_covariance(jcov, jtd)
    ct = _benchmark_covariance(tcov, ttd)
    Jj = jax.jacfwd(lambda p: cj.factor_matrix(cj.prepare(p)))(
        jnp.asarray(BASIN))
    Jt = jacfwd(lambda p: ct.factor_matrix(ct.prepare(p)))(
        torch.as_tensor(BASIN))
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=0,
                               atol=1e-12)


def test_black_implied_vol_agrees():
    rng = np.random.default_rng(5)
    F = 0.02 + 0.02 * rng.random(16)
    T = 1.0 + 9.0 * rng.random(16)
    A = 4.0 + rng.random(16)
    K = F * np.exp(np.linspace(-2.0, 2.0, 16))          # deep ITM .. deep OTM
    sig = np.linspace(0.05, 1.2, 16)
    sd = sig * np.sqrt(T)
    d1 = np.log(F / K) / sd + 0.5 * sd
    from scipy.stats import norm
    V = A * (F * norm.cdf(d1) - K * norm.cdf(d1 - sd))
    V[2] = A[2] * (F[2] - K[2])                          # at intrinsic
    V[4] = 0.9 * A[4] * (F[4] - K[4])                    # below intrinsic
    args = (V, F, K, T, A)
    got = tmodel.black_implied_vol(*(torch.as_tensor(a) for a in args))
    ref = np.asarray(jmodel.black_implied_vol_jnp(*(jnp.asarray(a)
                                                     for a in args)))
    assert got[2] == 0.0 and got[4] == 0.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    # the recovered vols where the quote carries information
    informative = ref > 0.0
    assert informative.sum() >= 12
    np.testing.assert_allclose(got.numpy()[informative][-8:], sig[-8:],
                               rtol=1e-6)
    # the port's implicit derivative against JAX's through the Newton
    # steps, in each of the five inputs
    import jax
    from torch.func import jacfwd

    for i in range(5):
        def f_jax(a, i=i):
            return jmodel.black_implied_vol_jnp(*(
                a if j == i else jnp.asarray(x) for j, x in enumerate(args)))

        def f_torch(a, i=i):
            return tmodel.black_implied_vol(*(
                a if j == i else torch.as_tensor(x)
                for j, x in enumerate(args)))

        d_jax = np.diagonal(np.asarray(jax.jacfwd(f_jax)(jnp.asarray(args[i]))))
        d_torch = np.diagonal(jacfwd(f_torch)(torch.as_tensor(args[i])).numpy())
        np.testing.assert_allclose(d_torch, d_jax, rtol=0,
                                   atol=1e-10 * np.abs(d_jax).max())


PRODUCT_GRID = ((2, 8, 0.0), (4, 4, 0.0), (6, 4, -0.005), (6, 6, 0.005))


def _reduced_setup(curves, td_mod, cov_mod, model_mod, grid=PRODUCT_GRID,
                   factors=FACTORS):
    """tests/test_kernel_backend.py's benchmark-family model; ``grid``
    holds (exercise index, periods, strike offset from the par rate)."""
    fix = np.arange(0.0, 10.5, 0.5)
    fc = curves.ForwardCurveFromForwards(fix, 0.02 + 0.002 * np.sin(fix), 0.5)
    dc = curves.DiscountCurveFromForwardCurve(fc, horizon=12.0)
    td = td_mod.TimeDiscretization(initial=0.0, num_steps=N_LIBORS, step=0.5)
    cov = cov_mod.LIBORCovarianceModelExponentialForm5Param(
        td, td, factors, (0.20, 0.05, 0.10, 0.05, 0.10))
    cov = cov_mod.BlendedLocalVolatilityModel(cov, blend=0.2,
                                              is_calibrateable=True)
    cov = cov_mod.LIBORCovarianceModelStochasticVolatility(
        cov, nu=0.25, rho=0.15, is_calibrateable=True)
    model_cls = getattr(model_mod, "LIBORMarketModelTPU", None) or \
        model_mod.LIBORMarketModelTorch
    model = model_cls(td, fc, dc, cov, measure="spot", state_space="normal",
                      use_numeraire_adjustment=False)
    tenor = model.tenor_times
    products = [model_mod.SwaptionProduct(
        exercise_index=e, num_periods=m,
        strike=dk + curves.par_swap_rate(fc, dc, tenor[e:e + m + 1]),
        target=0.30, weight=1.0, value_unit="VOLATILITYLOGNORMAL")
        for e, m, dk in grid]
    return model, products


def reduced_increments(seed=5, paths=PATHS, factors=FACTORS):
    rng = np.random.default_rng(seed)
    return (np.sqrt(0.5) * rng.standard_normal(
        (N_LIBORS, factors + 1, paths))).astype(np.float32)


def jax_reduced_engine(inc):
    factors = inc.shape[1] - 1
    model, products = _reduced_setup(jcurves, jtd, jcov, jmodel,
                                     factors=factors)
    return jmodel.LMMValuationEngine(model, products, inc.shape[-1], factors,
                                     scan_mode="segmented", increments=inc)


def torch_reduced_engine(inc, **kw):
    factors = inc.shape[1] - 1
    model, products = _reduced_setup(tcurves, ttd, tcov, tmodel,
                                     factors=factors)
    return tmodel.LMMValuationEngine(model, products, inc.shape[-1], factors,
                                     device="cpu", increments=inc, **kw)


@pytest.fixture(scope="module")
def engines():
    inc = reduced_increments()
    return jax_reduced_engine(inc), torch_reduced_engine(inc)


def test_engine_implied_vols_match_jax(engines):
    je, te = engines
    assert te.stoch_vol and te.injected
    assert tuple(te.increments.shape) == (6, FACTORS + 1, PATHS)
    for x in (X0, X1):
        iv_j = np.asarray(je.implied_vols(x))
        iv_t = te.implied_vols(x)
        assert np.all(iv_j > 0.05)
        np.testing.assert_allclose(iv_t, iv_j, rtol=0, atol=1e-6)
        np.testing.assert_allclose(te.residuals(x), iv_t - 0.30, atol=1e-15)


def test_engine_jacobian_matches_jax(engines):
    je, te = engines
    J_j = np.asarray(je.jacobian(X0))
    J_t = te.jacobian(X0)
    assert J_t.shape == J_j.shape == (4, 8)
    scale = np.maximum(np.abs(J_j).max(axis=0), 1e-3)
    rel = np.abs(J_t - J_j) / scale[None, :]
    assert rel.max() < 1e-3, rel.max()


def test_engine_scaling_conventions_match_jax():
    """Direct scaling without the martingale correction (finmath's own
    convention) changes the values, identically in both packages."""
    inc = reduced_increments(paths=128)
    engines = []
    for curves, td_mod, cov_mod, model_mod in (
            (jcurves, jtd, jcov, jmodel), (tcurves, ttd, tcov, tmodel)):
        model, products = _reduced_setup(curves, td_mod, cov_mod, model_mod)
        sv = model.covariance
        sv.scaling_exponent, sv.martingale_correction = 1.0, False
        if model_mod is jmodel:
            engines.append(jmodel.LMMValuationEngine(
                model, products, 128, FACTORS, scan_mode="segmented",
                increments=inc))
        else:
            engines.append(tmodel.LMMValuationEngine(
                model, products, 128, FACTORS, device="cpu", increments=inc))
    np.testing.assert_allclose(engines[1].values(X1),
                               np.asarray(engines[0].values(X1)),
                               rtol=1e-6)
    base = torch_reduced_engine(inc)
    assert not np.allclose(base.values(X1), engines[1].values(X1), rtol=1e-3)
