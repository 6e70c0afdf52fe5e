"""The port's Jarrow-Yildirim model (``finmath_tpu_torch/models/
inflation.py``) against finmath_tpu's.

Tolerances against the JAX package:
* the analytic layer (the propagated moments, ``_cpi_coeffs``, ZCIS par
  rate and value, YoY forwards, swaplets and par rates, the
  bivariate-lognormal caplets and floorlets): 1e-12 relative; the same
  NumPy float64 arithmetic (measured: equal);
* the simulation on the JAX stream (``_xccy_scan``'s normals drawn in the
  test and injected through ``normals=``): the CPI within 32 float32 ulps
  of its largest value, ``mc_zcis_value``, ``mc_yoy_forward`` and
  ``mc_yoy_caplet`` (estimates and errors) within 1e-6 relative
  (measured: 1 ulp, 2.0e-7).
The rest are ``tests/test_inflation.py``'s cases on the port's own stream
at that file's sizes and seeds."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import inflation as ti  # noqa: E402
from finmath_tpu_torch.models.curves import DiscountCurve  # noqa: E402
from finmath_tpu_torch.models.hull_white import HullWhiteModel  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

from test_torch_cross_currency import within_ulps, xccy_stream  # noqa: E402

CPU = "cpu"
T_GRID = np.arange(0.0, 21.0)
DF_N, DF_R = np.exp(-0.03 * T_GRID), np.exp(-0.01 * T_GRID)
NOM = HullWhiteModel(DiscountCurve(T_GRID, DF_N), 0.1, 0.01)
REAL = HullWhiteModel(DiscountCurve(T_GRID, DF_R), 0.2, 0.006)
PARITY_PATHS, PARITY_SEED = 4_000, 3


def make_jy(rho_nr=0.3, rho_ni=0.1, rho_ri=-0.3, cpi_vol=0.012):
    return ti.JarrowYildirimModel(NOM, REAL, 100.0, cpi_vol, rho_nr,
                                  rho_ni, rho_ri)


def _td():
    return TimeDiscretization(initial=0.0, num_steps=20, step=0.5)


@pytest.fixture(scope="module")
def jax_side():
    from finmath_tpu.models import inflation as ji
    from finmath_tpu.models.curves import DiscountCurve as JDC
    from finmath_tpu.models.hull_white import HullWhiteModel as JHW
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    nom = JHW(JDC(T_GRID, DF_N), 0.1, 0.01)
    real = JHW(JDC(T_GRID, DF_R), 0.2, 0.006)
    models = {
        "flat": ji.JarrowYildirimModel(nom, real, 100.0, 0.012, 0.3, 0.1,
                                       -0.3),
        "piecewise": ji.JarrowYildirimModel(
            nom, real, 100.0, [0.012, 0.02], 0.3, 0.1, -0.3,
            cpi_vol_times=[0.0, 3.0])}
    sim = ji.JarrowYildirimSimulation(
        models["flat"], JTD(initial=0.0, num_steps=20, step=0.5),
        num_paths=PARITY_PATHS, seed=PARITY_SEED)
    return dict(ji=ji, models=models, sim=sim,
                normals=xccy_stream(PARITY_SEED, 20, PARITY_PATHS))


def _port_model(name):
    if name == "flat":
        return make_jy()
    return ti.JarrowYildirimModel(NOM, REAL, 100.0, [0.012, 0.02], 0.3, 0.1,
                                  -0.3, cpi_vol_times=[0.0, 3.0])


def _analytic_values(jy):
    times = np.arange(0.0, 10.5, 0.5)
    mu, sig, trans = jy._moments(times)
    d, a_int_n = jy._cpi_coeffs(times)
    out = [mu, sig, trans, d, a_int_n, jy.zcis_par_rate(5.0),
           jy.zcis_value(5.0, 0.02),
           jy.yoy_swap_par_rate(np.arange(1.0, 11.0)),
           jy.yoy_swaplet_value(4.0, 5.0, 0.015)]
    for t1, t2 in ((0.0, 1.0), (4.0, 5.0), (2.5, 3.5), (9.0, 10.0)):
        out.append(jy.yoy_forward(t1, t2))
        for k in (0.0, 0.02, 0.04):
            out += [jy.yoy_caplet(t1, t2, k), jy.yoy_caplet(t1, t2, k, False)]
    return out


class TestAgainstJax:
    @pytest.mark.parametrize("name", ["flat", "piecewise"])
    def test_analytic_layer(self, jax_side, name):
        a = _analytic_values(jax_side["models"][name])
        b = _analytic_values(_port_model(name))
        for x, y in zip(b, a):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-300)

    def test_model_from_jax_prices_the_same(self, jax_side):
        jy = jax_side["models"]["piecewise"]
        ty = convert.jarrow_yildirim_model_from_jax(jy)
        assert ty.cpi0 == jy.cpi0
        np.testing.assert_array_equal(ty.xccy.fx_vol_times,
                                      jy.xccy.fx_vol_times)
        for x, y in zip(_analytic_values(ty), _analytic_values(jy)):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-300)

    def test_simulation_on_the_jax_stream(self, jax_side):
        js = jax_side["sim"]
        ts = ti.JarrowYildirimSimulation(
            make_jy(), _td(), num_paths=PARITY_PATHS, seed=PARITY_SEED,
            device=CPU, normals=jax_side["normals"])
        for t in (1.0, 5.0, 10.0):
            assert within_ulps(np.asarray(js.cpi(t).get_realizations())[None],
                               np.asarray(ts.cpi(t).get_realizations())[None])
        np.testing.assert_allclose(ts.mc_zcis_value(5.0, 0.02),
                                   js.mc_zcis_value(5.0, 0.02), rtol=1e-6)
        for t1, t2 in ((4.0, 5.0), (9.0, 10.0)):
            np.testing.assert_allclose(ts.mc_yoy_forward(t1, t2),
                                       js.mc_yoy_forward(t1, t2), rtol=1e-6)
            for k in (0.01, 0.02, 0.04):
                for cap in (True, False):
                    np.testing.assert_allclose(
                        ts.mc_yoy_caplet(t1, t2, k, cap),
                        js.mc_yoy_caplet(t1, t2, k, cap), rtol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_inflation.py's cases on the port's own stream
# ---------------------------------------------------------------------------

class TestMoments:
    def test_propagation_matches_hull_white_state(self):
        jy = make_jy()
        times = np.arange(0.0, 10.5, 0.5)
        mu, sig, _ = jy._moments(times)
        for j, t in enumerate(times):
            if t == 0.0:
                continue
            phi_n, _, v_n = NOM.gaussian_state(float(t))
            phi_r, _, v_r = REAL.gaussian_state(float(t))
            assert abs(sig[j][0, 0] - phi_n) < 1e-14
            assert abs(sig[j][1, 1] - v_n) < 1e-14
            assert abs(sig[j][2, 2] - phi_r) < 1e-14
            assert abs(sig[j][3, 3] - v_r) < 1e-14
        assert np.allclose(mu[:, [0, 1, 4]], 0.0)
        assert mu[-1, 2] > 0.0 and mu[-1, 3] > 0.0
        with pytest.raises(ValueError, match="start at 0"):
            jy._moments(np.array([0.5, 1.0]))

    def test_grid_invariance(self):
        jy = make_jy()
        a = jy.yoy_forward(4.0, 5.0)
        times_fine = np.arange(0.0, 5.05, 0.1)
        j1, j2 = 40, 50
        d, a_int_n = jy._cpi_coeffs(times_fine)
        e = np.array([0.0, 1.0, 0.0, -1.0, 1.0])
        f = np.array([0.0, -1.0, 0.0, 0.0, 0.0])
        mean, var = jy._exp_affine(times_fine, -e, e + f, j1, j2)
        b = math.exp(d[j2] - d[j1] - a_int_n[j2] + mean
                     + 0.5 * var) / float(NOM.df(5.0))
        assert abs(a - b) < 1e-12


class TestZCIS:
    def test_par_and_value(self):
        jy = make_jy()
        k = jy.zcis_par_rate(5.0)
        assert abs(jy.zcis_value(5.0, k)) < 1e-14
        assert abs((1 + k) ** 5.0 - float(REAL.df(5.0) / NOM.df(5.0))) < 1e-12
        assert make_jy(cpi_vol=0.05).zcis_par_rate(5.0) == pytest.approx(k)
        with pytest.raises(ValueError, match="maturity"):
            jy.zcis_par_rate(-1.0)


@pytest.fixture(scope="module")
def own_sim():
    """``tests/test_inflation.py``'s simulation: 200,000 antithetic paths,
    20 semiannual steps, seed 3, on the port's stream."""
    return ti.JarrowYildirimSimulation(make_jy(), _td(), num_paths=200_000,
                                       seed=3, device=CPU)


class TestYoY:
    def test_forward_matches_mc_not_naive(self, own_sim):
        jy = own_sim.model
        for t1, t2 in ((4.0, 5.0), (9.0, 10.0)):
            an = jy.yoy_forward(t1, t2)
            mc, se = own_sim.mc_yoy_forward(t1, t2)
            naive = float(REAL.df(t2) / REAL.df(t1)
                          * NOM.df(t1) / NOM.df(t2))
            assert abs(an - mc) < 4 * se + 1e-6
            assert abs(an - mc) < abs(naive - mc)

    def test_caplet_matches_mc_and_parity(self, own_sim):
        jy = own_sim.model
        for k in (0.01, 0.02, 0.04):
            an = jy.yoy_caplet(4.0, 5.0, k)
            mc, se = own_sim.mc_yoy_caplet(4.0, 5.0, k)
            assert abs(an - mc) < 4 * se + 1e-6, (k, an, mc, se)
            fl_an = jy.yoy_caplet(4.0, 5.0, k, is_caplet=False)
            fl_mc, fl_se = own_sim.mc_yoy_caplet(4.0, 5.0, k,
                                                 is_caplet=False)
            assert abs(fl_an - fl_mc) < 4 * fl_se + 1e-6
            assert abs((an - fl_an)
                       - jy.yoy_swaplet_value(4.0, 5.0, k)) < 1e-14

    def test_zcis_mc(self, own_sim):
        jy = own_sim.model
        k = jy.zcis_par_rate(5.0)
        assert abs(own_sim.mc_zcis_value(5.0, k)) < 2e-3
        cpi = own_sim.cpi(5.0)
        assert cpi.get_filtration_time() == 5.0

    def test_swap_par_rate(self):
        jy = make_jy()
        pay = np.arange(1.0, 11.0)
        k = jy.yoy_swap_par_rate(pay)
        value = sum(jy.yoy_swaplet_value(a, b, k)
                    for a, b in zip(np.concatenate([[0.0], pay[:-1]]), pay))
        assert abs(value) < 1e-14
        with pytest.raises(ValueError, match="payment_times"):
            jy.yoy_swap_par_rate([-1.0, 1.0])

    def test_correlation_sign_on_convexity(self):
        lo = make_jy(rho_ri=-0.6).yoy_forward(4.0, 5.0)
        hi = make_jy(rho_ri=0.6).yoy_forward(4.0, 5.0)
        assert lo != hi
        tiny_nom = HullWhiteModel(NOM.curve, 0.1, 1e-8)
        tiny_real = HullWhiteModel(REAL.curve, 0.2, 1e-8)
        jy0 = ti.JarrowYildirimModel(tiny_nom, tiny_real, 100.0, 0.012,
                                     0.3, 0.1, -0.3)
        naive = float(REAL.df(5.0) / REAL.df(4.0)
                      * NOM.df(4.0) / NOM.df(5.0))
        assert abs(jy0.yoy_forward(4.0, 5.0) - naive) < 1e-7

    def test_validation(self):
        jy = make_jy()
        with pytest.raises(ValueError, match="t1 < t2"):
            jy.yoy_forward(5.0, 4.0)
        with pytest.raises(ValueError, match="strike_rate"):
            jy.yoy_caplet(4.0, 5.0, -1.5)
        with pytest.raises(ValueError, match="t1 < t2"):
            jy.yoy_caplet(5.0, 4.0, 0.01)
        with pytest.raises(NotImplementedError):
            ti.JarrowYildirimSimulation(jy, _td(), num_paths=8, device=CPU,
                                        mesh=object())
        with pytest.raises(ValueError, match="normals"):
            ti.JarrowYildirimSimulation(jy, _td(), num_paths=8, device=CPU,
                                        normals=np.zeros((20, 5, 6)))
