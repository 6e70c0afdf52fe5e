"""The port's credit layer (``finmath_tpu_torch/models/credit.py``) against
finmath_tpu's.

Tolerances against the JAX package:
* the host layer (survival curves, CDS legs, spreads and values, the
  bootstrap, the CIR bond and psi, ``par_swap_rate``): 1e-12 relative;
  both are the same NumPy float64 arithmetic (measured: equal);
* ``CIRPPSimulation`` on the JAX stream (``_cir_scan``'s normals and
  ``default_indicators``' exponentials drawn in the test at their key
  paths and injected): Lambda_y within 1e-6 of each step's largest value,
  ``expected_survival`` and ``mc_cds_legs`` within 1e-6 relative, the
  default indicators equal on every path whose |Lambda + psi - E| > 1e-6
  (measured: 2.0e-7, 2.0e-10, 1.5e-9, every indicator equal);
* ``WrongWayRiskCVAEngine`` on the JAX stream (``_wwr_scan``'s normals):
  the x and Y histories within 32 float32 ulps of each step's largest
  value, Lambda_y within 1e-6 of each step's largest value, the CVA, the
  independent CVA and every contribution within 1e-6 relative (a
  contribution of the CVA), the expected survivals within 1e-6 relative
  (measured: 2.5 and 2.0 ulps, 1.8e-7, 3.6e-9, 1.8e-9, 1.3e-9, 1.0e-10).
Lambda_y is held to each step's largest value, not path by path: where a
path's CIR factor crosses zero, full truncation turns a one-ulp gap in y
into a gap of sqrt(ulp) in sqrt(y+), and that path's Lambda_y then differs
by a few 1e-6 of itself (measured 2.4e-6 on one path of 4,000) while
staying within 2e-7 of the step's largest Lambda_y.
The rest are ``tests/test_credit.py``'s cases on the port's own stream at
that file's sizes and seeds, and the reference's substep-correlation
variance, pinned."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import credit as tc  # noqa: E402
from finmath_tpu_torch.models.curves import DiscountCurve  # noqa: E402
from finmath_tpu_torch.models.hull_white import HullWhiteModel  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

CPU = "cpu"
T_GRID = np.arange(0.0, 31.0)
DFS = np.exp(-0.03 * T_GRID)
DC = DiscountCurve(T_GRID, DFS)
MKT_ARGS = ([0.0, 5.0], [0.025, 0.035])
MKT = tc.SurvivalCurve(*MKT_ARGS)
PAY = np.arange(1, 11) * 0.5            # 5y semiannual swap
QUOTES = ([1.0, 3.0, 5.0, 7.0, 10.0], [0.006, 0.009, 0.012, 0.014, 0.016])
# CIRPPSimulation parity: (steps, substeps, paths, seed) on a quarterly grid
CIR_CASE = (20, 4, 4_000, 7)
# WrongWayRiskCVAEngine parity: (rho, substeps, payer) at 4,000 paths
WWR_CASES = {"wrong_way_s4": (0.6, 4, True), "receiver_s2": (-0.9, 2, False)}
WWR_PATHS, WWR_SEED = 4_000, 99


def _mirror(z, antithetic=True):
    z = np.asarray(z)
    return np.concatenate([z, -z], axis=-1) if antithetic else z


def cir_stream(seed, steps, substeps, paths):
    """``_cir_scan``'s normals ``[steps, substeps, paths]`` and the
    exponentials of ``default_indicators``: ``(key_y, key_e) =
    split(PRNGKey(seed))``, ``split(key_y, steps)``, each step's key split
    into ``substeps``, ``normal(kk, (half,), float32)`` mirrored;
    ``exponential(key_e, (paths,), float64)``."""
    import jax
    import jax.numpy as jnp

    half = paths // 2
    key_y, key_e = jax.random.split(jax.random.PRNGKey(seed))
    z = np.stack([np.stack([
        _mirror(jax.random.normal(kk, (half,), dtype=jnp.float32))
        for kk in jax.random.split(k, substeps)])
        for k in jax.random.split(key_y, steps)])
    e = np.array(jax.random.exponential(key_e, (paths,), dtype=jnp.float64))
    return z, e


def wwr_stream(seed, steps, substeps, paths):
    """``_wwr_scan``'s normals: ``split(PRNGKey(seed), steps)``, each step's
    key split into (k1, k2, k3); z1, z2 ``normal(k_i, (half,), float32)``,
    z3 from ``split(k3, substeps)``; all mirrored."""
    import jax
    import jax.numpy as jnp

    half = paths // 2
    z1, z2, z3 = [], [], []
    for k in jax.random.split(jax.random.PRNGKey(seed), steps):
        k1, k2, k3 = jax.random.split(k, 3)
        z1.append(_mirror(jax.random.normal(k1, (half,), dtype=jnp.float32)))
        z2.append(_mirror(jax.random.normal(k2, (half,), dtype=jnp.float32)))
        z3.append(np.stack([
            _mirror(jax.random.normal(kk, (half,), dtype=jnp.float32))
            for kk in jax.random.split(k3, substeps)]))
    return np.stack(z1), np.stack(z2), np.stack(z3)


def within_ulps(a, b, n=32):
    """Rows of ``b`` within ``n`` float32 ulps of each row's largest |a|."""
    a = np.asarray(a, dtype=np.float64).reshape(-1, np.shape(a)[-1])
    b = np.asarray(b, dtype=np.float64).reshape(a.shape)
    u = np.spacing(np.max(np.abs(a), axis=1).astype(np.float32))
    return np.all(np.abs(a - b) <= n * u.astype(np.float64)[:, None])


def within_rows(a, b, rtol=1e-6):
    """Rows of ``b`` within ``rtol`` of each row's largest |a|."""
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(a), axis=1, keepdims=True)
    return np.all(np.abs(a - b) <= rtol * scale)


def _intensity(sigma=0.08, curve=MKT):
    return tc.CIRPPIntensityModel(curve, kappa=0.5, theta=0.02,
                                  sigma=sigma, y0=0.02)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX models and simulations, and the streams they drew."""
    import jax.numpy as jnp

    from finmath_tpu.models import credit as jc
    from finmath_tpu.models.curves import DiscountCurve as JDC
    from finmath_tpu.models.hull_white import HullWhiteModel as JHW
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    dc = JDC(T_GRID, DFS)
    mkt = jc.SurvivalCurve(*MKT_ARGS)
    steps, sub, paths, seed = CIR_CASE
    cir = jc.CIRPPSimulation(
        jc.CIRPPIntensityModel(mkt, 0.5, 0.02, 0.08, 0.02),
        JTD(initial=0.0, num_steps=steps, step=0.25), paths, seed=seed,
        antithetic=True, substeps=sub)
    hw = JHW(dc, mean_reversion=0.1, volatility=0.01)
    intensity = jc.CIRPPIntensityModel(mkt, 0.5, 0.02, 0.10, 0.02)
    k = jc.par_swap_rate(dc, PAY)
    wwr = {}
    for name, (rho, s, payer) in WWR_CASES.items():
        eng = jc.WrongWayRiskCVAEngine(
            hw, intensity, PAY, k, num_paths=WWR_PATHS, payer=payer,
            correlation=rho, seed=WWR_SEED, antithetic=True, substeps=s)
        im = eng.intensity
        hist = jc._wwr_scan(
            jc.jax.random.PRNGKey(eng.seed), eng.num_paths, eng.substeps,
            eng.antithetic, *eng._consts, jnp.float64(eng.rho),
            jnp.float64(im.kappa), jnp.float64(im.theta),
            jnp.float64(im.sigma), jnp.float64(im.y0))
        wwr[name] = dict(result=eng.compute(),
                         hist=[np.asarray(h) for h in hist],
                         normals=wwr_stream(WWR_SEED, PAY.size, s,
                                            WWR_PATHS))
    boot = jc.bootstrap_survival_curve(dc, *QUOTES, recovery=0.4)
    return dict(jc=jc, dc=dc, mkt=mkt, cir=cir,
                cir_stream=cir_stream(seed, steps, sub, paths), wwr=wwr,
                k=k, boot=boot)


@pytest.fixture(scope="module")
def port_cir(jax_side):
    steps, sub, paths, seed = CIR_CASE
    z, e = jax_side["cir_stream"]
    return tc.CIRPPSimulation(
        _intensity(), TimeDiscretization(initial=0.0, num_steps=steps,
                                         step=0.25),
        paths, seed=seed, antithetic=True, substeps=sub, device=CPU,
        normals=z, exponentials=e)


def _port_engine(rho, substeps, payer, paths=WWR_PATHS, seed=WWR_SEED,
                 normals=None):
    hw = HullWhiteModel(DC, mean_reversion=0.1, volatility=0.01)
    return tc.WrongWayRiskCVAEngine(
        hw, _intensity(sigma=0.10), PAY, tc.par_swap_rate(DC, PAY),
        num_paths=paths, payer=payer, recovery=0.4, correlation=rho,
        seed=seed, antithetic=True, substeps=substeps, device=CPU,
        normals=normals)


@pytest.fixture(scope="module")
def port_wwr(jax_side):
    out = {}
    for name, (rho, s, payer) in WWR_CASES.items():
        eng = _port_engine(rho, s, payer,
                           normals=jax_side["wwr"][name]["normals"])
        out[name] = dict(result=eng.compute(),
                         hist=[h.numpy() for h in eng.simulate()])
    return out


class TestHostLayer:
    def test_curves_cds_and_bootstrap_match_jax(self, jax_side):
        jc, jdc, jm = jax_side["jc"], jax_side["dc"], jax_side["mkt"]
        t = np.array([0.0, 0.3, 2.0, 5.0, 7.5, 40.0])
        for f in ("cumulative_hazard", "get_survival_probability",
                  "get_hazard_rate"):
            np.testing.assert_allclose(getattr(MKT, f)(t),
                                       getattr(jm, f)(t), rtol=1e-12)
        np.testing.assert_allclose(MKT.default_probability(1.0, 6.0),
                                   jm.default_probability(1.0, 6.0),
                                   rtol=1e-12)
        for mat, r, pi in ((5.0, 0.4, 0.25), (3.0, 0.25, 0.5)):
            np.testing.assert_allclose(
                tc.cds_legs(DC, MKT, mat, r, pi),
                jc.cds_legs(jdc, jm, mat, r, pi), rtol=1e-12)
            np.testing.assert_allclose(
                tc.cds_par_spread(DC, MKT, mat, r, pi),
                jc.cds_par_spread(jdc, jm, mat, r, pi), rtol=1e-12)
            for buyer in (True, False):
                np.testing.assert_allclose(
                    tc.cds_value(DC, MKT, mat, 0.015, r, pi, buyer),
                    jc.cds_value(jdc, jm, mat, 0.015, r, pi, buyer),
                    rtol=1e-12)
        boot = tc.bootstrap_survival_curve(DC, *QUOTES, recovery=0.4)
        np.testing.assert_allclose(boot.hazards, jax_side["boot"].hazards,
                                   rtol=1e-12)
        np.testing.assert_array_equal(boot.times, jax_side["boot"].times)
        np.testing.assert_allclose(tc.par_swap_rate(DC, PAY), jax_side["k"],
                                   rtol=1e-12)

    def test_cir_bond_and_psi_match_jax(self, jax_side):
        jc, jm = jax_side["jc"], jax_side["mkt"]
        t = np.arange(0.0, 12.25, 0.25)
        for sigma in (0.08, 0.25, 1e-4):
            a = _intensity(sigma)
            b = jc.CIRPPIntensityModel(jm, 0.5, 0.02, sigma, 0.02)
            np.testing.assert_allclose(a.cir_survival(t), b.cir_survival(t),
                                       rtol=1e-12)
            np.testing.assert_allclose(a.psi_integral(t[1:]),
                                       b.psi_integral(t[1:]), rtol=1e-12)
            np.testing.assert_allclose(a.min_psi_on_grid(t),
                                       b.min_psi_on_grid(t), rtol=1e-12)
            assert a.feller_satisfied == b.feller_satisfied

    def test_models_from_jax_price_the_same(self, jax_side):
        jc, jdc = jax_side["jc"], jax_side["dc"]
        jboot = jax_side["boot"]
        boot = convert.survival_curve_from_jax(jboot)
        assert boot.name == jboot.name
        for mat, s in zip(*QUOTES):
            np.testing.assert_allclose(
                tc.cds_value(DC, boot, mat, s),
                jc.cds_value(jdc, jboot, mat, s),
                rtol=1e-12, atol=1e-16)
            np.testing.assert_allclose(
                tc.cds_par_spread(DC, boot, mat),
                jc.cds_par_spread(jdc, jboot, mat), rtol=1e-12)
        jint = jc.CIRPPIntensityModel(jboot, 0.5, 0.015, 0.08, 0.01)
        tint = convert.cirpp_intensity_model_from_jax(jint)
        t = np.arange(0.5, 10.5, 0.5)
        np.testing.assert_allclose(tint.psi_integral(t),
                                   jint.psi_integral(t), rtol=1e-12)
        np.testing.assert_allclose(tint.cir_survival(t),
                                   jint.cir_survival(t), rtol=1e-12)


class TestCIRPPSimulationOnTheJaxStream:
    def test_lambda_and_survival(self, jax_side, port_cir):
        js = jax_side["cir"]
        lam = port_cir._lam_y
        assert lam.dtype == torch.float64 and lam.device.type == CPU
        assert within_rows(np.asarray(js._lam_y)[1:], lam.numpy()[1:])
        for t in (0.25, 1.0, 3.0, 5.0):
            np.testing.assert_allclose(port_cir.expected_survival(t),
                                       js.expected_survival(t), rtol=1e-6)
            a = np.asarray(js.survival(t).get_realizations())
            b = port_cir.survival(t).get_realizations()
            assert within_ulps(a[None], b[None])
        for mat, pi in ((5.0, 0.25), (4.0, 0.5)):
            np.testing.assert_allclose(
                port_cir.mc_cds_legs(DC, mat, 0.4, pi),
                js.mc_cds_legs(jax_side["dc"], mat, 0.4, pi), rtol=1e-6)

    def test_default_indicators(self, jax_side, port_cir):
        js = jax_side["cir"]
        _, e = jax_side["cir_stream"]
        for t in (1.0, 3.0, 5.0):
            i = js._index(t)
            clear = np.abs(np.asarray(js._lam_y[i]) + js._psi_int[i] - e) \
                > 1e-6
            a = np.asarray(js.default_indicators(t).get_realizations())
            b = port_cir.default_indicators(t).get_realizations()
            np.testing.assert_array_equal(b[clear], a[clear])


class TestWWRCVAOnTheJaxStream:
    @pytest.mark.parametrize("case", sorted(WWR_CASES))
    def test_histories(self, jax_side, port_wwr, case):
        (jx, jy, jl), (tx, ty, tl) = (jax_side["wwr"][case]["hist"],
                                      port_wwr[case]["hist"])
        assert tx.dtype == np.float32 and tl.dtype == np.float64
        assert within_ulps(jx, tx)
        assert within_ulps(jy, ty)
        assert within_rows(jl[1:], tl[1:])

    @pytest.mark.parametrize("case", sorted(WWR_CASES))
    def test_cva_decomposition(self, jax_side, port_wwr, case):
        a, b = jax_side["wwr"][case]["result"], port_wwr[case]["result"]
        np.testing.assert_allclose(b.cva, a.cva, rtol=1e-6)
        np.testing.assert_allclose(b.cva_independent, a.cva_independent,
                                   rtol=1e-6)
        np.testing.assert_allclose(b.contributions, a.contributions,
                                   rtol=0, atol=1e-6 * abs(a.cva))
        np.testing.assert_allclose(b.expected_survival, a.expected_survival,
                                   rtol=1e-6)
        np.testing.assert_array_equal(b.observation_times,
                                      a.observation_times)
        np.testing.assert_allclose(b.wwr_ratio, a.wwr_ratio, rtol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_credit.py's cases on the port's own stream
# ---------------------------------------------------------------------------

class TestSurvivalCurve:
    def test_cumulative_hazard_piecewise(self):
        c = tc.SurvivalCurve([0.0, 1.0, 3.0], [0.01, 0.02, 0.05])
        assert c.cumulative_hazard(0.0) == 0.0
        assert np.isclose(c.cumulative_hazard(0.5), 0.005)
        assert np.isclose(c.cumulative_hazard(2.0), 0.01 + 0.02)
        assert np.isclose(c.cumulative_hazard(10.0),
                          0.01 + 0.04 + 7.0 * 0.05)
        q = c.get_survival_probability([1.0, 2.0])
        assert np.allclose(q, np.exp(-np.array([0.01, 0.03])))
        assert np.isclose(c.default_probability(1.0, 2.0), q[0] - q[1])
        assert c.get_hazard_rate(2.5) == 0.02

    def test_validation(self):
        with pytest.raises(ValueError):
            tc.SurvivalCurve([0.5, 1.0], [0.01, 0.02])
        with pytest.raises(ValueError):
            tc.SurvivalCurve([0.0, 1.0], [0.01, -0.02])
        with pytest.raises(ValueError):
            tc.SurvivalCurve([0.0, 1.0], [0.01])


class TestCDS:
    def test_par_spread_and_triangle(self):
        c = tc.SurvivalCurve([0.0, 2.0], [0.015, 0.03])
        s = tc.cds_par_spread(DC, c, 5.0, recovery=0.4)
        assert abs(tc.cds_value(DC, c, 5.0, s, recovery=0.4)) < 1e-15
        assert tc.cds_value(DC, c, 5.0, s * 1.1,
                            protection_buyer=False) == pytest.approx(
            -tc.cds_value(DC, c, 5.0, s * 1.1))
        flat = tc.SurvivalCurve([0.0], [0.02])
        s = tc.cds_par_spread(DC, flat, 5.0, recovery=0.4)
        assert abs(s - 0.6 * 0.02) < 0.005 * 0.6 * 0.02

    def test_legs_monotone_and_validation(self):
        lo = tc.SurvivalCurve([0.0], [0.01])
        hi = tc.SurvivalCurve([0.0], [0.05])
        p_lo, a_lo = tc.cds_legs(DC, lo, 5.0)
        p_hi, a_hi = tc.cds_legs(DC, hi, 5.0)
        assert 0 < p_lo < p_hi
        assert a_hi < a_lo
        with pytest.raises(ValueError, match="payment intervals"):
            tc.cds_legs(DC, lo, 5.1)
        with pytest.raises(ValueError, match="recovery"):
            tc.cds_legs(DC, lo, 5.0, recovery=1.0)

    def test_bootstrap(self):
        curve = tc.bootstrap_survival_curve(DC, *QUOTES, recovery=0.4)
        assert curve.hazards.size == len(QUOTES[0])
        for m, s in zip(*QUOTES):
            assert abs(tc.cds_value(DC, curve, m, s, recovery=0.4)) < 1e-12
            assert abs(tc.cds_par_spread(DC, curve, m, recovery=0.4)
                       - s) < 1e-10
        assert np.all(curve.hazards > 0)
        assert np.all(np.diff(curve.get_survival_probability(QUOTES[0])) < 0)
        with pytest.raises(ValueError, match="negative hazard"):
            tc.bootstrap_survival_curve(DC, [1.0, 2.0], [0.05, 0.001])
        with pytest.raises(ValueError, match="align"):
            tc.bootstrap_survival_curve(DC, [1.0, 2.0], [0.05])
        with pytest.raises(ValueError, match="increasing"):
            tc.bootstrap_survival_curve(DC, [2.0, 1.0], [0.01, 0.01])


class TestCIRPP:
    def test_exact_fit_and_psi(self):
        m = _intensity()
        t = np.array([1.0, 3.0, 7.0])
        assert np.allclose(m.survival_probability(t),
                           MKT.get_survival_probability(t))
        assert m.min_psi_on_grid(np.arange(0.0, 10.25, 0.25)) > 0.0
        assert m.feller_satisfied
        assert not tc.CIRPPIntensityModel(MKT, 0.5, 0.02, 0.25,
                                          0.02).feller_satisfied

    def test_cir_bond_deterministic_limit(self):
        m = _intensity(sigma=1e-4)
        for t in [1.0, 5.0, 10.0]:
            integral = (m.theta * t + (m.y0 - m.theta)
                        * (1.0 - math.exp(-m.kappa * t)) / m.kappa)
            assert abs(m.cir_survival(t) - math.exp(-integral)) < 1e-8

    def test_validation(self):
        with pytest.raises(ValueError):
            tc.CIRPPIntensityModel(MKT, -0.5, 0.02, 0.08, 0.02)
        with pytest.raises(ValueError):
            tc.CIRPPIntensityModel(MKT, 0.5, 0.02, 0.08, -0.02)


class TestCIRPPSimulation:
    @pytest.fixture(scope="class")
    def sim(self):
        td = TimeDiscretization(initial=0.0, num_steps=20, step=0.25)
        return tc.CIRPPSimulation(_intensity(), td, num_paths=40_000, seed=7,
                                  antithetic=True, substeps=4, device=CPU)

    def test_survival_martingale(self, sim):
        for t in [1.0, 3.0, 5.0]:
            q = MKT.get_survival_probability(t)
            assert abs(sim.expected_survival(t) - q) < 2e-3

    def test_survival_pathwise_properties(self, sim):
        s3 = sim.survival(3.0).get_realizations()
        s5 = sim.survival(5.0).get_realizations()
        assert np.all(s5 <= s3 + 1e-12)
        assert np.all((s3 > 0) & (s3 <= 1.0 + 1e-12))

    def test_default_indicators(self, sim):
        i3 = sim.default_indicators(3.0).get_realizations()
        i5 = sim.default_indicators(5.0).get_realizations()
        assert set(np.unique(i3)) <= {0.0, 1.0}
        assert np.all(i5 >= i3)
        pd5 = 1.0 - MKT.get_survival_probability(5.0)
        assert abs(float(np.mean(i5)) - pd5) < 4 * 0.0017 + 2e-3

    def test_mc_cds_matches_analytic(self, sim):
        p_mc, a_mc = sim.mc_cds_legs(DC, 5.0, recovery=0.4)
        p_an, a_an = tc.cds_legs(DC, MKT, 5.0, recovery=0.4)
        assert abs(p_mc - p_an) < 2e-3 * max(p_an, 1e-9) + 2e-3
        assert abs(a_mc - a_an) < 2e-3 * a_an + 2e-3

    def test_validation(self):
        model = _intensity()
        td = TimeDiscretization(initial=0.0, num_steps=4, step=0.25)
        with pytest.raises(ValueError, match="even"):
            tc.CIRPPSimulation(model, td, num_paths=101, antithetic=True,
                               device=CPU)
        with pytest.raises(ValueError, match="substeps"):
            tc.CIRPPSimulation(model, td, num_paths=100, substeps=0,
                               device=CPU)
        with pytest.raises(ValueError, match="start at 0"):
            tc.CIRPPSimulation(model, TimeDiscretization([0.5, 1.0]),
                               num_paths=100, device=CPU)
        with pytest.raises(ValueError, match="normals"):
            tc.CIRPPSimulation(model, td, num_paths=100, device=CPU,
                               normals=np.zeros((4, 3, 100)))
        with pytest.raises(ValueError, match="exponentials"):
            tc.CIRPPSimulation(model, td, num_paths=100, device=CPU,
                               exponentials=np.ones(99))
        sim = tc.CIRPPSimulation(model, td, num_paths=100, device=CPU)
        with pytest.raises(ValueError, match="not on the simulation"):
            sim.survival(0.3)


class TestWWRCVA:
    def _engine(self, rho, payer=True, paths=60_000):
        return _port_engine(rho, 2, payer, paths=paths)

    def test_par_rate(self):
        k = tc.par_swap_rate(DC, PAY)
        deltas = np.diff(np.concatenate([[0.0], PAY]))
        df = DC.get_discount_factor(PAY)
        assert np.isclose(k * np.sum(deltas * df), 1.0 - df[-1])

    def test_independence_factorization_at_rho_zero(self):
        res = self._engine(0.0).compute()
        assert res.cva > 0.0
        assert abs(res.cva - res.cva_independent) < 0.03 * res.cva
        q = MKT.get_survival_probability(res.observation_times)
        assert np.max(np.abs(res.expected_survival - q)) < 3e-3
        assert np.all(res.contributions > -1e-12)
        assert np.isclose(np.sum(res.contributions), res.cva)
        assert abs(res.contributions[-1]) < 1e-15

    def test_wrong_way_monotone_in_rho_payer(self):
        cvas = [self._engine(rho).compute() for rho in (-0.9, 0.0, 0.9)]
        assert cvas[0].cva < cvas[1].cva < cvas[2].cva
        assert cvas[2].wwr_ratio > 1.02
        assert cvas[0].wwr_ratio < 0.98

    def test_right_way_for_receiver(self):
        up = self._engine(0.9, payer=False).compute()
        dn = self._engine(-0.9, payer=False).compute()
        assert up.cva < dn.cva
        assert up.wwr_ratio < 1.0 < dn.wwr_ratio

    def test_validation(self):
        hw = HullWhiteModel(DC, mean_reversion=0.1, volatility=0.01)
        k = tc.par_swap_rate(DC, PAY)
        intensity = _intensity(0.10)
        with pytest.raises(ValueError, match="correlation"):
            tc.WrongWayRiskCVAEngine(hw, intensity, PAY, k, correlation=1.5,
                                     device=CPU)
        with pytest.raises(ValueError, match="payment_times"):
            tc.WrongWayRiskCVAEngine(hw, intensity, [-1.0, 1.0], k,
                                     device=CPU)
        with pytest.raises(ValueError, match="even"):
            tc.WrongWayRiskCVAEngine(hw, intensity, PAY, k, num_paths=101,
                                     antithetic=True, device=CPU)
        with pytest.raises(ValueError, match="not on the grid"):
            tc.WrongWayRiskCVAEngine(
                hw, intensity, PAY, k, device=CPU,
                time_discretization=TimeDiscretization(
                    initial=0.0, num_steps=5, step=1.0))
        pw = HullWhiteModel(DC, 0.1, [0.01, 0.012], vol_times=[0.0, 1.25])
        with pytest.raises(ValueError, match="breakpoint"):
            tc.WrongWayRiskCVAEngine(pw, intensity, PAY, k, device=CPU)
        with pytest.raises(ValueError, match="z3"):
            tc.WrongWayRiskCVAEngine(
                hw, intensity, PAY, k, num_paths=8, substeps=2, device=CPU,
                normals=(np.zeros((10, 8)), np.zeros((10, 8)),
                         np.zeros((10, 3, 8))))
        with pytest.raises(NotImplementedError):
            tc.WrongWayRiskCVAEngine(hw, intensity, PAY, k, device=CPU,
                                     mesh=object())

    def test_own_stream_is_seeded_and_mirrored(self):
        a = _port_engine(0.6, 2, True, paths=64, seed=5)
        b = _port_engine(0.6, 2, True, paths=64, seed=5)
        xa, ya, la = a.simulate()
        xb, yb, lb = b.simulate()
        assert torch.equal(xa, xb) and torch.equal(ya, yb) \
            and torch.equal(la, lb)
        np.testing.assert_array_equal(xa[:, :32].numpy(), -xa[:, 32:].numpy())
        assert a.compute().cva == b.compute().cva


def test_default_device_raises_without_a_card(monkeypatch):
    """Without ``device=`` the entry points compute on ``select_device()``,
    which raises when no CUDA device is visible; there is no quiet CPU
    fallback."""
    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    td = TimeDiscretization(initial=0.0, num_steps=4, step=0.25)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.CIRPPSimulation(_intensity(), td, num_paths=8)
    hw = HullWhiteModel(DC, mean_reversion=0.1, volatility=0.01)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.WrongWayRiskCVAEngine(hw, _intensity(), PAY, 0.03, num_paths=8)


def test_substep_correlation_inflates_the_credit_variance():
    """The reference's substep split, pinned on the port's stream.

    ``finmath_tpu/models/credit.py:451-452, 479`` give each of the s credit
    substeps of a step ``z_c_k = rho / sqrt(s) z1 + sqrt(1 - rho^2 / s)
    z3_k`` with the step's one rate normal z1. Each z_c_k is standard
    normal, but they share z1, so the step's credit increment sum_k z_c_k
    / sqrt(s) has variance 1 + rho^2 (1 - 1/s) (1.27 at rho = 0.6, s = 4),
    not 1, and the simulated survival drifts off the fitted curve. The port
    reproduces this to stay in parity with the reference; correcting it is
    a change to both packages, not made here. The sample variance over 20
    steps x 100,000 independent paths must lie within 4 standard errors of
    1.27 (the standard error of a normal sample's variance is
    sigma^2 sqrt(2 / (n - 1)))."""
    rho, s = 0.6, 4
    hw = HullWhiteModel(DC, mean_reversion=0.1, volatility=0.01)
    eng = tc.WrongWayRiskCVAEngine(
        hw, _intensity(0.10), PAY, tc.par_swap_rate(DC, PAY),
        num_paths=100_000, correlation=rho, seed=2024, antithetic=False,
        substeps=s, device=CPU)
    z1, _, z3 = eng._draw()
    rs, io = eng.credit_shares()
    step_sum = sum(rs * z1 + io * z3[:, k] for k in range(s)) / math.sqrt(s)
    x = step_sum.to(torch.float64).flatten()
    n = x.numel()
    var = float(torch.var(x))
    expected = 1.0 + rho * rho * (1.0 - 1.0 / s)
    assert expected == pytest.approx(1.27)
    assert abs(var - expected) < 4 * expected * math.sqrt(2.0 / (n - 1))
    assert abs(var - 1.0) > 40 * math.sqrt(2.0 / (n - 1))
