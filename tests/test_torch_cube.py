"""The port's swaption cube and CMS replication
(``finmath_tpu_torch/models/cube.py``) against finmath_tpu's, and the JAX
package's own cases (``tests/test_cube.py``) on the port.

Tolerances: smile calls and puts, cube vols, the annuity mapping, the
replication values (caplet, floorlet, swaplet, CMS rate, second moment),
the flat-lognormal adjustment and the copula spread-option values are
host NumPy float64 with the same arithmetic in both packages, held within
1e-12 relative (measured: equal bit for bit). The Monte-Carlo
cross-check runs the port's SABR simulator on its own stream at the JAX
test's bounds."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models.cube import (  # noqa: E402
    CMSReplicationPricer,
    CMSSpreadOptionPricer,
    LinearTSRAnnuityMapping,
    SwaptionCube,
    SwaptionSmile,
    flat_lognormal_convexity_adjustment,
)
from finmath_tpu_torch.models.curves import (  # noqa: E402
    DiscountCurve, swap_annuity)
from finmath_tpu_torch.models.sabr import (  # noqa: E402
    SABRParams, _sabr_terminal, sabr_lognormal_implied_volatility)

TS = np.arange(0.5, 30.1, 0.5)
CURVE = DiscountCurve(list(TS), list(np.exp(-0.025 * TS)))
EXPIRY, TENOR, DELTA = 5.0, 10.0, 0.5
PAY_TIMES = [EXPIRY + (i + 1) * DELTA for i in range(int(TENOR / DELTA))]
A0 = swap_annuity(CURVE, PAY_TIMES, [DELTA] * len(PAY_TIMES))
S0 = float((CURVE.get_discount_factor(EXPIRY)
            - CURVE.get_discount_factor(PAY_TIMES[-1])) / A0)
MAPPING = LinearTSRAnnuityMapping.from_curve(
    CURVE, S0, PAY_TIMES, payment_time=EXPIRY + DELTA, period_length=DELTA)
SKEW = SABRParams(alpha=0.25 * S0 ** 0.3, beta=0.7, rho=-0.25, nu=0.25)
RTOL = 1e-12


def flat_smile(vol):
    return SwaptionSmile(forward=S0, expiry=EXPIRY,
                         params=SABRParams(alpha=vol, beta=1.0, rho=0.0,
                                           nu=0.0))


def _legs(vol2=0.25, tenor2=2.0):
    """Leg 1: the module's 10Y underlying at a flat 22%; leg 2: a 2Y
    underlying."""
    pay2 = [EXPIRY + (i + 1) * DELTA for i in range(int(tenor2 / DELTA))]
    a02 = swap_annuity(CURVE, pay2, [DELTA] * len(pay2))
    s02 = float((CURVE.get_discount_factor(EXPIRY)
                 - CURVE.get_discount_factor(pay2[-1])) / a02)
    map2 = LinearTSRAnnuityMapping.from_curve(
        CURVE, s02, pay2, payment_time=EXPIRY + DELTA, period_length=DELTA)
    smile2 = SwaptionSmile(forward=s02, expiry=EXPIRY,
                           params=SABRParams(alpha=vol2, beta=1.0, rho=0.0,
                                             nu=0.0))
    return (CMSReplicationPricer(flat_smile(0.22), MAPPING, A0),
            CMSReplicationPricer(smile2, map2, a02))


def _spread_pricer(rho, **kw):
    leg1, leg2 = _legs(**kw)
    return CMSSpreadOptionPricer(
        leg1, leg2, rho, float(CURVE.get_discount_factor(EXPIRY + DELTA)))


@pytest.fixture(scope="module")
def jcube():
    """The JAX modules and the same curve, mapping and smile there."""
    from finmath_tpu.models import cube, sabr
    from finmath_tpu.models.curves import DiscountCurve as JDC

    curve = JDC(list(TS), list(np.exp(-0.025 * TS)))
    mapping = cube.LinearTSRAnnuityMapping.from_curve(
        curve, S0, PAY_TIMES, payment_time=EXPIRY + DELTA,
        period_length=DELTA)
    smile = cube.SwaptionSmile(forward=S0, expiry=EXPIRY,
                               params=sabr.SABRParams(
                                   SKEW.alpha, SKEW.beta, SKEW.rho, SKEW.nu))
    return cube, sabr, curve, mapping, smile


# ---------------------------------------------------------------------------
# parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------

def test_mapping_and_smile_match_jax(jcube):
    cube, _, _, jmap, jsmile = jcube
    assert (MAPPING.a, MAPPING.b) == pytest.approx((jmap.a, jmap.b),
                                                   rel=RTOL)
    smile = SwaptionSmile(forward=S0, expiry=EXPIRY, params=SKEW)
    ks = S0 * np.linspace(0.3, 2.5, 23)
    np.testing.assert_allclose(smile.call(ks), jsmile.call(ks), rtol=RTOL)
    np.testing.assert_allclose(smile.put(ks), jsmile.put(ks), rtol=RTOL)
    assert flat_lognormal_convexity_adjustment(S0, 0.25, EXPIRY, MAPPING) \
        == pytest.approx(cube.flat_lognormal_convexity_adjustment(
            S0, 0.25, EXPIRY, jmap), rel=RTOL)


def test_replication_matches_jax(jcube):
    cube, _, _, jmap, jsmile = jcube
    got = CMSReplicationPricer(
        SwaptionSmile(forward=S0, expiry=EXPIRY, params=SKEW), MAPPING, A0)
    ref = cube.CMSReplicationPricer(jsmile, jmap, A0)
    for name in ("second_moment", "cms_rate", "convexity_adjustment"):
        assert getattr(got, name)() == pytest.approx(getattr(ref, name)(),
                                                     rel=RTOL)
    for k in (0.8 * S0, S0, 1.3 * S0):
        for name in ("caplet_value", "floorlet_value", "swaplet_value"):
            assert getattr(got, name)(k) == pytest.approx(
                getattr(ref, name)(k), rel=RTOL)


def test_cube_matches_jax(jcube):
    cube, sabr = jcube[:2]
    got, ref = SwaptionCube(), cube.SwaptionCube()
    for e in (2.0, 5.0):
        for t in (5.0, 10.0):
            kw = dict(alpha=0.2 * (1 + 0.1 * e / 5) * S0 ** 0.3, beta=0.7,
                      rho=-0.2, nu=0.3)
            f = S0 * (1 + 0.05 * t / 10)
            got.add_smile(e, t, SwaptionSmile(forward=f, expiry=e,
                                              params=SABRParams(**kw)))
            ref.add_smile(e, t, cube.SwaptionSmile(
                forward=f, expiry=e, params=sabr.SABRParams(**kw)))
    for e, t, k in ((3.5, 7.5, S0), (1.0, 5.0, 0.8 * S0),
                    (5.0, 10.0, 1.2 * S0), (4.0, 12.0, S0)):
        assert got.get_volatility(e, t, k) == pytest.approx(
            ref.get_volatility(e, t, k), rel=RTOL)
    p = SABRParams(alpha=0.08, beta=0.5, rho=-0.3, nu=0.4)
    ks = S0 * np.array([0.6, 0.8, 1.0, 1.25, 1.6])
    vols = [sabr_lognormal_implied_volatility(p, S0, k, EXPIRY) for k in ks]
    a = got.calibrate_cell(EXPIRY, TENOR, S0, ks, vols).params
    b = ref.calibrate_cell(EXPIRY, TENOR, S0, ks, vols).params
    np.testing.assert_allclose([a.alpha, a.rho, a.nu],
                               [b.alpha, b.rho, b.nu], rtol=RTOL)


def test_spread_option_matches_jax(jcube):
    cube, sabr, curve, jmap = jcube[:4]
    from finmath_tpu.models.curves import swap_annuity as jswap_annuity

    pay2 = [EXPIRY + (i + 1) * DELTA for i in range(4)]
    a02 = jswap_annuity(curve, pay2, [DELTA] * len(pay2))
    s02 = float((curve.get_discount_factor(EXPIRY)
                 - curve.get_discount_factor(pay2[-1])) / a02)
    jmap2 = cube.LinearTSRAnnuityMapping.from_curve(
        curve, s02, pay2, payment_time=EXPIRY + DELTA, period_length=DELTA)

    def jsmile(f, vol):
        return cube.SwaptionSmile(forward=f, expiry=EXPIRY,
                                  params=sabr.SABRParams(vol, 1.0, 0.0, 0.0))

    ref = cube.CMSSpreadOptionPricer(
        cube.CMSReplicationPricer(jsmile(S0, 0.22), jmap, A0),
        cube.CMSReplicationPricer(jsmile(s02, 0.25), jmap2, a02), 0.3,
        float(curve.get_discount_factor(EXPIRY + DELTA)))
    got = _spread_pricer(0.3)
    np.testing.assert_allclose(got.forwards(), ref.forwards(), rtol=RTOL)
    for k in (-0.002, 0.0, 0.002):
        for is_cap in (True, False):
            assert got.spread_option_value(k, is_cap) == pytest.approx(
                ref.spread_option_value(k, is_cap), rel=RTOL)
            assert got.normal_approximation_value(k, is_cap) == \
                pytest.approx(ref.normal_approximation_value(k, is_cap),
                              rel=RTOL)


# ---------------------------------------------------------------------------
# the JAX package's own cases (tests/test_cube.py) on the port
# ---------------------------------------------------------------------------

class TestAnnuityMapping:
    def test_martingale_consistency(self):
        p0p = float(CURVE.get_discount_factor(EXPIRY + DELTA))
        assert abs(MAPPING(S0) - p0p / A0) < 1e-14

    def test_normalization(self):
        assert abs(MAPPING.b - 1.0 / (DELTA * len(PAY_TIMES))) < 1e-14

    def test_earlier_payment_larger_alpha(self):
        m_late = LinearTSRAnnuityMapping.from_curve(
            CURVE, S0, PAY_TIMES, payment_time=PAY_TIMES[-1],
            period_length=DELTA)
        assert MAPPING(S0) > m_late(S0)


class TestReplicationQuadrature:
    @pytest.mark.parametrize("vol", [0.1, 0.25, 0.4])
    def test_flat_lognormal_exact(self, vol):
        pr = CMSReplicationPricer(flat_smile(vol), MAPPING, A0)
        exact = flat_lognormal_convexity_adjustment(S0, vol, EXPIRY, MAPPING)
        assert abs(pr.convexity_adjustment() - exact) < 1e-8

    def test_second_moment_flat_lognormal(self):
        pr = CMSReplicationPricer(flat_smile(0.25), MAPPING, A0)
        assert abs(pr.second_moment()
                   - S0 * S0 * math.exp(0.25 * 0.25 * EXPIRY)) < 1e-10

    def test_zero_vol_no_adjustment(self):
        pr = CMSReplicationPricer(flat_smile(1e-8), MAPPING, A0)
        assert abs(pr.convexity_adjustment()) < 1e-10

    def test_caplet_floorlet_swaplet_parity(self):
        pr = CMSReplicationPricer(
            SwaptionSmile(forward=S0, expiry=EXPIRY, params=SKEW),
            MAPPING, A0)
        for k in (0.8 * S0, S0, 1.3 * S0):
            assert abs(pr.caplet_value(k) - pr.floorlet_value(k)
                       - pr.swaplet_value(k)) < 1e-11

    def test_positive_adjustment_for_early_payment(self):
        pr = CMSReplicationPricer(flat_smile(0.25), MAPPING, A0)
        assert pr.convexity_adjustment() > 0.0

    def test_mc_cross_check_on_sabr_dynamics(self):
        """Replicate off the Hagan smile, simulate the true dynamics on
        the port's simulator (400,000 paths x 64 steps, own stream)."""
        pr = CMSReplicationPricer(
            SwaptionSmile(forward=S0, expiry=EXPIRY, params=SKEW),
            MAPPING, A0)
        x = _sabr_terminal(3, 400_000, 64, S0, SKEW.alpha, SKEW.beta,
                           SKEW.rho, SKEW.nu, EXPIRY / 64, True,
                           device="cpu").numpy().astype(np.float64)
        w = MAPPING(x)
        mc_cap = A0 * np.mean(np.maximum(x - S0, 0.0) * w)
        assert abs(mc_cap - pr.caplet_value(S0)) < 0.03 * mc_cap
        mc_rate = np.mean(x * w) / np.mean(w)
        assert abs(mc_rate - pr.cms_rate()) < 0.1 * abs(
            pr.convexity_adjustment())


class TestSwaptionCube:
    def build(self):
        cube = SwaptionCube()
        for e in (2.0, 5.0):
            for t in (5.0, 10.0):
                p = SABRParams(alpha=0.2 * (1 + 0.1 * e / 5) * S0 ** 0.3,
                               beta=0.7, rho=-0.2, nu=0.3)
                cube.add_smile(e, t, SwaptionSmile(
                    forward=S0 * (1 + 0.05 * t / 10), expiry=e, params=p))
        return cube

    def test_exact_on_cells(self):
        cube = self.build()
        sm = cube.get_smile(5.0, 10.0)
        assert abs(cube.get_volatility(5.0, 10.0, S0)
                   - sm.volatility(S0)) < 1e-14

    def test_interpolation_bounded_by_neighbors(self):
        cube = self.build()
        vols = [cube.get_volatility(e, t, S0)
                for e in (2.0, 5.0) for t in (5.0, 10.0)]
        v = cube.get_volatility(3.5, 7.5, S0)
        assert min(vols) - 1e-12 <= v <= max(vols) + 1e-12

    def test_extrapolation_clamps_to_edge(self):
        cube = self.build()
        assert abs(cube.get_volatility(1.0, 5.0, S0)
                   - cube.get_volatility(2.0, 5.0, S0)) < 1e-14

    def test_calibrate_cell_round_trip(self):
        cube = SwaptionCube()
        p = SABRParams(alpha=0.08, beta=0.5, rho=-0.3, nu=0.4)
        ks = S0 * np.array([0.6, 0.8, 1.0, 1.25, 1.6])
        vols = [sabr_lognormal_implied_volatility(p, S0, k, EXPIRY)
                for k in ks]
        smile = cube.calibrate_cell(EXPIRY, TENOR, S0, ks, vols, beta=0.5)
        assert abs(smile.params.alpha - 0.08) < 1e-5
        assert abs(smile.params.nu - 0.4) < 1e-3

    def test_missing_cell_raises(self):
        cube = self.build()
        with pytest.raises(KeyError):
            cube.get_smile(7.0, 10.0)
        with pytest.raises(ValueError):
            SwaptionCube().get_volatility(5.0, 10.0, S0)

    def test_put_call_parity_on_smile(self):
        sm = self.build().get_smile(5.0, 10.0)
        k = 1.2 * S0
        assert abs(sm.put(k) - (sm.call(k) - (sm.forward - k))) < 1e-15


class TestCMSSpreadOption:
    def test_marginals_reproduce_cms_rates(self):
        p = _spread_pricer(0.5)
        e1, e2 = p.forwards()
        assert abs(e1 - p.legs[0].cms_rate()) < 2e-5
        assert abs(e2 - p.legs[1].cms_rate()) < 2e-5

    def test_cap_floor_parity(self):
        p = _spread_pricer(0.3)
        k = 0.002
        cap = p.spread_option_value(k, is_cap=True)
        floor = p.spread_option_value(k, is_cap=False)
        e1, e2 = p.forwards()
        assert abs((cap - floor) - p.df * (e1 - e2 - k)) < 5e-5

    def test_copula_matches_normal_approximation_mild_smile(self):
        p = _spread_pricer(0.6)
        e1, e2 = p.forwards()
        k = e1 - e2
        v_cop = p.spread_option_value(k)
        v_nrm = p.normal_approximation_value(k)
        assert abs(v_cop - v_nrm) < 0.05 * v_nrm

    def test_decreasing_in_correlation(self):
        vals = [_spread_pricer(r).spread_option_value(0.0)
                for r in (-0.5, 0.0, 0.5, 0.9)]
        assert all(a > b for a, b in zip(vals, vals[1:]))

    def test_perfect_correlation_same_leg_degenerates(self):
        leg1, _ = _legs()
        df = float(CURVE.get_discount_factor(EXPIRY + DELTA))
        p = CMSSpreadOptionPricer(leg1, leg1, 0.9999, df)
        atm_scale = p.legs[0].caplet_value(p.legs[0].smile.forward)
        assert p.spread_option_value(0.0) < 0.02 * atm_scale

    def test_zero_vol_leg_degenerates_to_cms_caplet(self):
        p = _spread_pricer(0.0, vol2=1e-4)
        _, e2 = p.forwards()
        k = 0.003
        v = p.spread_option_value(k)
        xg, wg = np.polynomial.legendre.leggauss(400)
        x1 = p._inverse_cdf(0, 0.5 * (1.0 + xg))
        oned = p.df * float(np.sum(0.5 * wg * np.maximum(x1 - e2 - k, 0.0)))
        assert abs(v - oned) < 0.03 * oned + 1e-6

    def test_validation(self):
        leg1, leg2 = _legs()
        with pytest.raises(ValueError):
            CMSSpreadOptionPricer(leg1, leg2, 1.0, 0.8)
