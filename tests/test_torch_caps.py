"""The port's caplet stripping (``finmath_tpu_torch/models/caps.py``)
against finmath_tpu's, and the JAX package's own cases
(``tests/test_caps.py``) on the port.

Tolerances: the cap values, implied flat vols, stripped curves (price,
flat-vol and normal quotes, a whole surface) and the volatility model's
table are host NumPy float64 with the same arithmetic in both packages,
held within 1e-12 relative (measured: equal bit for bit). The end-to-end
case prices the 3Y cap on the port's lognormal LMM driven by the stripped
curve at 120,000 paths within the JAX test's 3% of the stripped quote."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models.caps import (  # noqa: E402
    CapletVolatilityCurve,
    LIBORVolatilityModelFromCapletCurve,
    cap_value,
    implied_flat_cap_volatility,
    make_cap_schedule,
    strip_caplet_surface,
    strip_caplet_volatilities,
)
from finmath_tpu_torch.models.curves import (  # noqa: E402
    DiscountCurve, ForwardCurve)

PERIOD = 0.5
PILLARS = [0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 12.0]
ZEROS = [0.015, 0.017, 0.020, 0.022, 0.025, 0.027, 0.029, 0.030]
DC = DiscountCurve(PILLARS, list(np.exp(-np.array(ZEROS) * np.array(PILLARS))))
FC = ForwardCurve(DC, payment_offset=PERIOD)
MATURITIES = np.array([1.0, 2.0, 3.0, 5.0, 7.0, 10.0])
SEG_VOLS = np.array([0.45, 0.38, 0.31, 0.26, 0.23, 0.21])
STRIKE = 0.03
RTOL = 1e-12


def _prices_from_segments(curve, strike, convention="lognormal"):
    out = []
    for m in MATURITIES:
        fx = make_cap_schedule(float(m), PERIOD)
        vols = curve.get_caplet_volatility(fx)
        out.append(cap_value(DC, FC, fx, PERIOD, strike, vols, convention))
    return np.asarray(out)


@pytest.fixture(scope="module")
def jax_caps():
    """The JAX module with its curves built from the same pillars."""
    from finmath_tpu.models import caps
    from finmath_tpu.models.curves import DiscountCurve as JDC
    from finmath_tpu.models.curves import ForwardCurve as JFC

    dc = JDC(PILLARS, list(np.exp(-np.array(ZEROS) * np.array(PILLARS))))
    return caps, dc, JFC(dc, payment_offset=PERIOD)


# ---------------------------------------------------------------------------
# parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("convention,vols", [
    ("lognormal", 0.3), ("lognormal", SEG_VOLS[:4]), ("normal", 0.008)])
@pytest.mark.parametrize("is_cap", [True, False])
def test_cap_value_matches_jax(jax_caps, convention, vols, is_cap):
    caps, dc, fc = jax_caps
    fx = make_cap_schedule(2.5, PERIOD)
    kw = dict(convention=convention, is_cap=is_cap)
    vols = np.broadcast_to(vols, fx.shape) if np.ndim(vols) else vols
    assert cap_value(DC, FC, fx, PERIOD, STRIKE, vols, **kw) == \
        pytest.approx(caps.cap_value(dc, fc, fx, PERIOD, STRIKE, vols, **kw),
                      rel=RTOL)


def test_implied_flat_vol_matches_jax(jax_caps):
    caps, dc, fc = jax_caps
    fx = make_cap_schedule(5.0, PERIOD)
    price = cap_value(DC, FC, fx, PERIOD, STRIKE, 0.2873)
    assert implied_flat_cap_volatility(price, DC, FC, fx, PERIOD, STRIKE) \
        == pytest.approx(caps.implied_flat_cap_volatility(
            price, dc, fc, fx, PERIOD, STRIKE), rel=RTOL)


@pytest.mark.parametrize("quote_type", ["price", "flat_volatility"])
def test_strip_matches_jax(jax_caps, quote_type):
    caps, dc, fc = jax_caps
    truth = CapletVolatilityCurve(MATURITIES, SEG_VOLS)
    prices = _prices_from_segments(truth, STRIKE)
    quotes = prices if quote_type == "price" else [
        implied_flat_cap_volatility(p, DC, FC,
                                    make_cap_schedule(float(m), PERIOD),
                                    PERIOD, STRIKE)
        for m, p in zip(MATURITIES, prices)]
    got = strip_caplet_volatilities(DC, FC, MATURITIES, quotes, STRIKE,
                                    PERIOD, quote_type=quote_type)
    ref = caps.strip_caplet_volatilities(dc, fc, MATURITIES, quotes, STRIKE,
                                         PERIOD, quote_type=quote_type)
    np.testing.assert_allclose(got.volatilities, ref.volatilities, rtol=RTOL)
    np.testing.assert_array_equal(got.segment_ends, ref.segment_ends)
    t = np.linspace(0.0, 12.0, 49)
    np.testing.assert_allclose(got.get_caplet_volatility(t),
                               ref.get_caplet_volatility(t), rtol=RTOL)


def test_normal_strip_and_surface_match_jax(jax_caps):
    caps, dc, fc = jax_caps
    seg = np.array([0.0085, 0.0080, 0.0072, 0.0066, 0.0061, 0.0058])
    prices = _prices_from_segments(
        CapletVolatilityCurve(MATURITIES, seg, convention="normal"), STRIKE,
        "normal")
    got = strip_caplet_volatilities(DC, FC, MATURITIES, prices, STRIKE,
                                    PERIOD, convention="normal",
                                    quote_type="price")
    ref = caps.strip_caplet_volatilities(dc, fc, MATURITIES, prices, STRIKE,
                                         PERIOD, convention="normal",
                                         quote_type="price")
    np.testing.assert_allclose(got.volatilities, ref.volatilities, rtol=RTOL)
    strikes = [0.02, 0.03, 0.045]
    quotes = np.column_stack([
        _prices_from_segments(CapletVolatilityCurve(MATURITIES, SEG_VOLS * s),
                              K)
        for s, K in zip((1.12, 1.0, 1.18), strikes)])
    got = strip_caplet_surface(DC, FC, MATURITIES, strikes, quotes, PERIOD,
                               quote_type="price")
    ref = caps.strip_caplet_surface(dc, fc, MATURITIES, strikes, quotes,
                                    PERIOD, quote_type="price")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.volatilities, r.volatilities, rtol=RTOL)


def test_volatility_model_table_matches_jax(jax_caps):
    from finmath_tpu.models.time_discretization import TimeDiscretization

    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization as TTD)

    caps = jax_caps[0]
    curve = CapletVolatilityCurve(MATURITIES, SEG_VOLS)
    grid = dict(initial=0.0, num_steps=20, step=0.5)
    ref = caps.LIBORVolatilityModelFromCapletCurve(
        TimeDiscretization(**grid), TimeDiscretization(**grid),
        caps.CapletVolatilityCurve(MATURITIES, SEG_VOLS))
    got = LIBORVolatilityModelFromCapletCurve(TTD(**grid), TTD(**grid),
                                              curve)
    table = got.vol_table(torch.zeros(0, dtype=torch.float64))
    assert table.dtype == torch.float64 and table.shape == (20, 20)
    assert got.n_params == ref.n_params == 0
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(ref.vol_table(None)))


# ---------------------------------------------------------------------------
# the JAX package's own cases (tests/test_caps.py) on the port
# ---------------------------------------------------------------------------

class TestSchedule:
    def test_standard_schedule(self):
        assert np.allclose(make_cap_schedule(2.0, 0.5), [0.5, 1.0, 1.5])

    def test_unreachable_maturity_rejected(self):
        with pytest.raises(ValueError):
            make_cap_schedule(2.3, 0.5)


class TestCapValue:
    def test_cap_floor_parity(self):
        fx = make_cap_schedule(5.0, PERIOD)
        cap = cap_value(DC, FC, fx, PERIOD, STRIKE, 0.3)
        floor = cap_value(DC, FC, fx, PERIOD, STRIKE, 0.3, is_cap=False)
        fwds = np.asarray(FC.get_forward(fx))
        dfs = DC.get_discount_factor(fx + PERIOD)
        swap = float(np.sum(PERIOD * (fwds - STRIKE) * dfs))
        assert cap - floor == pytest.approx(swap, abs=1e-12)

    def test_vol_monotone_in_both_conventions(self):
        fx = make_cap_schedule(3.0, PERIOD)
        lo = cap_value(DC, FC, fx, PERIOD, STRIKE, 0.2)
        hi = cap_value(DC, FC, fx, PERIOD, STRIKE, 0.4)
        assert 0.0 < lo < hi
        lo_n = cap_value(DC, FC, fx, PERIOD, STRIKE, 0.004, "normal")
        hi_n = cap_value(DC, FC, fx, PERIOD, STRIKE, 0.009, "normal")
        assert 0.0 < lo_n < hi_n

    def test_implied_flat_vol_round_trip(self):
        fx = make_cap_schedule(5.0, PERIOD)
        price = cap_value(DC, FC, fx, PERIOD, STRIKE, 0.2873)
        iv = implied_flat_cap_volatility(price, DC, FC, fx, PERIOD, STRIKE)
        assert iv == pytest.approx(0.2873, abs=1e-9)

    def test_below_intrinsic_rejected(self):
        fx = make_cap_schedule(5.0, PERIOD)
        with pytest.raises(ValueError):
            implied_flat_cap_volatility(1e-9, DC, FC, fx, PERIOD, 0.001)


class TestStripping:
    def test_exact_round_trip_from_price_quotes(self):
        prices = _prices_from_segments(
            CapletVolatilityCurve(MATURITIES, SEG_VOLS), STRIKE)
        stripped = strip_caplet_volatilities(
            DC, FC, MATURITIES, prices, STRIKE, PERIOD, quote_type="price")
        assert np.allclose(stripped.volatilities, SEG_VOLS, atol=1e-9)

    def test_exact_round_trip_from_flat_vol_quotes(self):
        prices = _prices_from_segments(
            CapletVolatilityCurve(MATURITIES, SEG_VOLS), STRIKE)
        flats = [
            implied_flat_cap_volatility(
                p, DC, FC, make_cap_schedule(float(m), PERIOD), PERIOD,
                STRIKE)
            for m, p in zip(MATURITIES, prices)]
        stripped = strip_caplet_volatilities(
            DC, FC, MATURITIES, flats, STRIKE, PERIOD)
        assert np.allclose(stripped.volatilities, SEG_VOLS, atol=1e-8)

    def test_flat_quotes_strip_flat(self):
        stripped = strip_caplet_volatilities(
            DC, FC, MATURITIES, np.full(len(MATURITIES), 0.27), STRIKE,
            PERIOD)
        assert np.allclose(stripped.volatilities, 0.27, atol=1e-9)

    def test_stripped_curve_reprices_every_cap(self):
        flats = np.array([0.44, 0.41, 0.37, 0.31, 0.27, 0.24])
        stripped = strip_caplet_volatilities(
            DC, FC, MATURITIES, flats, STRIKE, PERIOD)
        for m, fv in zip(MATURITIES, flats):
            fx = make_cap_schedule(float(m), PERIOD)
            target = cap_value(DC, FC, fx, PERIOD, STRIKE, float(fv))
            got = cap_value(DC, FC, fx, PERIOD, STRIKE,
                            stripped.get_caplet_volatility(fx))
            assert got == pytest.approx(target, rel=1e-9)

    def test_normal_convention_round_trip(self):
        seg = np.array([0.0085, 0.0080, 0.0072, 0.0066, 0.0061, 0.0058])
        prices = _prices_from_segments(
            CapletVolatilityCurve(MATURITIES, seg, convention="normal"),
            STRIKE, "normal")
        stripped = strip_caplet_volatilities(
            DC, FC, MATURITIES, prices, STRIKE, PERIOD, convention="normal",
            quote_type="price")
        assert np.allclose(stripped.volatilities, seg, atol=1e-10)

    def test_arbitrage_violation_raises(self):
        prices = _prices_from_segments(
            CapletVolatilityCurve(MATURITIES, SEG_VOLS), STRIKE)
        prices[3] = prices[2] * 0.5  # longer cap cheaper than its front
        with pytest.raises(ValueError, match="arbitrage"):
            strip_caplet_volatilities(DC, FC, MATURITIES, prices, STRIKE,
                                      PERIOD, quote_type="price")

    def test_non_increasing_maturities_rejected(self):
        with pytest.raises(ValueError):
            strip_caplet_volatilities(DC, FC, [1.0, 1.0], [0.3, 0.3],
                                      STRIKE, PERIOD)


class TestSurface:
    def test_column_round_trip(self):
        strikes = [0.02, 0.03, 0.045]
        truths = [CapletVolatilityCurve(MATURITIES, SEG_VOLS * s)
                  for s in (1.12, 1.0, 1.18)]
        quotes = np.column_stack([_prices_from_segments(tr, K)
                                  for tr, K in zip(truths, strikes)])
        curves = strip_caplet_surface(DC, FC, MATURITIES, strikes, quotes,
                                      PERIOD, quote_type="price")
        for curve, truth in zip(curves, truths):
            assert np.allclose(curve.volatilities, truth.volatilities,
                               atol=1e-9)

    def test_shape_mismatch_rejected(self):
        with pytest.raises(ValueError):
            strip_caplet_surface(DC, FC, MATURITIES, [0.02],
                                 np.zeros((2, 1)), PERIOD)


class TestPiecewiseLookup:
    def test_segment_boundaries_belong_right(self):
        c = CapletVolatilityCurve([1.0, 2.0], [0.3, 0.2])
        assert c.get_caplet_volatility(0.5) == 0.3
        assert c.get_caplet_volatility(1.0) == 0.2  # at the boundary
        assert c.get_caplet_volatility(1.5) == 0.2
        assert c.get_caplet_volatility(99.0) == 0.2  # constant extrapolation

    def test_validation(self):
        with pytest.raises(ValueError):
            CapletVolatilityCurve([2.0, 1.0], [0.3, 0.2])


class TestLMMEndToEnd:
    def test_mc_cap_reprices_stripped_quotes(self):
        """A lognormal LMM with sigma_i(t) = the stripped caplet vol
        reprices the input caps by Monte Carlo on the port's engine."""
        from finmath_tpu_torch.models.lmm.covariance import (
            LIBORCorrelationModelExponentialDecay,
            LIBORCovarianceModelFromVolatilityAndCorrelation)
        from finmath_tpu_torch.models.lmm.model import LIBORMarketModelTorch
        from finmath_tpu_torch.models.lmm.products import CapFloor
        from finmath_tpu_torch.models.time_discretization import (
            TimeDiscretization)

        mats = np.array([1.0, 2.0, 3.0])
        truth = CapletVolatilityCurve(mats, np.array([0.35, 0.29, 0.24]))
        prices = [cap_value(DC, FC, make_cap_schedule(float(m), PERIOD),
                            PERIOD, STRIKE, truth.get_caplet_volatility(
                                make_cap_schedule(float(m), PERIOD)))
                  for m in mats]
        stripped = strip_caplet_volatilities(
            DC, FC, mats, np.asarray(prices), STRIKE, PERIOD,
            quote_type="price")
        libor_td = TimeDiscretization(initial=0.0, num_steps=7, step=PERIOD)
        vol_model = LIBORVolatilityModelFromCapletCurve(
            libor_td, libor_td, stripped)
        cov = LIBORCovarianceModelFromVolatilityAndCorrelation(
            vol_model, LIBORCorrelationModelExponentialDecay(libor_td, 2))
        model = LIBORMarketModelTorch(libor_td, FC, DC, cov, measure="spot",
                                      state_space="lognormal")
        # the 3Y cap: fixings 0.5..2.5, indices 1..5 on the tenor grid
        cap = CapFloor(model, 1, 6, STRIKE, num_paths=120_000, seed=7,
                       device="cpu")
        assert cap.get_value(np.zeros(0)) == pytest.approx(prices[-1],
                                                           rel=0.03)

    def test_normal_curve_rejected(self):
        from finmath_tpu_torch.models.time_discretization import (
            TimeDiscretization)

        td = TimeDiscretization(initial=0.0, num_steps=4, step=PERIOD)
        c = CapletVolatilityCurve([1.0], [0.008], convention="normal")
        with pytest.raises(ValueError):
            LIBORVolatilityModelFromCapletCurve(td, td, c)
