"""The port's market-risk engine (``finmath_tpu_torch/models/risk.py``) and
its SA-CCR / capital / KVA layer (``models/regulatory.py``) against
finmath_tpu's, and ``tests/test_risk.py``'s and
``tests/test_regulatory.py``'s checks on the port.

Tolerances against the JAX package:
* ``parametric_mc`` on the JAX draws (``normals=(z, zv)``, the float64
  Threefry blocks of ``split(PRNGKey(seed))``) and ``historical`` on one
  returns matrix: every field of the ``RiskReport`` within 1e-12 relative
  (the component ES relative to its largest entry, the mean P&L, whose
  gains and losses nearly cancel, relative to the expected shortfall);
  both packages sort the same float64 P&L up to the last-bit gap of
  ``erf`` (measured 1.3e-13; the historical mean P&L 2.7e-13 apart, 4.4e-12
  of itself, 2.3e-15 of the ES);
* ``delta_normal_var``: 1e-9 relative, since its central difference
  divides the last-bit gap of two revaluations by 2e-5 (measured 9.3e-12);
* the host layers (the VaR helpers, Kupiec, every SA-CCR, capital and KVA
  function): equal, bit for bit: the same NumPy code on the same inputs,
  the KVA on a profile of the port's own exposure engine.
The rest are the JAX files' cases with their sizes, seeds and bounds, on
the port's own torch stream.
"""

import math
from statistics import NormalDist
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import regulatory as reg  # noqa: E402
from finmath_tpu_torch.models.regulatory import (  # noqa: E402
    ALPHA, IR_SUPERVISORY_FACTOR, SACCRTrade, ccr_capital_profile,
    cva_capital, cva_capital_profile, kva, kva_from_capital_profile,
    saccr_addon, saccr_ead, saccr_ead_profile, saccr_multiplier,
    supervisory_option_delta)
from finmath_tpu_torch.models.risk import (  # noqa: E402
    MarketRiskEngine, OptionBook, expected_shortfall, kupiec_pvalue,
    value_at_risk)

CPU = "cpu"
COV = np.array([[0.04, 0.012], [0.012, 0.09]])
BOOK = dict(spots=[100.0, 50.0], rate=0.02, underlying_index=[0, 0, 1, 1],
            strikes=[100.0, 110.0, 50.0, 45.0],
            expiries=[0.5, 1.0, 0.25, 1.0], vols=[0.2, 0.22, 0.3, 0.28],
            notionals=[100.0, -50.0, 80.0, 40.0],
            is_call=[True, True, True, False])
#: the JAX parity runs: scenarios, seed; historical days
PAR_SCENARIOS, PAR_SEED, HIST_DAYS = 4_000, 5, 500
FIELDS = ("var", "expected_shortfall", "quantile", "horizon", "mean_pnl",
          "stderr_var")


def convex_book():
    return OptionBook(**BOOK)


def delta_book():
    # deep-ITM long calls ~ forwards: gamma-negligible
    return OptionBook(spots=[100.0], rate=0.02, underlying_index=[0],
                      strikes=[20.0], expiries=[1.0], vols=[0.2],
                      notionals=[100.0])


def _engine(book=None):
    return MarketRiskEngine(book or convex_book(), horizon=1 / 252,
                            device=CPU)


def _history():
    return np.random.default_rng(0).multivariate_normal(
        [0, 0], COV / 252, size=HIST_DAYS)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX engine's reports on the convex book (parametric with and
    without vol shocks, historical), its delta-normal VaRs, the draws of
    its parametric runs, once."""
    import jax

    from finmath_tpu.models import risk as jr

    eng = jr.MarketRiskEngine(jr.OptionBook(**BOOK), horizon=1 / 252)
    k1, k2 = jax.random.split(jax.random.PRNGKey(PAR_SEED))
    half = PAR_SCENARIOS // 2
    return {
        "book": eng.book,
        "plain": eng.parametric_mc(COV, num_scenarios=PAR_SCENARIOS,
                                   seed=PAR_SEED),
        "vega": eng.parametric_mc(COV, num_scenarios=PAR_SCENARIOS,
                                  seed=PAR_SEED,
                                  vol_covariance=np.diag([1.0, 1.0])),
        "historical": eng.historical(_history(), quantile=0.975),
        "delta_normal": eng.delta_normal_var(COV, 0.99),
        # parametric_mc's draws: normal(k1, (half, n)) and
        # normal(k2, (half, n)), float64 under jax_enable_x64
        "normals": (np.asarray(jax.random.normal(k1, (half, 2))),
                    np.asarray(jax.random.normal(k2, (half, 2)))),
    }


def _same_report(got, want, rel=1e-12):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        # the mean P&L sums gains and losses that nearly cancel (-0.063 of
        # P&Ls of +-100 in the historical run), so it is held on the P&L's
        # scale, the expected shortfall
        scale = want.expected_shortfall if f == "mean_pnl" else w
        assert abs(g - w) <= rel * abs(scale), f
    scale = np.max(np.abs(want.component_es))
    assert np.all(np.abs(got.component_es - want.component_es)
                  <= rel * scale)


# ---------------------------------------------------------------------------
# market risk against the JAX package
# ---------------------------------------------------------------------------

def test_parametric_reports_match_jax(jax_side):
    eng = MarketRiskEngine(convert.option_book_from_jax(jax_side["book"]),
                           horizon=1 / 252, device=CPU)
    z, zv = jax_side["normals"]
    _same_report(eng.parametric_mc(COV, num_scenarios=PAR_SCENARIOS,
                                   normals=(z, None)), jax_side["plain"])
    _same_report(eng.parametric_mc(COV, num_scenarios=PAR_SCENARIOS,
                                   vol_covariance=np.diag([1.0, 1.0]),
                                   normals=(z, zv)), jax_side["vega"])


def test_historical_and_delta_normal_match_jax(jax_side):
    eng = MarketRiskEngine(convert.option_book_from_jax(jax_side["book"]),
                           horizon=1 / 252, device=CPU)
    _same_report(eng.historical(_history(), quantile=0.975),
                 jax_side["historical"])
    dn = eng.delta_normal_var(COV, 0.99)
    assert abs(dn - jax_side["delta_normal"]) \
        <= 1e-9 * jax_side["delta_normal"]


def test_host_helpers_match_jax():
    from finmath_tpu.models import risk as jr

    x = np.random.default_rng(3).normal(0.0, 1.0, 10_001)
    assert value_at_risk(x, 0.99) == jr.value_at_risk(x, 0.99)
    assert expected_shortfall(x, 0.975) == jr.expected_shortfall(x, 0.975)
    for args in ((10, 1000), (0, 250), (250, 250), (17, 500, 0.975)):
        assert kupiec_pvalue(*args) == jr.kupiec_pvalue(*args)


# ---------------------------------------------------------------------------
# tests/test_risk.py's checks on the port
# ---------------------------------------------------------------------------

class TestHelpers:
    def test_var_es_on_normal_samples(self):
        x = np.random.default_rng(0).normal(0.0, 1.0, 1_000_000)
        assert abs(value_at_risk(x, 0.99) - 2.3263) < 0.02
        es_exact = math.exp(-0.5 * 2.3263 ** 2) / math.sqrt(
            2 * math.pi) / 0.01
        assert abs(expected_shortfall(x, 0.99) - es_exact) < 0.03
        assert expected_shortfall(x, 0.99) > value_at_risk(x, 0.99)
        with pytest.raises(ValueError):
            value_at_risk(x, 0.4)

    def test_kupiec(self):
        assert kupiec_pvalue(10, 1000, 0.99) > 0.9
        assert kupiec_pvalue(30, 1000, 0.99) < 1e-4
        assert kupiec_pvalue(0, 1000, 0.99) > 1e-6
        with pytest.raises(ValueError):
            kupiec_pvalue(-1, 100)


def test_book_validation():
    with pytest.raises(ValueError):
        OptionBook([100.0], 0.0, [1], [100.0], [1.0], [0.2], [1.0])
    with pytest.raises(ValueError):
        OptionBook([100.0], 0.0, [0], [-1.0], [1.0], [0.2], [1.0])
    with pytest.raises(ValueError):
        OptionBook([100.0], 0.0, [0, 0], [100.0], [1.0], [0.2], [1.0])
    with pytest.raises(ValueError):
        MarketRiskEngine(convex_book(), horizon=-1.0, device=CPU)
    with pytest.raises(NotImplementedError):
        MarketRiskEngine(convex_book(), mesh=object(), device=CPU)


class TestFullRevaluation:
    @pytest.fixture(scope="class")
    def rep(self):
        return _engine().parametric_mc(COV, num_scenarios=400_000,
                                       quantile=0.99, seed=5)

    def test_coherence_and_allocation(self, rep):
        assert rep.expected_shortfall > rep.var > 0
        assert rep.stderr_var > 0
        assert abs(np.sum(rep.component_es)
                   - rep.expected_shortfall) < 1e-9
        assert rep.component_es[1] < 0

    def test_delta_normal_agreement_gamma_free(self):
        eng = _engine(delta_book())
        cov1 = np.array([[0.04]])
        rep = eng.parametric_mc(cov1, num_scenarios=400_000, seed=7)
        dn = eng.delta_normal_var(cov1, 0.99)
        assert abs(rep.var - dn) / dn < 0.02

    def test_gamma_reduces_tail_vs_delta_normal(self, rep):
        assert rep.var < _engine().delta_normal_var(COV, 0.99)

    def test_quantile_stderr_calibrated(self):
        eng = _engine()
        vars_ = [eng.parametric_mc(COV, num_scenarios=100_000, seed=s).var
                 for s in (1, 2, 3, 4)]
        se = eng.parametric_mc(COV, num_scenarios=100_000,
                               seed=1).stderr_var
        assert se / 5 < np.std(vars_) < 5 * se

    def test_vol_shocks_add_risk(self):
        eng = _engine()
        base = eng.parametric_mc(COV, num_scenarios=200_000, seed=5)
        vega = eng.parametric_mc(COV, num_scenarios=200_000, seed=5,
                                 vol_covariance=np.diag([1.0, 1.0]))
        assert vega.var > base.var

    def test_historical(self, rep):
        eng = _engine()
        hist = np.random.default_rng(0).multivariate_normal(
            [0, 0], COV / 252, size=2000)
        rh = eng.historical(hist, quantile=0.99)
        assert abs(rh.var - rep.var) / rep.var < 0.25
        with pytest.raises(ValueError):
            eng.historical(hist[:, :1])

    def test_validation(self):
        eng = _engine()
        with pytest.raises(ValueError):
            eng.parametric_mc(np.eye(3))
        with pytest.raises(ValueError):
            eng.parametric_mc(COV, quantile=0.3)
        with pytest.raises(ValueError, match="normals z"):
            eng.parametric_mc(COV, num_scenarios=100,
                              normals=(np.zeros((49, 2)), None))


# ---------------------------------------------------------------------------
# regulatory: bit for bit against the JAX package
# ---------------------------------------------------------------------------

def _fake_profile():
    return SimpleNamespace(
        times=np.array([0.5, 1.0, 1.5, 2.0, 2.5]),
        forward_value=np.array([100.0, 80.0, -50.0, 20.0, 10.0]))


def _trade_args():
    return [(1e6, 0.0, 0.5, 1.0, "USD"), (2e6, 0.0, 10.0, -1.0, "USD"),
            (5e5, 1.0, 3.0, 0.7, "USD"), (1e6, 0.0, 7.0, 1.0, "EUR")]


def test_regulatory_matches_jax_bit_for_bit():
    from finmath_tpu.models import regulatory as jreg

    jt = [jreg.SACCRTrade(*a) for a in _trade_args()]
    pt = [convert.saccr_trade_from_jax(t) for t in jt]
    assert pt == [SACCRTrade(*a) for a in _trade_args()]
    prof = _fake_profile()
    ead = saccr_ead_profile(prof, pt)
    cases = [
        (saccr_addon(pt), jreg.saccr_addon(jt)),
        (saccr_addon(pt, margined=True), jreg.saccr_addon(jt, margined=True)),
        (saccr_multiplier(-300.0, 50.0, 900.0),
         jreg.saccr_multiplier(-300.0, 50.0, 900.0)),
        (saccr_ead(1e4, pt, collateral=2e3, margined=True, threshold=500.0,
                   mta=100.0, nica=50.0),
         jreg.saccr_ead(1e4, jt, collateral=2e3, margined=True,
                        threshold=500.0, mta=100.0, nica=50.0)),
        (supervisory_option_delta(0.03, 0.025, 2.0, call=False, long=False),
         jreg.supervisory_option_delta(0.03, 0.025, 2.0, call=False,
                                       long=False)),
        (ead, jreg.saccr_ead_profile(prof, jt)),
        (ccr_capital_profile(ead, 0.5), jreg.ccr_capital_profile(ead, 0.5)),
        (cva_capital(1000.0, 5.0, 0.02), jreg.cva_capital(1000.0, 5.0, 0.02)),
        (cva_capital_profile(ead, prof.times, 2.5),
         jreg.cva_capital_profile(ead, prof.times, 2.5)),
        (kva_from_capital_profile(prof.times, ead, 0.12, 0.02, 0.01, 0.03),
         jreg.kva_from_capital_profile(prof.times, ead, 0.12, 0.02, 0.01,
                                       0.03)),
        (kva(prof, pt, counterparty_hazard_rate=0.02, margined=True),
         jreg.kva(prof, jt, counterparty_hazard_rate=0.02, margined=True)),
    ]
    for i, (got, want) in enumerate(cases):
        np.testing.assert_array_equal(got, want, err_msg=str(i))
    assert (reg.ALPHA, reg.IR_SUPERVISORY_FACTOR, reg.IR_SUPERVISORY_VOL,
            reg.MULTIPLIER_FLOOR, reg._BUCKET_CROSS) == (
        jreg.ALPHA, jreg.IR_SUPERVISORY_FACTOR, jreg.IR_SUPERVISORY_VOL,
        jreg.MULTIPLIER_FLOOR, jreg._BUCKET_CROSS)


def test_kva_on_the_ports_exposure_profile():
    """End to end on the port: an LMM swap exposure profile of the port's
    engine -> SA-CCR EAD -> capital -> KVA, each equal to the JAX package's
    functions on the same profile."""
    from finmath_tpu.models import regulatory as jreg
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm.exposure import SwapExposureEngine

    setup = build_atm_calibration(num_paths=2000, num_factors=1, device=CPU)
    eng = SwapExposureEngine(setup.model, first_index=1, last_index=10,
                             strike=0.01, num_paths=2000, num_factors=1,
                             seed=3, device=CPU)
    prof = eng.profile(setup.covariance.initial_parameters)
    tenor = setup.model.tenor_times
    trades = [SACCRTrade(1.0, float(tenor[1]), float(tenor[10]))]
    jtrades = [jreg.SACCRTrade(1.0, float(tenor[1]), float(tenor[10]))]
    ead = saccr_ead_profile(prof, trades)
    assert ead[0] > 0.0 and np.all(np.isfinite(ead))
    np.testing.assert_array_equal(ead, jreg.saccr_ead_profile(prof, jtrades))
    v = kva(prof, trades, counterparty_hazard_rate=0.02)
    assert np.isfinite(v) and v > 0.0
    assert v == jreg.kva(prof, jtrades, counterparty_hazard_rate=0.02)


# ---------------------------------------------------------------------------
# tests/test_regulatory.py's checks on the port
# ---------------------------------------------------------------------------

def sd(s, e):
    return (np.exp(-0.05 * s) - np.exp(-0.05 * e)) / 0.05


class TestSACCRAddOn:
    def test_single_swap_hand_computed(self):
        expected = IR_SUPERVISORY_FACTOR * 1e6 * sd(0.0, 10.0)
        assert saccr_addon([SACCRTrade(1e6, 0.0, 10.0)]) == pytest.approx(
            expected, rel=1e-12)

    def test_short_maturity_factor(self):
        expected = IR_SUPERVISORY_FACTOR * 1e6 * sd(0.0, 0.5) * np.sqrt(0.5)
        assert saccr_addon([SACCRTrade(1e6, 0.0, 0.5)]) == pytest.approx(
            expected, rel=1e-12)

    def test_margined_maturity_factor(self):
        expected = IR_SUPERVISORY_FACTOR * 1e6 * sd(0.0, 10.0) \
            * 1.5 * np.sqrt(10.0 / 250.0)
        assert saccr_addon([SACCRTrade(1e6, 0.0, 10.0)], margined=True) \
            == pytest.approx(expected, rel=1e-12)

    def test_same_bucket_offsets(self):
        a = SACCRTrade(1e6, 0.0, 10.0, delta=+1.0)
        b = SACCRTrade(1e6, 0.0, 10.0, delta=-1.0)
        assert saccr_addon([a, b]) == pytest.approx(0.0, abs=1e-9)

    def test_cross_bucket_correlation(self):
        a = SACCRTrade(1e6, 0.0, 0.5, delta=+1.0)
        b = SACCRTrade(1e6, 0.0, 10.0, delta=-1.0)
        d1 = 1e6 * sd(0.0, 0.5) * np.sqrt(0.5)
        d3 = -1e6 * sd(0.0, 10.0)
        en = np.sqrt(d1 * d1 + d3 * d3 + 0.6 * d1 * d3)
        assert saccr_addon([a, b]) == pytest.approx(
            IR_SUPERVISORY_FACTOR * en, rel=1e-12)

    def test_hedging_sets_do_not_offset(self):
        usd = SACCRTrade(1e6, 0.0, 10.0, delta=+1.0, hedging_set="USD")
        eur = SACCRTrade(1e6, 0.0, 10.0, delta=-1.0, hedging_set="EUR")
        single = saccr_addon([SACCRTrade(1e6, 0.0, 10.0)])
        assert saccr_addon([usd, eur]) == pytest.approx(2 * single,
                                                        rel=1e-12)

    def test_validation(self):
        with pytest.raises(ValueError):
            SACCRTrade(-1.0, 0.0, 10.0)
        with pytest.raises(ValueError):
            SACCRTrade(1.0, 5.0, 5.0)
        with pytest.raises(ValueError):
            saccr_addon([])


class TestMultiplierAndEAD:
    def test_multiplier(self):
        assert saccr_multiplier(0.0, 0.0, 100.0) == 1.0
        assert saccr_multiplier(50.0, 0.0, 100.0) == 1.0
        m = saccr_multiplier(-100.0, 0.0, 100.0)
        expected = 0.05 + 0.95 * np.exp(-100.0 / (2 * 0.95 * 100.0))
        assert m == pytest.approx(expected, rel=1e-12)
        assert 0.05 < m < 1.0
        assert saccr_multiplier(-1e9, 0.0, 1.0) == pytest.approx(0.05)
        assert saccr_multiplier(0.0, 50.0, 100.0) < 1.0

    def test_ead_hand_computed(self):
        tr = SACCRTrade(1e6, 0.0, 10.0)
        addon = IR_SUPERVISORY_FACTOR * 1e6 * sd(0.0, 10.0)
        assert saccr_ead(2000.0, [tr]) == pytest.approx(
            ALPHA * (2000.0 + addon), rel=1e-12)

    def test_margined_rc_floor(self):
        tr = SACCRTrade(1e6, 0.0, 10.0)
        e = saccr_ead(0.0, [tr], margined=True, threshold=500.0, mta=100.0)
        addon = saccr_addon([tr], margined=True)
        assert e == pytest.approx(ALPHA * (600.0 + addon), rel=1e-12)


class TestSupervisoryDelta:
    def test_deltas(self):
        assert supervisory_option_delta(0.03, 0.03, 1.0) == pytest.approx(
            NormalDist().cdf(0.25), rel=1e-12)
        c = supervisory_option_delta(0.03, 0.025, 2.0, call=True)
        p = supervisory_option_delta(0.03, 0.025, 2.0, call=False)
        assert c - p == pytest.approx(1.0, rel=1e-12)
        s = supervisory_option_delta(0.03, 0.025, 2.0, long=False)
        assert s == pytest.approx(-c, rel=1e-12)

    def test_validation(self):
        with pytest.raises(ValueError):
            supervisory_option_delta(-0.01, 0.02, 1.0)
        with pytest.raises(ValueError):
            supervisory_option_delta(0.02, 0.02, 0.0)


class TestProfilesAndKVA:
    def test_ead_profile_ages_and_matures(self):
        ead = saccr_ead_profile(_fake_profile(), [SACCRTrade(1e5, 0.0, 2.0)])
        assert ead[0] > 0.0
        assert ead[1] < ead[0]
        assert ead[3] == 0.0 and ead[4] == 0.0
        assert ead[2] == pytest.approx(
            saccr_ead(-50.0, [SACCRTrade(1e5, 0.0, 0.5)]), rel=1e-12)

    def test_capital(self):
        ead = np.array([100.0, 50.0])
        assert np.allclose(ccr_capital_profile(ead, risk_weight=0.5),
                           0.08 * 0.5 * ead)
        m, eadv, w = 5.0, 1000.0, 0.01
        ead_d = eadv * (1 - np.exp(-0.05 * m)) / (0.05 * m)
        assert cva_capital(eadv, m, w) == pytest.approx(
            2.33 * w * m * ead_d, rel=1e-12)
        cap = cva_capital_profile(np.array([100.0, 100.0, 100.0, 0.0, 0.0]),
                                  _fake_profile().times, maturity=2.0)
        assert cap[0] > cap[1] > cap[2] > 0.0
        assert cap[3] == 0.0

    def test_kva(self):
        t, k = np.array([0.5, 1.0]), np.array([1.0, 1.0])
        assert kva_from_capital_profile(t, k, cost_of_capital=0.10) \
            == pytest.approx(0.10 * 1.0, rel=1e-12)
        base = kva_from_capital_profile(t, k)
        assert kva_from_capital_profile(
            t, k, counterparty_hazard_rate=0.05) < base
        assert kva_from_capital_profile(t, k, discount_rate=0.05) < base
        trades = [SACCRTrade(1e5, 0.0, 2.5)]
        v = kva(_fake_profile(), trades, counterparty_hazard_rate=0.02)
        assert np.isfinite(v) and v > 0.0
        assert v > kva(_fake_profile(), trades, include_cva_capital=False,
                       counterparty_hazard_rate=0.02)

    def test_validation(self):
        with pytest.raises(ValueError):
            kva_from_capital_profile(np.array([1.0]), np.array([1.0, 2.0]))
        with pytest.raises(ValueError):
            ccr_capital_profile(np.array([1.0]), risk_weight=-1.0)
        with pytest.raises(ValueError):
            cva_capital(100.0, 0.0)


@pytest.mark.gpu
def test_reports_on_card_match_cpu():
    """``parametric_mc`` with vol shocks on one injected draw, on the card
    and on the CPU: every field within 1e-12 relative (the card's float64
    ``erf`` and its sums may round otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(11)
    normals = tuple(torch.randn((200_000, 2), generator=g,
                                dtype=torch.float64) for _ in range(2))
    reps = [MarketRiskEngine(convex_book(), horizon=1 / 252,
                             device=dev).parametric_mc(
        COV, num_scenarios=400_000, vol_covariance=np.diag([1.0, 1.0]),
        normals=normals) for dev in (CPU, "cuda")]
    _same_report(reps[1], reps[0])
