"""The port's examples 09-14 (``finmath_tpu_torch/examples``), each loaded
with ``importlib`` from its file path and its ``main`` run once in this
process on ``device="cpu"`` at a small size (module fixtures).

* The printed lines are the JAX script's.
* Host-made numbers against the JAX package on the same inputs (one
  module fixture computes them): the analytic oracles of 09 and 10 and
  the host layers of 11-14 (the cube and CMS, the Hull-White PDE and
  Jamshidian, the caps strip, the autocallable's and TARN's closed forms,
  the CDS bootstrap, the tranche recursion, the FX closed form, ZCIS and
  YoY rates, the futures curve, Kupiec, the delta-normal VaR) at the
  bounds of each module's own ``tests/test_torch_*.py`` file: 1e-12
  relative, 1e-14 for the tranche recursion and Schwartz-Smith, 1e-9 for
  the delta-normal VaR (a central difference), Kupiec equal.
* Same-stream identities and closed forms: 10's up-in plus up-out equals
  the European on one stream within 1e-9; each Monte-Carlo number the
  scripts print beside a closed form lies within five of its standard
  errors of it, or, where the script prints no error, within the bound
  stated at the check.

The random streams differ from the JAX package's (Threefry cannot be
rebuilt in torch), so no simulated number is compared with the JAX
package's path by path."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_examples import run  # noqa: E402

PATHS = 20_000
STRIKES = np.array([80.0, 90.0, 100.0, 110.0, 125.0])


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def zoo():
    return run("09_model_zoo", num_paths=PATHS, gaussian_paths=PATHS,
               slv_paths=4_000)


@pytest.fixture(scope="module")
def exotics():
    return run("10_exotics_and_rainbows", num_paths=PATHS)


@pytest.fixture(scope="module")
def rates():
    return run("11_rates_cube_cms_bermudan", bermudan_paths=PATHS,
               hedge_paths=PATHS)


@pytest.fixture(scope="module")
def tour():
    return run("12_localvol_structured_caps_hybrid", num_paths=4_000)


@pytest.fixture(scope="module")
def credit():
    return run("13_credit_xccy_portfolio", num_paths=PATHS)


@pytest.fixture(scope="module")
def inflation():
    return run("14_inflation_commodity_risk", num_paths=PATHS)


@pytest.fixture(scope="module")
def jax_host():
    """The JAX package's host numbers on the examples' inputs."""
    from finmath_tpu.models import analytic as ja
    from finmath_tpu.models import bachelier as jbach
    from finmath_tpu.models import bates as jbates
    from finmath_tpu.models import caps as jcaps
    from finmath_tpu.models import commodity as jcmdty
    from finmath_tpu.models import credit as jcredit
    from finmath_tpu.models import cross_currency as jxccy
    from finmath_tpu.models import cube as jcube
    from finmath_tpu.models import curves as jcurves
    from finmath_tpu.models import heston as jheston
    from finmath_tpu.models import hull_white as jhw
    from finmath_tpu.models import hw_bermudan as jhwb
    from finmath_tpu.models import inflation as jinfl
    from finmath_tpu.models import merton as jmerton
    from finmath_tpu.models import multi_asset as jma
    from finmath_tpu.models import portfolio_credit as jpc
    from finmath_tpu.models import risk as jrisk
    from finmath_tpu.models import sabr as jsabr
    from finmath_tpu.models import structured_products as jsp
    from finmath_tpu.models import tarn as jtarn
    from finmath_tpu.models import variance_gamma as jvg
    from finmath_tpu.models.american import crr_american_price
    from finmath_tpu.models.local_vol import SSVISurface

    out = {}
    # 09: the oracles
    hp = jheston.HestonParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.05,
                              xi=0.6, rho=-0.7)
    out["heston_cf"] = jheston.heston_characteristic_prices(hp, 1.5, STRIKES)
    out["merton_series"] = jmerton.merton_series_prices(
        jmerton.MertonParams(100.0, 0.05, 0.2, jump_intensity=0.6,
                             jump_size_mean=-0.15, jump_size_std=0.25),
        1.0, STRIKES)
    out["vg"] = jvg.vg_analytic_prices(
        jvg.VarianceGammaParams(100.0, 0.04, sigma=0.18, theta=-0.14,
                                nu=0.25), 1.25, STRIKES)
    out["bachelier"] = jbach.bachelier_analytic_price(
        jbach.BachelierParams(100.0, 0.03, volatility=15.0), 1.25,
        np.array([-20.0, 80.0, 100.0, 120.0]))
    out["displaced"] = jbach.displaced_analytic_price(
        jbach.DisplacedLognormalParams(100.0, 0.03, 0.2, displacement=30.0),
        1.25, STRIKES)
    out["bates_cf"] = jbates.bates_characteristic_prices(
        jbates.BatesParams(100.0, 0.03, v0=0.04, kappa=1.5, theta=0.05,
                           xi=0.6, rho=-0.7, jump_intensity=0.6,
                           jump_size_mean=-0.12, jump_size_std=0.18),
        1.5, STRIKES)
    pil = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 15.0, 20.0])
    zeros = np.array([0.010, 0.012, 0.015, 0.017, 0.020, 0.022, 0.024,
                      0.025, 0.0255])
    m = jhw.HullWhiteModel(
        jcurves.DiscountCurve(list(pil), list(np.exp(-zeros * pil))), 0.12,
        [0.010, 0.014, 0.008], vol_times=[0.0, 2.0, 5.0])
    out["hw_df"] = float(m.df(10.0))
    out["jamshidian"] = float(m.swaption(2.0, [3.0, 3.5, 4.0, 4.5, 5.0],
                                         0.02))
    out["crr"] = crr_american_price(100.0, 0.05, 0.3, 1.0, 110.0,
                                    is_call=False)

    # 10: the closed forms
    out["digital"] = ja.digital_option_value(100.0, 0.05, 0.3, 1.0, 105.0)
    out["barrier"] = ja.barrier_option_value(100.0, 0.05, 0.3, 1.0, 100.0,
                                             130.0, "up-out")
    out["lookback"] = ja.lookback_floating_strike_value(100.0, 0.05, 0.3,
                                                        1.0, True)
    out["margrabe"] = jma.margrabe_exchange_value(100.0, 95.0, 0.25, 0.35,
                                                  0.4, 1.5)
    out["stulz"] = jma.stulz_rainbow_value(100.0, 95.0, 0.05, 0.25, 0.35,
                                           0.4, 1.5, 100.0, "call-on-min")
    out["kirk"] = jma.kirk_spread_approximation(100.0, 95.0, 0.05, 0.25,
                                                0.35, 0.4, 1.5, 10.0)
    sp = jsabr.SABRParams(alpha=0.035, beta=0.5, rho=-0.3, nu=0.4)
    out["hagan"] = [jsabr.sabr_lognormal_implied_volatility(sp, 0.03, k, 2.0)
                    for k in (0.02, 0.025, 0.03, 0.04)]

    # 11: the cube and CMS, the PDE and the best European
    ts = np.arange(0.5, 30.1, 0.5)
    curve = jcurves.DiscountCurve(list(ts), list(np.exp(-0.025 * ts)))
    pay = [5.0 + (i + 1) * 0.5 for i in range(20)]
    a0 = jcurves.swap_annuity(curve, pay, [0.5] * 20)
    s0 = float((curve.get_discount_factor(5.0)
                - curve.get_discount_factor(pay[-1])) / a0)
    cube = jcube.SwaptionCube()
    true = jsabr.SABRParams(alpha=0.25 * s0 ** 0.3, beta=0.7, rho=-0.25,
                            nu=0.25)
    ks = s0 * np.array([0.6, 0.8, 1.0, 1.3, 1.7])
    smile = cube.calibrate_cell(
        5.0, 10.0, s0, ks,
        [jsabr.sabr_lognormal_implied_volatility(true, s0, k, 5.0)
         for k in ks], beta=0.7)
    mapping = jcube.LinearTSRAnnuityMapping.from_curve(
        curve, s0, pay, payment_time=5.5, period_length=0.5)
    pricer = jcube.CMSReplicationPricer(smile, mapping, a0)
    out["cube"] = {
        "par": s0, "annuity": float(a0),
        "fit": (smile.params.alpha, smile.params.rho, smile.params.nu),
        "atm_vol": float(cube.get_volatility(5.0, 10.0, s0)),
        "convexity": float(pricer.convexity_adjustment()),
        "cms": float(pricer.cms_rate()),
        "caplet": float(pricer.caplet_value(s0)),
        "floorlet": float(pricer.floorlet_value(s0)),
        "swaplet": float(pricer.swaplet_value(s0))}
    ts = np.arange(0.5, 20.1, 0.5)
    hw = jhw.HullWhiteModel(
        jcurves.DiscountCurve(list(ts), list(np.exp(-0.022 * ts))), 0.1,
        [0.01])
    ex = [2.0 + 0.5 * i for i in range(10)]
    prod = jhwb.BermudanSwaption(ex, 7.0, 0.025)
    out["pde"] = float(jhwb.hw_bermudan_swaption_pde(
        hw, ex, 7.0, 0.025, nx=601, steps_per_year=100))
    out["best_european"] = float(max(
        hw.swaption(t, list(prod.remaining_payments(i)), 0.025)
        for i, t in enumerate(ex)))

    # 12: the SSVI targets, the autocallable's and the TARN's closed forms,
    # the caps strip
    surf = SSVISurface(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65,
                       eta=1.2)
    fwd = 100.0 * math.exp(0.03)
    out["ssvi"] = [float(surf.implied_volatility(math.log(k / fwd), 1.0))
                   for k in (80.0, 90.0, 100.0, 110.0, 120.0)]
    out["autocall"] = jsp.autocallable_value_single_observation(
        100.0, 0.03, 0.25, 0.5, 1.0, autocall_level=105.0, coupon1=0.05,
        final_coupon_level=100.0, final_coupon=0.08, protection_level=70.0)
    ts = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0])
    zr = np.array([0.012, 0.014, 0.017, 0.019, 0.022, 0.024, 0.026])
    fix = [0.5 * i for i in range(1, 9)]
    out["inverse_floater"] = float(jtarn.inverse_floater_value(
        jhw.HullWhiteModel(jcurves.DiscountCurve(
            list(ts), list(np.exp(-zr * ts))), 0.10, 0.011),
        fix, [f + 0.5 for f in fix], 0.045, multiplier=2.0))
    ts = np.array([0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 12.0])
    zr = np.array([0.015, 0.017, 0.020, 0.022, 0.025, 0.027, 0.029, 0.030])
    dc = jcurves.DiscountCurve(list(ts), list(np.exp(-zr * ts)))
    fc = jcurves.ForwardCurve(dc, payment_offset=0.5)
    out["caps"] = np.asarray(jcaps.strip_caplet_volatilities(
        dc, fc, np.array([1.0, 2.0, 3.0, 5.0, 7.0, 10.0]),
        np.array([0.44, 0.41, 0.37, 0.31, 0.27, 0.24]), 0.03,
        0.5).volatilities)
    out["quanto_black"] = ja.black_formula(
        80.0 * math.exp((0.02 - 0.01 - 0.6 * 0.25 * 0.12) * 3.0), 82.0,
        0.25, 3.0, payoff_unit=float(np.exp(-0.051 * 3.0)))

    # 13: the CDS bootstrap, the FX closed form, the tranche recursion
    grid = np.arange(0.0, 31.0)
    dc_d = jcurves.DiscountCurve(grid, np.exp(-0.03 * grid))
    dc_f = jcurves.DiscountCurve(grid, np.exp(-0.01 * grid))
    sc = jcredit.bootstrap_survival_curve(
        dc_d, [1.0, 3.0, 5.0, 7.0, 10.0],
        [0.006, 0.009, 0.012, 0.014, 0.016], recovery=0.4)
    out["hazards"] = np.asarray(sc.hazards)
    out["par_4y"] = float(jcredit.cds_par_spread(dc_d, sc, 4.0,
                                                 recovery=0.4))
    out["survival"] = [float(sc.get_survival_probability(t))
                       for t in (5.0, 10.0)]
    out["wwr_strike"] = float(jcredit.par_swap_rate(
        dc_d, np.arange(1, 21) * 0.5))
    xm = jxccy.CrossCurrencyModel(jhw.HullWhiteModel(dc_d, 0.1, 0.01),
                                  jhw.HullWhiteModel(dc_f, 0.05, 0.008),
                                  fx_spot=1.25, fx_vol=0.10, rho_df=0.3,
                                  rho_dx=-0.2, rho_fx=0.25)
    out["fx_option"] = [float(xm.fx_option(5.0, k))
                        for k in (1.0, 1.25, 1.5)]
    rng = np.random.default_rng(1)
    hazards, betas = rng.uniform(0.005, 0.06, 125), rng.uniform(0.3, 0.7,
                                                                125)
    pf = jpc.GaussianCopulaPortfolio(
        [jcredit.SurvivalCurve([0.0], [h]) for h in hazards], betas=betas,
        recoveries=0.4, notionals=np.full(125, 1 / 125))
    out["tranche_spreads"] = [pf.tranche_par_spread(dc_d, a, d, 5.0)
                              for a, d in ((0.0, 0.03), (0.03, 0.07),
                                           (0.07, 0.15))]
    out["etl"] = pf.expected_tranche_loss(5.0, 0.03, 0.07)
    hom = jpc.GaussianCopulaPortfolio(
        [jcredit.SurvivalCurve([0.0], [0.02])] * 200, betas=0.5,
        notionals=1 / 200)
    out["exact_200"] = hom.expected_tranche_loss(5.0, 0.03, 0.07)
    out["lhp"] = jpc.lhp_expected_tranche_loss(
        float(1 - math.exp(-0.02 * 5.0)), 0.5, 0.03, 0.07)

    # 14: Jarrow-Yildirim, Schwartz-Smith, Kupiec and the delta-normal VaR
    t = np.arange(0.0, 21.0)
    nominal = jhw.HullWhiteModel(jcurves.DiscountCurve(t, np.exp(-0.03 * t)),
                                 0.1, 0.01)
    real = jhw.HullWhiteModel(jcurves.DiscountCurve(t, np.exp(-0.01 * t)),
                              0.2, 0.006)
    jy = jinfl.JarrowYildirimModel(nominal, real, cpi_initial=100.0,
                                   cpi_vol=0.012, rho_nr=0.3, rho_ni=0.1,
                                   rho_ri=-0.3)
    out["zcis"] = [jy.zcis_par_rate(T) for T in (2.0, 5.0, 10.0)]
    out["yoy_swap"] = float(jy.yoy_swap_par_rate(np.arange(1.0, 11.0)))
    out["yoy_forward"] = float(jy.yoy_forward(4.0, 5.0))
    out["yoy_caplets"] = [float(jy.yoy_caplet(4.0, 5.0, k))
                          for k in (0.01, 0.03)]
    ss = jcmdty.SchwartzSmithModel(chi0=0.1, xi0=math.log(60.0), kappa=1.5,
                                   sigma_chi=0.35, sigma_xi=0.15, rho=0.3,
                                   mu_star=0.01, lambda_chi=0.05)
    out["futures"] = [float(ss.futures_price(T))
                      for T in (0.25, 0.5, 1.0, 2.0, 5.0)]
    out["black_on_future"] = [float(ss.option_on_future(1.0, 2.0, k, 0.97))
                              for k in (55.0, 65.0)]
    out["margrabe_spread"] = float(ss.calendar_spread_margrabe(1.0, 1.5, 2.0,
                                                               0.97))
    out["kupiec"] = jrisk.kupiec_pvalue(10, 1000, 0.99)
    book = jrisk.OptionBook(spots=[100.0, 50.0], rate=0.02,
                            underlying_index=[0, 0, 1, 1],
                            strikes=[100.0, 110.0, 50.0, 45.0],
                            expiries=[0.5, 1.0, 0.25, 1.0],
                            vols=[0.2, 0.22, 0.3, 0.28],
                            notionals=[100.0, -50.0, 80.0, 40.0],
                            is_call=[True, True, True, False])
    out["delta_normal"] = jrisk.MarketRiskEngine(
        book, horizon=1 / 252).delta_normal_var(
            np.array([[0.04, 0.012], [0.012, 0.09]]), 0.99)
    return out


def test_09_model_zoo(zoo, jax_host):
    out, printed = zoo
    assert printed.startswith("devices: [cpu] (host CPU)\n")
    heads = ("[heston]   QE-M 20k x 64:", "[heston]   surface calibration:",
             "[bates]    SVJ MC 20k x 96:", "[slv]      particle 4k x 100:",
             "[merton]   jump-diffusion 20k x 16:",
             "[vg]       gamma-subordinated 20k x 16:",
             "[bachelier] exact-terminal 0.02M:",
             "[displaced] shifted-Black 0.02M:",
             "[hullwhite] curve fit E[1/N(10y)]:",
             "[american] LS put 20k x 50 dates:")
    lines = [ln for ln in printed.splitlines() if ln.startswith("[")]
    assert [any(ln.startswith(h) for ln in lines) for h in heads] \
        == [True] * len(heads)
    # the JAX order: heston, bates, slv, merton, vg, bachelier, hw, american
    assert [ln.split("]")[0] for ln in lines] == [
        "[heston", "[heston", "[bates", "[slv", "[merton", "[vg",
        "[bachelier", "[displaced", "[hullwhite", "[american"]
    # the host oracles are the JAX package's
    for key, want in (("heston", "heston_cf"), ("bates", "bates_cf")):
        assert rel(out[key]["cf"], jax_host[want]) <= 1e-12
    assert rel(out["merton"]["series"], jax_host["merton_series"]) <= 1e-12
    assert rel(out["variance_gamma"]["fourier"], jax_host["vg"]) <= 1e-12
    bd = out["bachelier_displaced"]
    assert rel(bd["bachelier_analytic"], jax_host["bachelier"]) <= 1e-12
    assert rel(bd["displaced_analytic"], jax_host["displaced"]) <= 1e-12
    assert rel(out["hull_white"]["df"], jax_host["hw_df"]) <= 1e-12
    assert rel(out["hull_white"]["jamshidian"],
               jax_host["jamshidian"]) <= 1e-12
    assert rel(out["american"]["crr"], jax_host["crr"]) <= 1e-12
    # the calibration refits the characteristic-function surface exactly
    assert out["heston"]["calibration_rms"] < 1e-6
    # Monte Carlo beside the oracles, at 20,000 paths
    for key in ("heston", "bates", "merton", "variance_gamma"):
        assert out[key]["prices"].shape == (5,)
        assert np.all(np.isfinite(out[key]["prices"]))
    assert bd["bachelier_abs_dev"] < 0.5          # a 15.0 normal vol
    assert bd["displaced_rel_dev"] < 0.05
    hwo = out["hull_white"]
    assert abs(hwo["bond"] / hwo["df"] - 1.0) < 1e-3
    assert abs(hwo["swaption"] / hwo["jamshidian"] - 1.0) < 0.05
    am = out["american"]
    assert abs(am["value"] - am["crr"]) < 5 * am["stderr"]
    assert out["slv"]["calls"].shape[:2] == (1, 3)
    assert all(np.isfinite(out["slv"]["iv_devs"]))


def test_10_exotics_and_rainbows(exotics, jax_host):
    out, printed = exotics
    for head in ("[digital]", "[asian]", "[barrier]",
                 "same-stream in+out parity:", "[lookback]", "[exchange]",
                 "[rainbow]", "call-on-max over all 3 assets:", "[basket]",
                 "[spread]", "[sabr]      Hagan", "MC     [",
                 "refit of the MC smile:"):
        assert head in printed, head
    pd, rb = out["path_dependent"], out["rainbows"]
    # up-in and up-out on one stream are the European: within 1e-9 of the
    # European collected as the barrier products collect it (float32
    # payoffs, float64 discount and mean; a barrier never hit), and within
    # 1e-6 relative of ``EuropeanOption``, whose float32 division by the
    # numeraire moves the mean by 1.5e-8 relative in both packages
    vi, vo, ve = pd["parity"]
    from finmath_tpu_torch.models import BarrierOption

    european = BarrierOption(1.0, 100.0, 1e6, "up-out").get_value(pd["model"])
    assert abs(vi + vo - european) <= 1e-9
    assert abs(vi + vo - ve) < 1e-6 * ve
    for key in ("digital", "barrier", "lookback"):
        assert rel(pd[key][2], jax_host[key]) <= 1e-12, key
    assert rel(rb["exchange"][2], jax_host["margrabe"]) <= 1e-12
    assert rel(rb["call_on_min"][2], jax_host["stulz"]) <= 1e-12
    assert rel(rb["spread"][2], jax_host["kirk"]) <= 1e-12
    assert rel(out["sabr"]["hagan"], jax_host["hagan"]) <= 1e-12
    # Monte Carlo against the exact closed forms, within five errors
    for v, e, cf in (pd["digital"], rb["exchange"], rb["call_on_min"]):
        assert abs(v - cf) < 5 * e
    # the geometric control variate cuts the Asian's error
    vp, ep, vc, ec, _ = pd["asian"]
    assert ec < ep / 5 and abs(vc - vp) < 5 * ep
    # the discretely monitored lookback lies below the continuous one
    assert pd["lookback"][0] < pd["lookback"][2]
    assert np.all(np.abs(out["sabr"]["mc"] - out["sabr"]["hagan"]) < 0.01)


def test_11_rates_cube_cms_bermudan(rates, jax_host):
    out, printed = rates
    assert printed.startswith("devices: [cpu] (host CPU)\n")
    for head in ("[curve]     5y10y par swap rate", "[cube]      5y10y SABR",
                 "[cms]       convexity adjustment", "ATM caplet",
                 "flat-smile quadrature vs EXACT closed form",
                 "[bermudan]  LS 20k x 10 dates:", "PDE oracle",
                 "[hedge]     250 rebalances:", "[varswap]   fair strike"):
        assert head in printed, head
    cube, want = out["cube"], jax_host["cube"]
    for key in want:
        assert rel(cube[key], want[key]) <= 1e-12, key
    assert abs(cube["caplet"] - cube["floorlet"] - cube["swaplet"]) < 1e-9
    assert cube["flat_dev"] < 1e-9
    berm = out["bermudan"]
    assert rel(berm["pde"], jax_host["pde"]) <= 1e-12
    assert rel(berm["best_european"], jax_host["best_european"]) <= 1e-12
    assert abs(berm["value"] - berm["pde"]) < 5 * berm["stderr"]
    assert berm["value"] > berm["best_european"]
    assert abs(out["hedge"]["variance_strike"] - 0.09) < 0.005


def test_12_localvol_structured_caps_hybrid(tour, jax_host):
    out, printed = tour
    for name in ("local_vol", "structured", "tarn", "caps", "hybrid"):
        assert f"--- {name}: " in printed
        assert out["walls"][name] >= 0.0
    for head in ("[local vol] strike   SSVI-in   MC-round-trip",
                 "[autocall]  MC", "[autocall]  4-date memory-coupon note:",
                 "[TARN]      uncapped MC", "[TARN]      target 0.02:",
                 "[caps]      stripped 6 maturities",
                 "[hybrid]    equity call under stochastic rates",
                 "[hybrid]    FX forward (covered interest parity):",
                 "[hybrid]    quanto call:"):
        assert head in printed, head
    rows = out["local_vol"]["rows"]
    assert rel([r[1] for r in rows], jax_host["ssvi"]) <= 1e-12
    # the smile round trip at 4,000 paths, within 100 bp
    assert max(abs(r[2] - r[1]) for r in rows) < 0.01
    st = out["structured"]
    assert rel(st["closed_form"], jax_host["autocall"]) <= 1e-12
    assert abs(st["value"] - st["closed_form"]) < 5 * st["stderr"]
    tn = out["tarn"]
    assert rel(tn["inverse_floater"], jax_host["inverse_floater"]) <= 1e-12
    assert abs(tn["uncapped"] - tn["inverse_floater"]) < 5 * tn["stderr"]
    assert rel(out["caps"]["volatilities"], jax_host["caps"]) <= 1e-12
    for _, dev in out["caps"]["repriced"]:
        assert dev < 1e-12
    hy = out["hybrid"]
    assert rel(hy["quanto_closed_form"], jax_host["quanto_black"]) <= 1e-12
    assert abs(hy["quanto"] - hy["quanto_closed_form"]) \
        < 5 * hy["quanto_stderr"]
    assert abs(hy["fx_forward"] - hy["fx_parity"]) < 5 * hy["fx_stderr"]


def test_13_credit_xccy_portfolio(credit, jax_host):
    out, printed = credit
    for name in ("single_name_credit", "wrong_way_cva", "cross_currency",
                 "portfolio_credit"):
        assert f"--- {name}: " in printed
    for head in ("[cds]      bootstrapped 5 quotes;", "[cds]      4y par",
                 "[cir++]    E[S(5y)]", "[wwr]      rho=-0.6:",
                 "[xccy]     covered interest parity",
                 "[xccy]     CCS legs:", "[cdo]      3%-7% tranche",
                 "[cdo]      MC 3-7% ETL(5y)", "200-name exact vs Vasicek"):
        assert head in printed, head
    sn = out["single_name_credit"]
    assert rel(sn["hazards"], jax_host["hazards"]) <= 1e-12
    assert rel(sn["par_4y"], jax_host["par_4y"]) <= 1e-12
    assert sn["worst_reprice"] < 1e-12
    for t, want in zip((5.0, 10.0), jax_host["survival"]):
        mc, market = sn["survival"][t]
        assert rel(market, want) <= 1e-12
        assert abs(mc - market) < 2e-3
    ww = out["wrong_way_cva"]
    assert rel(ww["strike"], jax_host["wwr_strike"]) <= 1e-12
    cva = {rho: v[0] for rho, v in ww["by_rho"].items()}
    assert cva[-0.6] < cva[0.0] < cva[0.6]      # wrong way costs more
    xc = out["cross_currency"]
    assert rel(xc["closed_form"], jax_host["fx_option"]) <= 1e-12
    assert np.all(np.abs(xc["prices"] - xc["closed_form"])
                  < 5 * xc["stderr"])
    pc = out["portfolio_credit"]
    assert rel([pc["spreads"][k] for k in sorted(pc["spreads"])],
               jax_host["tranche_spreads"]) <= 1e-14
    assert rel(pc["etl_exact"], jax_host["etl"]) <= 1e-14
    assert rel(pc["exact_200"], jax_host["exact_200"]) <= 1e-14
    assert rel(pc["lhp"], jax_host["lhp"]) <= 1e-14
    assert abs(pc["etl_mc"] - pc["etl_exact"]) < 5 * pc["etl_stderr"]


def test_14_inflation_commodity_risk(inflation, jax_host):
    out, printed = inflation
    for name in ("inflation", "commodity", "risk"):
        assert f"--- {name}: " in printed
    for head in ("[infl]  ZCIS par rates:", "[infl]  10y YoY swap par rate",
                 "[infl]  exact MC confirms:", "[infl]  YoY caplet k=3%:",
                 "[cmdty] futures curve:", "(Samuelson)",
                 "[cmdty] calendar spread", "[risk]  1-day VaR99",
                 "[risk]    ES component put 45:",
                 "[risk]  delta-normal control",
                 "[risk]  Kupiec p-value for 10 breaches / 1000 days:"):
        assert head in printed, head
    inf = out["inflation"]
    assert rel(list(inf["zcis"].values()), jax_host["zcis"]) <= 1e-12
    assert rel(inf["yoy_swap"], jax_host["yoy_swap"]) <= 1e-12
    assert rel(inf["yoy_forward"], jax_host["yoy_forward"]) <= 1e-12
    assert rel([inf["caplets"][k][0] for k in (0.01, 0.03)],
               jax_host["yoy_caplets"]) <= 1e-12
    mc, se = inf["mc_yoy"]
    assert abs(mc - inf["yoy_forward"]) < 5 * se
    for an, mc_c, se_c in inf["caplets"].values():
        assert abs(mc_c - an) < 5 * se_c
    cm = out["commodity"]
    assert rel(cm["futures"], jax_host["futures"]) <= 1e-14
    assert rel(cm["black"], jax_host["black_on_future"]) <= 1e-14
    assert rel(cm["margrabe"], jax_host["margrabe_spread"]) <= 1e-14
    assert cm["vols"][0] > cm["vols"][1] > cm["vols"][2]
    assert np.all(np.abs(cm["options"] - cm["black"])
                  < 5 * cm["option_stderr"])
    rk = out["risk"]
    assert rk["kupiec"] == jax_host["kupiec"]
    assert abs(rk["delta_normal"] - jax_host["delta_normal"]) \
        <= 1e-9 * jax_host["delta_normal"]
    assert rk["es"] >= rk["var"] > 0
    assert abs(rk["component_es"].sum() - rk["es"]) < 1e-6 * rk["es"]
