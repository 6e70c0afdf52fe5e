"""The port's XVA extensions (``finmath_tpu_torch/models/lmm/exposure.py``:
collateral, funding, dynamic initial margin, the single-swaption exposure
engine) against finmath_tpu's, and the JAX package's own cases
(``tests/test_xva_extensions.py``) on the port.

Against the JAX package, on the ATM setup (80 libors, 1 factor) at 3,000
paths and one injected realization (seeded NumPy, sqrt(dt)-scaled):
* the XVA host integrals (``cva``/``dva``/``bilateral``/``fva``/``mva``
  and the default-probability strip) on the same profile arrays: within
  1e-12 relative (the same float64 arithmetic; measured equal bit for
  bit);
* a CSA with zero MTA, finite two-way thresholds, an independent amount
  and a one-date margin lag (the margin balance is then a continuous
  function of the lagged value, so no path can switch branch on a
  rounding gap): residual EE/ENE, gross EE/ENE, forward value within 32
  float32 ulps of the profile's largest |V/N| (the requirement reads the
  previous date's value), the PFE within 32 ulps of the largest |V|
  (measured 0.03 and 0.8 ulps);
* the dynamic IM profile (the conditional variance of the clean P&L by
  two float64 regressions a date, m2 - m1^2): within 1e-6 of the largest
  IM (measured 1.0e-8);
* ``SwaptionExposureEngine`` (physical), Longstaff-Schwartz close-out
  values before expiry: EE, ENE, forward value within 1e-6 of the
  profile's largest value (measured 1.5e-9), the PFE within 32 float32
  ulps of its largest (measured 1.5 ulps).
Against the JAX package on the stoch-vol benchmark model
(``build_benchmark_calibration``: 40 libors, 5 factors, blended local and
stochastic vol, the JAX factors given the port's signs) at 4,096 paths,
15 dates and one injected realization of the five factors and the vol's
own driver: a seven-trade netting set (four swaps, two European and one
Bermudan payer swaption) with and without a CSA with a minimum transfer
amount, every mean row within 1e-6 of its largest value (measured 5.5e-8)
and the PFE within 32 float32 ulps of its largest (measured 2 ulps). The
block is drawn from ``SV_INC_SEED``: on ``INC_SEED``'s, one path's far
forwards reach the +-1e3 clamp by date 10, the JAX package's compensated
float32 bond curve (``bond_ratio_cumprod_hi``) overflows there to NaN and
its mask drops the path, while the port's float64 curve keeps it finite
(and agrees with ``portbench/reference/xva.py`` in float64 to 2e-11).
The JAX package's own cases run on the port's own stream with the seeds
of ``tests/test_xva_extensions.py`` (torch's generator) at its bounds; its
mesh case becomes the port's ``NotImplementedError`` until the sharding
slice."""

from statistics import NormalDist

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models.curves import par_swap_rate  # noqa: E402
from finmath_tpu_torch.models.lmm.atm_calibration import (  # noqa: E402
    build_atm_calibration)
from finmath_tpu_torch.models.lmm import exposure as tx  # noqa: E402
from finmath_tpu_torch.models.lmm.exposure import (  # noqa: E402
    CSA,
    ExposureProfile,
    IMProfile,
    NettingSetExposureEngine,
    SwapTrade,
    SwaptionExposureEngine,
    _default_probability_vector,
    bilateral_cva_from_profile,
    cva_from_profile,
    dva_from_profile,
    fva_from_profile,
    mva_from_im_profile,
)

CPU = "cpu"
PATHS, STEPS, INC_SEED = 3_000, 20, 1808
N_PATHS, SEED = 6000, 20260818           # tests/test_xva_extensions.py
X, M = 8, 8
TRADES = [SwapTrade(1, 12, 0.02, payer=True)]
# forward-starting swap observed before its first cashflow, struck near the
# 5y-into-5y par rate (see tests/test_xva_extensions.py)
TRADES_FWD = [SwapTrade(10, 20, 0.00715, payer=True)]
OBS_FWD = tuple(range(1, 10))
CSA_TERMS = dict(threshold=0.001, threshold_own=0.002, mta=0.0,
                 independent_amount=0.0005, margin_lag=1)


def _increments():
    rng = np.random.default_rng(INC_SEED)
    return (np.sqrt(0.5) * rng.standard_normal((STEPS, 1, PATHS))
            ).astype(np.float32)


def _ulps32(x):
    return 32.0 * float(np.spacing(np.float32(np.max(np.abs(x)))))


@pytest.fixture(scope="module")
def setup():
    return build_atm_calibration(num_paths=N_PATHS, num_factors=1,
                                 device=CPU)


@pytest.fixture(scope="module")
def params(setup):
    return np.asarray(setup.covariance.initial_parameters)


@pytest.fixture(scope="module")
def strike(setup):
    m = setup.model
    return float(par_swap_rate(m.forward_curve, m.discount_curve,
                               m.tenor_times[X:X + M + 1]))


@pytest.fixture(scope="module")
def jax_runs(strike):
    """Every JAX program of this file, once, on the injected block: the
    CSA profile, the IM profile and the swaption engine's profile."""
    from finmath_tpu.models.lmm import exposure as jx
    from finmath_tpu.models.lmm.atm_calibration import (
        build_atm_calibration as jax_build)

    sj = jax_build(num_paths=PATHS, num_factors=1)
    x = sj.covariance.initial_parameters
    inc = _increments()
    trades = [jx.SwapTrade(1, 12, 0.02, payer=True)]
    csa = jx.NettingSetExposureEngine(sj.model, trades, num_paths=PATHS,
                                      increments=inc,
                                      csa=jx.CSA(**CSA_TERMS)).profile(x)
    im = jx.NettingSetExposureEngine(sj.model, trades, num_paths=PATHS,
                                     increments=inc).im_profile(x)
    swaption = jx.SwaptionExposureEngine(sj.model, X, M, strike,
                                         num_paths=PATHS,
                                         increments=inc).profile(x)
    return dict(jx=jx, csa=csa, im=im, swaption=swaption, inc=inc)


def engine(setup, csa=None, trades=TRADES, **kw):
    kw.setdefault("num_paths", N_PATHS)
    kw.setdefault("seed", SEED)
    return NettingSetExposureEngine(setup.model, trades, csa=csa,
                                    device=CPU, **kw)


def fwd_engine(setup, csa=None, **kw):
    return engine(setup, csa=csa, trades=TRADES_FWD,
                  observation_indices=OBS_FWD, **kw)


@pytest.fixture(scope="module")
def gross(setup, params):
    return engine(setup).profile(params)


@pytest.fixture(scope="module")
def gross_fwd(setup, params):
    return fwd_engine(setup).profile(params)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _synthetic_profile(mod):
    rng = np.random.default_rng(4)
    times = np.arange(1, 13) * 0.5
    ee = rng.uniform(0.0, 0.02, 12)
    ene = -rng.uniform(0.0, 0.02, 12)
    return mod.ExposureProfile(times, ee, ene, ee + ene, {0.95: 2 * ee})


@pytest.mark.parametrize("which", ["default_probabilities", "cva",
                                   "cva_strip", "dva", "bilateral", "fva",
                                   "fva_per_date", "mva"])
def test_host_integrals_match_jax(jax_runs, which):
    jx = jax_runs["jx"]
    prof, jprof = _synthetic_profile(tx), _synthetic_profile(jx)
    strip = _default_probability_vector(prof.times, 0.02, None) * 0.9
    spreads = np.linspace(0.01, 0.002, 12)
    im = IMProfile(prof.times, prof.ee, 1.01 * prof.ee,
                   np.full(12, 0.5), 0.99, 14.0 / 365.0)
    jim = jx.IMProfile(prof.times, prof.ee, 1.01 * prof.ee,
                       np.full(12, 0.5), 0.99, 14.0 / 365.0)
    calls = {
        "default_probabilities": lambda m, p, i:
            m._default_probability_vector(p.times, 0.02, None),
        "cva": lambda m, p, i: m.cva_from_profile(p, 0.02, 0.35),
        "cva_strip": lambda m, p, i: m.cva_from_profile(
            p, default_probabilities=strip),
        "dva": lambda m, p, i: m.dva_from_profile(p, 0.01, 0.3),
        "bilateral": lambda m, p, i: m.bilateral_cva_from_profile(
            p, 0.02, 0.01),
        "fva": lambda m, p, i: m.fva_from_profile(p, 0.01, 0.004, 0.02,
                                                  0.01),
        "fva_per_date": lambda m, p, i: m.fva_from_profile(p, spreads),
        "mva": lambda m, p, i: m.mva_from_im_profile(i, 0.008, 0.03, 0.01),
    }
    got = calls[which](tx, prof, im)
    ref = calls[which](jx, jprof, jim)
    assert got == pytest.approx(ref, rel=1e-12, abs=0.0)


def _port_pathwise(eng, x):
    outs = eng.engine._simulate_collect(eng.engine._params(x), eng._collect)
    v = torch.stack([o[0] for o in outs]).numpy()
    inv_n = torch.stack([o[-1] for o in outs]).numpy()
    return v, inv_n


@pytest.fixture(scope="module")
def port_csa(setup, params, jax_runs):
    eng = NettingSetExposureEngine(setup.model, TRADES, num_paths=PATHS,
                                   increments=jax_runs["inc"],
                                   csa=CSA(**CSA_TERMS), device=CPU)
    return eng, eng.profile(params)


@pytest.mark.parametrize("row", ["ee", "ene", "forward_value", "ee_gross",
                                 "ene_gross", "ee_standalone"])
def test_csa_profile_matches_jax(params, jax_runs, port_csa, row):
    eng, prof = port_csa
    v, inv_n = _port_pathwise(eng, params)
    got, ref = getattr(prof, row), getattr(jax_runs["csa"], row)
    assert got.shape == ref.shape == (11,)
    assert np.max(np.abs(got - ref)) <= _ulps32(v * inv_n)


def test_csa_pfe_matches_jax(params, jax_runs, port_csa):
    eng, prof = port_csa
    v, _ = _port_pathwise(eng, params)
    for q, ref in jax_runs["csa"].pfe.items():
        assert np.max(np.abs(prof.pfe[q] - ref)) <= _ulps32(v)


def test_im_profile_matches_jax(setup, params, jax_runs):
    im = NettingSetExposureEngine(setup.model, TRADES, num_paths=PATHS,
                                  increments=jax_runs["inc"],
                                  device=CPU).im_profile(params)
    ref = jax_runs["im"]
    np.testing.assert_array_equal(im.times, ref.times)
    np.testing.assert_array_equal(im.dts, ref.dts)
    for row in ("expected_im", "expected_im_tmoney"):
        got, want = getattr(im, row), getattr(ref, row)
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


def test_swaption_engine_matches_jax(setup, params, strike, jax_runs):
    prof = SwaptionExposureEngine(setup.model, X, M, strike,
                                  num_paths=PATHS,
                                  increments=jax_runs["inc"],
                                  device=CPU).profile(params)
    ref = jax_runs["swaption"]
    scale = max(np.max(np.abs(getattr(ref, r)))
                for r in ("ee", "ene", "forward_value"))
    for row in ("ee", "ene", "forward_value"):
        assert np.max(np.abs(getattr(prof, row) - getattr(ref, row))) \
            <= 1e-6 * scale
    for q in ref.pfe:
        assert np.max(np.abs(prof.pfe[q] - ref.pfe[q])) <= _ulps32(ref.pfe[q])


SV_PATHS, SV_OBS, SV_INC_SEED = 4_096, tuple(range(1, 16)), 2024
SV_CSA = dict(threshold=0.0, threshold_own=0.0, mta=0.01,
              independent_amount=0.0, margin_lag=1)


def _sv_trades(m):
    """Four swaps (one forward-starting), a long and a short European
    payer swaption and a Bermudan with three exercise dates, from the
    module ``m`` of either package."""
    return [m.SwapTrade(1, 16, 0.025, True, 1.0),
            m.SwapTrade(1, 9, 0.018, False, 0.7),
            m.SwapTrade(1, 12, 0.021, False, 1.3),
            m.SwapTrade(5, 14, 0.026, True, 0.9),
            m.SwaptionTrade(6, 8, 0.024, 1.5),
            m.SwaptionTrade(4, 6, 0.02, -0.8),
            m.BermudanSwaptionTrade((4, 6, 8), 14, 0.023, 1.2)]


@pytest.fixture(scope="module")
def jax_stochvol():
    """The JAX netting-set profiles on the stoch-vol benchmark model,
    without and with the CSA, on one injected block ``[15, 6, paths]``;
    the JAX factor reduction carries the port's column signs (a patch of
    the loaded module while its programs trace)."""
    import jax.numpy as jnp
    from finmath_tpu.models.lmm import covariance as jcov
    from finmath_tpu.models.lmm import exposure as jx
    from finmath_tpu.models.lmm.benchmark_calibration import (
        build_benchmark_calibration as jax_build)
    from finmath_tpu_torch.models.lmm.covariance import FACTOR_SIGNS
    from finmath_tpu_torch.models.lmm.benchmark_calibration import (
        CURATED_BASINS)

    reduce = jcov.factor_reduce

    def port_signs(corr, num_factors):
        R = reduce(corr, num_factors)
        signs = jnp.asarray(FACTOR_SIGNS[:num_factors])
        return R * jnp.where(R[..., :1, :] * signs < 0, -1.0, 1.0)

    x = np.asarray(CURATED_BASINS[0])
    rng = np.random.default_rng(SV_INC_SEED)
    inc = (np.sqrt(0.5) * rng.standard_normal((len(SV_OBS), 6, SV_PATHS))
           ).astype(np.float32)
    model = jax_build(num_paths=256, num_factors=5).model
    out = dict(x=x, inc=inc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcov, "factor_reduce", port_signs)
        for name, csa in (("no_csa", None), ("csa", jx.CSA(**SV_CSA))):
            out[name] = jx.NettingSetExposureEngine(
                model, _sv_trades(jx), num_paths=SV_PATHS, num_factors=5,
                increments=inc, observation_indices=SV_OBS,
                csa=csa).profile(x)
    return out


@pytest.mark.parametrize("csa", [None, SV_CSA], ids=["no_csa", "csa"])
def test_stochvol_netting_set_matches_jax(jax_stochvol, csa):
    from finmath_tpu_torch.models.lmm import build_benchmark_calibration

    model = build_benchmark_calibration(num_paths=256, device=CPU).model
    prof = NettingSetExposureEngine(
        model, _sv_trades(tx), num_paths=SV_PATHS, num_factors=5,
        increments=jax_stochvol["inc"], observation_indices=SV_OBS,
        csa=CSA(**csa) if csa else None,
        device=CPU).profile(jax_stochvol["x"])
    ref = jax_stochvol["csa" if csa else "no_csa"]
    rows = ["ee", "ene", "forward_value", "ee_standalone"]
    rows += ["ee_gross", "ene_gross"] if csa else []
    for row in rows:
        want = np.asarray(getattr(ref, row))
        assert want.shape == (len(SV_OBS),)
        assert np.max(np.abs(getattr(prof, row) - want)) \
            <= 1e-6 * np.max(np.abs(want)), row
    for q, want in ref.pfe.items():
        assert np.max(np.abs(prof.pfe[q] - np.asarray(want))) \
            <= _ulps32(want), q


# ---------------------------------------------------------------------------
# the JAX package's own cases (tests/test_xva_extensions.py) on the port
# ---------------------------------------------------------------------------

class TestCSA:
    def test_infinite_thresholds_match_uncollateralized(self, setup, params,
                                                        gross):
        prof = engine(setup, CSA(threshold=np.inf, threshold_own=np.inf,
                                 margin_lag=1)).profile(params)
        np.testing.assert_allclose(prof.ee, gross.ee, rtol=1e-12)
        np.testing.assert_allclose(prof.ene, gross.ene, rtol=1e-12)
        for q in prof.pfe:
            np.testing.assert_allclose(prof.pfe[q], gross.pfe[q],
                                       rtol=1e-12, atol=1e-15)

    def test_prohibitive_mta_matches_uncollateralized(self, setup, params,
                                                      gross):
        prof = engine(setup, CSA(mta=1e6, margin_lag=1)).profile(params)
        np.testing.assert_allclose(prof.ee, gross.ee, rtol=1e-12)
        np.testing.assert_allclose(prof.ene, gross.ene, rtol=1e-12)

    def test_gross_rows_reproduce_the_plain_profile(self, setup, params,
                                                    gross):
        prof = engine(setup, CSA(margin_lag=1)).profile(params)
        np.testing.assert_allclose(prof.ee_gross, gross.ee, rtol=1e-12)
        np.testing.assert_allclose(prof.ene_gross, gross.ene, rtol=1e-12)

    def test_zero_threshold_collateral_crushes_ee(self, setup, params,
                                                  gross_fwd):
        prof = fwd_engine(setup, CSA(margin_lag=1)).profile(params)
        assert np.max(prof.ee) < 0.5 * np.max(gross_fwd.ee)
        assert np.max(prof.ee) > 0.0

    def test_lag_zero_two_way_is_perfect(self, setup, params):
        prof = engine(setup, CSA(margin_lag=0)).profile(params)
        np.testing.assert_allclose(prof.ee, 0.0, atol=1e-12)
        np.testing.assert_allclose(prof.ene, 0.0, atol=1e-12)
        for q in prof.pfe:
            np.testing.assert_allclose(prof.pfe[q], 0.0, atol=1e-12)

    def test_cashflow_spike_inside_the_margin_period(self, setup, params):
        prof = engine(setup, CSA(margin_lag=1)).profile(params)
        assert np.max(prof.ee) > 0.0
        assert prof.ee_gross is not None

    def test_longer_lag_more_exposure(self, setup, params):
        p1 = fwd_engine(setup, CSA(margin_lag=1)).profile(params)
        p3 = fwd_engine(setup, CSA(margin_lag=3)).profile(params)
        assert p3.epe() > p1.epe()

    def test_one_way_csa_only_helps(self, setup, params):
        prof = engine(setup, CSA(threshold=0.0, threshold_own=np.inf,
                                 margin_lag=1)).profile(params)
        assert np.all(prof.ee <= prof.ee_gross + 1e-15)
        assert np.all(prof.collateral_benefit >= -1e-15)

    def test_independent_amount_reduces_ee(self, setup, params, gross):
        prof = engine(setup, CSA(threshold=np.inf, threshold_own=np.inf,
                                 independent_amount=0.01,
                                 margin_lag=1)).profile(params)
        assert np.all(prof.ee <= gross.ee + 1e-15)
        assert np.max(prof.ee) < np.max(gross.ee)
        assert np.min(prof.ene) < np.min(gross.ene)

    def test_threshold_bounds_the_benefit(self, setup, params, gross_fwd):
        lo = fwd_engine(setup, CSA(threshold=0.0, threshold_own=np.inf,
                                   margin_lag=1)).profile(params)
        mid = fwd_engine(setup, CSA(threshold=0.005, threshold_own=np.inf,
                                    margin_lag=1)).profile(params)
        assert np.all(lo.ee <= mid.ee + 1e-15)
        assert np.all(mid.ee <= gross_fwd.ee + 1e-15)

    def test_tiny_mta_matches_full_margining(self, setup, params):
        full = fwd_engine(setup, CSA(margin_lag=1)).profile(params)
        mta = fwd_engine(setup, CSA(mta=1e-9, margin_lag=1)).profile(params)
        np.testing.assert_allclose(mta.ee, full.ee, rtol=1e-3, atol=1e-12)

    def test_cva_on_residual_is_smaller(self, setup, params, gross_fwd):
        prof = fwd_engine(setup, CSA(threshold=0.0, threshold_own=np.inf,
                                     margin_lag=1)).profile(params)
        assert (cva_from_profile(prof, hazard_rate=0.02)
                < cva_from_profile(gross_fwd, hazard_rate=0.02))

    def test_csa_with_mesh_raises_until_the_sharding_slice(self, setup):
        with pytest.raises(NotImplementedError):
            NettingSetExposureEngine(setup.model, TRADES_FWD,
                                     num_paths=2048, mesh=object(),
                                     csa=CSA(margin_lag=1), device=CPU)

    def test_collateral_benefit_requires_csa(self, gross):
        with pytest.raises(ValueError, match="CSA"):
            gross.collateral_benefit

    def test_validation(self, setup):
        with pytest.raises(ValueError, match="thresholds"):
            CSA(threshold=-1.0)
        with pytest.raises(ValueError, match="mta"):
            CSA(mta=-0.1)
        with pytest.raises(ValueError, match="margin_lag"):
            CSA(margin_lag=-1)
        with pytest.raises(TypeError, match="CSA"):
            engine(setup, csa={"threshold": 0.0})

    def test_cva_deltas_guarded_under_csa(self, setup, params):
        eng = engine(setup, CSA(margin_lag=1))
        with pytest.raises(NotImplementedError, match="UNCOLLATERALIZED"):
            eng.cva_forward_deltas(params, hazard_rate=0.02)


class TestFVA:
    def test_zero_spread_zero(self, gross):
        assert fva_from_profile(gross, 0.0) == 0.0

    def test_matches_hand_computed_rectangle_rule(self, gross):
        t = gross.times
        dt = np.diff(np.concatenate([[0.0], t]))
        sb, sl, hc, ho = 0.01, 0.004, 0.02, 0.01
        surv = np.exp(-(hc + ho) * t)
        expect = (np.sum(sb * gross.ee * surv * dt)
                  - np.sum(sl * (-gross.ene) * surv * dt))
        got = fva_from_profile(gross, sb, sl, counterparty_hazard_rate=hc,
                               own_hazard_rate=ho)
        np.testing.assert_allclose(got, expect, rtol=1e-12)

    def test_symmetric_spread_prices_the_forward_value(self, gross):
        s = 0.007
        dt = np.diff(np.concatenate([[0.0], gross.times]))
        expect = s * np.sum((gross.ee + gross.ene) * dt)
        np.testing.assert_allclose(fva_from_profile(gross, s), expect,
                                   rtol=1e-12)

    def test_survival_weighting_shrinks_magnitude(self, gross):
        base = fva_from_profile(gross, 0.01, 0.0)
        weighted = fva_from_profile(gross, 0.01, 0.0,
                                    counterparty_hazard_rate=0.05)
        assert 0.0 < weighted < base

    def test_per_date_spreads(self, gross):
        s = np.linspace(0.01, 0.002, gross.times.shape[0])
        dt = np.diff(np.concatenate([[0.0], gross.times]))
        np.testing.assert_allclose(fva_from_profile(gross, s, 0.0),
                                   np.sum(s * gross.ee * dt), rtol=1e-12)

    def test_collateral_shrinks_funding(self, setup, params, gross_fwd):
        prof = fwd_engine(setup, CSA(threshold=0.0, threshold_own=np.inf,
                                     margin_lag=1)).profile(params)
        assert (fva_from_profile(prof, 0.01, 0.0)
                < fva_from_profile(gross_fwd, 0.01, 0.0))

    def test_bilateral_and_dva_on_the_engine_profile(self, gross):
        assert bilateral_cva_from_profile(gross, 0.02, 0.01) == \
            pytest.approx(cva_from_profile(gross, 0.02)
                          - dva_from_profile(gross, 0.01), rel=1e-12)
        assert isinstance(gross, ExposureProfile)


class TestDynamicIM:
    @pytest.fixture(scope="class")
    def im(self, setup, params):
        return engine(setup).im_profile(params, quantile=0.99,
                                        mpr=14.0 / 365.0)

    def test_im_nonnegative(self, im):
        assert np.all(im.expected_im >= 0.0)
        assert np.all(im.expected_im_tmoney >= 0.0)
        assert im.peak_im() > 0.0

    def test_discounting_follows_the_curve(self, setup, im):
        df = setup.model.discount_curve.get_discount_factor(im.times)
        np.testing.assert_allclose(im.expected_im,
                                   im.expected_im_tmoney * df, rtol=5e-3)
        assert np.all((df > 1.0) == (im.expected_im
                                     > im.expected_im_tmoney))

    def test_monotone_in_quantile(self, setup, params):
        eng = engine(setup)
        lo = eng.im_profile(params, quantile=0.95)
        hi = eng.im_profile(params, quantile=0.99)
        assert np.all(hi.expected_im >= lo.expected_im - 1e-15)
        ratio = NormalDist().inv_cdf(0.99) / NormalDist().inv_cdf(0.95)
        np.testing.assert_allclose(hi.expected_im, lo.expected_im * ratio,
                                   rtol=1e-10)

    def test_brownian_scaling_in_mpr(self, setup, params):
        eng = engine(setup)
        a = eng.im_profile(params, mpr=10.0 / 365.0)
        b = eng.im_profile(params, mpr=40.0 / 365.0)
        np.testing.assert_allclose(b.expected_im, a.expected_im * 2.0,
                                   rtol=1e-10)

    def test_clean_pnl_vanishes_without_volatility(self, setup, params):
        eng = engine(setup)
        dead = eng.im_profile(np.asarray(params, dtype=np.float64) * 1e-6)
        live = eng.im_profile(params)
        assert np.max(dead.expected_im_tmoney) \
            < 1e-3 * np.max(live.expected_im_tmoney)

    def test_mva_matches_hand_computed(self, im):
        s, hc = 0.008, 0.03
        expect = np.sum(s * im.expected_im * np.exp(-hc * im.times)
                        * im.dts)
        got = mva_from_im_profile(im, s, counterparty_hazard_rate=hc)
        np.testing.assert_allclose(got, expect, rtol=1e-12)

    def test_mva_method_consistent(self, setup, params, im):
        np.testing.assert_allclose(engine(setup).mva(params, 0.008),
                                   mva_from_im_profile(im, 0.008),
                                   rtol=1e-12)

    def test_validation(self, setup, params):
        eng = engine(setup)
        with pytest.raises(ValueError, match="quantile"):
            eng.im_profile(params, quantile=0.4)
        with pytest.raises(ValueError, match="mpr"):
            eng.im_profile(params, mpr=0.0)
        with pytest.raises(ValueError, match="basis_degree"):
            eng.im_profile(params, basis_degree=0)
        sparse = engine(setup, observation_indices=[1, 3, 5])
        with pytest.raises(ValueError, match="consecutive"):
            sparse.im_profile(params)
