"""The port's cross-currency model (``finmath_tpu_torch/models/
cross_currency.py``) against finmath_tpu's.

Tolerances against the JAX package:
* the host layer (``_step_cov5``, ``fx_forward``, ``fx_forward_variance``,
  ``fx_option``, the simulation's quanto shifts and deterministic tables):
  1e-12 relative; the same NumPy float64 arithmetic (measured: equal);
* the simulation on the JAX stream (``_xccy_scan``'s normals drawn in the
  test at its key path and injected): the five state histories within 32
  float32 ulps of each step's largest value (measured at most 4: the
  ``[5, 5] @ [5, paths]`` shock product sums in another order in XLA's and
  in torch's float32 matrix product); the FX option prices and their
  errors, the CCS legs and the martingale diagnostics within 1e-6
  relative (measured: 1.0e-8, 2.5e-10, 1.4e-10); the random variables
  within 32 ulps;
* the exposure engine on that stream: EE, ENE and the forward value within
  1e-6 of the largest |EE|, the standalone EE within 1e-6 relative, the PFE
  within 1e-5 relative (measured: 1.2e-9, 1.7e-9, 1.8e-7).
The rest are ``tests/test_cross_currency.py``'s cases on the port's own
stream at that file's sizes and seeds."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import cross_currency as tx  # noqa: E402
from finmath_tpu_torch.models.analytic import _norm_cdf  # noqa: E402
from finmath_tpu_torch.models.curves import DiscountCurve  # noqa: E402
from finmath_tpu_torch.models.hull_white import HullWhiteModel  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

CPU = "cpu"
T_GRID = np.arange(0.0, 21.0)
DF_D, DF_F = np.exp(-0.03 * T_GRID), np.exp(-0.01 * T_GRID)
DC_D, DC_F = DiscountCurve(T_GRID, DF_D), DiscountCurve(T_GRID, DF_F)
HW_D = HullWhiteModel(DC_D, 0.1, 0.01)
HW_F = HullWhiteModel(DC_F, 0.05, 0.008)
X0 = 1.25
# parity: (steps, step, paths, seed) and the piecewise FX vol of one case
PARITY = {"flat_20": (20, 0.5, 4_000, 5, None),
          "piecewise_12": (12, 0.5, 2_000, 17, ([0.10, 0.16], [0.0, 2.0]))}
PAY10 = tuple(np.arange(1, 11) * 1.0)
PAY5 = tuple(np.arange(1, 6) * 1.0)


def make_model(rho_df=0.3, rho_dx=-0.2, rho_fx=0.25, fx_vol=0.10,
               fx_vol_times=None, hw_d=HW_D, hw_f=HW_F):
    return tx.CrossCurrencyModel(hw_d, hw_f, X0, fx_vol, rho_df, rho_dx,
                                 rho_fx, fx_vol_times=fx_vol_times)


def xccy_stream(seed, steps, paths):
    """``_xccy_scan``'s normals ``[steps, 5, paths]``: ``split(PRNGKey(seed),
    steps)``, ``normal(k, (5, half), float32)`` mirrored along the path
    axis."""
    import jax
    import jax.numpy as jnp

    out = []
    for k in jax.random.split(jax.random.PRNGKey(seed), steps):
        z = np.asarray(jax.random.normal(k, (5, paths // 2),
                                         dtype=jnp.float32))
        out.append(np.concatenate([z, -z], axis=1))
    return np.stack(out)


def within_ulps(a, b, n=32):
    """Rows of ``b`` within ``n`` float32 ulps of each row's largest |a|."""
    a = np.asarray(a, dtype=np.float64).reshape(-1, np.shape(a)[-1])
    b = np.asarray(b, dtype=np.float64).reshape(a.shape)
    u = np.spacing(np.max(np.abs(a), axis=1).astype(np.float32))
    return np.all(np.abs(a - b) <= n * u.astype(np.float64)[:, None])


def _trades(mod):
    """A book of each trade kind: a CCS with a foreign basis, a reversed
    CCS, an FX forward."""
    return [mod.CCSTrade(PAY10, foreign_basis=0.002),
            mod.CCSTrade(PAY5, domestic_notional=0.5, receive_foreign=False),
            mod.FXForwardTrade(5.0, 1.3, notional=2.0)]


@pytest.fixture(scope="module")
def jax_side():
    from finmath_tpu.models import cross_currency as jx
    from finmath_tpu.models.curves import DiscountCurve as JDC
    from finmath_tpu.models.hull_white import HullWhiteModel as JHW
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    hw_d = JHW(JDC(T_GRID, DF_D), 0.1, 0.01)
    hw_f = JHW(JDC(T_GRID, DF_F), 0.05, 0.008)
    models, sims, normals, profiles = {}, {}, {}, {}
    for name, (steps, step, paths, seed, pw) in PARITY.items():
        vol, times = pw if pw else (0.10, None)
        models[name] = jx.CrossCurrencyModel(hw_d, hw_f, X0, vol, 0.3, -0.2,
                                             0.25, fx_vol_times=times)
        sims[name] = jx.CrossCurrencySimulation(
            models[name], JTD(initial=0.0, num_steps=steps, step=step),
            paths, seed=seed, antithetic=True)
        normals[name] = xccy_stream(seed, steps, paths)
    eng = jx.CrossCurrencyExposureEngine(sims["flat_20"], _trades(jx),
                                         quantiles=(0.05, 0.95))
    profiles["book"] = eng.profile()
    profiles["cva"] = eng.cva(0.015, 0.35)
    return dict(jx=jx, models=models, sims=sims, normals=normals,
                profiles=profiles)


def _port_model(name):
    pw = PARITY[name][4]
    vol, times = pw if pw else (0.10, None)
    return make_model(fx_vol=vol, fx_vol_times=times)


@pytest.fixture(scope="module")
def port_sims(jax_side):
    out = {}
    for name, (steps, step, paths, seed, _) in PARITY.items():
        out[name] = tx.CrossCurrencySimulation(
            _port_model(name), TimeDiscretization(initial=0.0,
                                                  num_steps=steps, step=step),
            paths, seed=seed, antithetic=True, device=CPU,
            normals=jax_side["normals"][name])
    return out


class TestHostLayerAgainstJax:
    @pytest.mark.parametrize("name", sorted(PARITY))
    def test_model_and_tables(self, jax_side, port_sims, name):
        jm, tm = jax_side["models"][name], _port_model(name)
        for t in (0.7, 2.0, 5.0, 9.5):
            np.testing.assert_allclose(tm.fx_forward(t), jm.fx_forward(t),
                                       rtol=1e-12)
            np.testing.assert_allclose(tm.fx_forward_variance(t),
                                       jm.fx_forward_variance(t), rtol=1e-12)
            for k, call in ((1.0, True), (1.25, False), (1.6, True)):
                np.testing.assert_allclose(tm.fx_option(t, k, call),
                                           jm.fx_option(t, k, call),
                                           rtol=1e-12)
        js, ts = jax_side["sims"][name], port_sims[name]
        for attr in ("_m", "_big_m", "_a_int_d", "_a_int_f", "_vx_int",
                     "_lnx_det", "_phi_f", "_c_f"):
            np.testing.assert_allclose(getattr(ts, attr), getattr(js, attr),
                                       rtol=1e-12, atol=1e-300)

    def test_step_cov5(self, jax_side):
        jx = jax_side["jx"]
        for args in ((0.1, 0.05, 0.01, 0.008, 0.1, 0.3, -0.2, 0.25, 0.5),
                     (0.02, 0.3, 0.02, 0.01, 0.2, -0.5, 0.4, 0.1, 2.0)):
            np.testing.assert_allclose(tx._step_cov5(*args),
                                       jx._step_cov5(*args), rtol=1e-12)

    def test_model_from_jax_prices_the_same(self, jax_side):
        jm = jax_side["models"]["piecewise_12"]
        tm = convert.cross_currency_model_from_jax(jm)
        np.testing.assert_array_equal(tm.fx_vols, jm.fx_vols)
        np.testing.assert_array_equal(tm.fx_vol_times, jm.fx_vol_times)
        assert (tm.rho_df, tm.rho_dx, tm.rho_fx) == (jm.rho_df, jm.rho_dx,
                                                     jm.rho_fx)
        for t, k in ((1.0, 1.2), (3.5, 1.25), (8.0, 1.4)):
            np.testing.assert_allclose(tm.fx_option(t, k), jm.fx_option(t, k),
                                       rtol=1e-12)
            np.testing.assert_allclose(tm.fx_forward_variance(t),
                                       jm.fx_forward_variance(t), rtol=1e-12)


class TestSimulationOnTheJaxStream:
    @pytest.mark.parametrize("name", sorted(PARITY))
    def test_histories_within_32_ulps(self, jax_side, port_sims, name):
        jh = np.asarray(jax_side["sims"][name]._hist)
        th = port_sims[name]._hist
        assert th.dtype == torch.float32 and th.device.type == CPU
        for c in range(5):
            assert within_ulps(jh[:, c], th[:, c].numpy()), c

    @pytest.mark.parametrize("name", sorted(PARITY))
    def test_prices_within_1e6(self, jax_side, port_sims, name):
        js, ts = jax_side["sims"][name], port_sims[name]
        for call in (True, False):
            a = js.mc_fx_option_prices(5.0, [1.0, 1.25, 1.5], is_call=call)
            b = ts.mc_fx_option_prices(5.0, [1.0, 1.25, 1.5], is_call=call)
            for x, y in zip(b, a):
                np.testing.assert_allclose(x, y, rtol=1e-6)
        pay = PAY5 if name == "piecewise_12" else PAY10
        np.testing.assert_allclose(ts.mc_ccs_legs(pay), js.mc_ccs_legs(pay),
                                   rtol=1e-6)
        np.testing.assert_allclose(ts.mc_ccs_value(pay, 2.0),
                                   js.mc_ccs_value(pay, 2.0), rtol=1e-6,
                                   atol=1e-9)
        for t, tm in ((2.0, 5.5), (5.0, 10.0)):
            da, db = js.martingale_diagnostics(t, tm), \
                ts.martingale_diagnostics(t, tm)
            assert da.keys() == db.keys()
            for key in da:
                np.testing.assert_allclose(db[key][0], da[key][0], rtol=1e-6)
                np.testing.assert_allclose(db[key][1], da[key][1], rtol=1e-12)

    def test_random_variables(self, jax_side, port_sims):
        js, ts = jax_side["sims"]["flat_20"], port_sims["flat_20"]
        for f in (lambda s: s.fx(5.0), lambda s: s.numeraire(4.0),
                  lambda s: s.bond(3.0, 7.5),
                  lambda s: s.bond(3.0, 7.5, foreign=True)):
            a, b = f(js), f(ts)
            assert b.get_filtration_time() == a.get_filtration_time()
            assert within_ulps(np.asarray(a.get_realizations())[None],
                               np.asarray(b.get_realizations())[None])

    def test_exposure_profile(self, jax_side, port_sims):
        a = jax_side["profiles"]["book"]
        eng = tx.CrossCurrencyExposureEngine(port_sims["flat_20"],
                                             _trades(tx),
                                             quantiles=(0.05, 0.95))
        b = eng.profile()
        np.testing.assert_array_equal(b.times, a.times)
        scale = np.max(np.abs(a.ee))
        for f in ("ee", "ene", "forward_value"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=0,
                                       atol=1e-6 * scale)
        np.testing.assert_allclose(b.ee_standalone, a.ee_standalone,
                                   rtol=1e-6)
        assert b.pfe.keys() == a.pfe.keys()
        for q in a.pfe:
            np.testing.assert_allclose(b.pfe[q], a.pfe[q], rtol=1e-5)
        np.testing.assert_allclose(eng.cva(0.015, 0.35),
                                   jax_side["profiles"]["cva"], rtol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_cross_currency.py's cases on the port's own stream
# ---------------------------------------------------------------------------

class TestModelValidation:
    def test_correlation_psd_guard(self):
        with pytest.raises(ValueError, match="PSD"):
            make_model(rho_df=0.9, rho_dx=0.9, rho_fx=-0.9)

    def test_inputs(self):
        with pytest.raises(ValueError, match="fx_spot"):
            tx.CrossCurrencyModel(HW_D, HW_F, -1.0, 0.1, 0.0, 0.0, 0.0)
        with pytest.raises(ValueError, match="fx_vol_times"):
            make_model(fx_vol=[0.1, 0.2])
        with pytest.raises(ValueError, match="fx_vol_times"):
            make_model(fx_vol=[0.1, 0.2], fx_vol_times=[0.5, 1.0])
        with pytest.raises(ValueError, match="positive"):
            make_model(fx_vol=-0.1)
        with pytest.raises(ValueError, match="expiry"):
            make_model().fx_forward_variance(0.0)

    def test_fx_forward(self):
        f = make_model().fx_forward(5.0)
        assert np.isclose(f, X0 * DC_F.get_discount_factor(5.0)
                          / DC_D.get_discount_factor(5.0))


class TestAnalyticOracle:
    def test_deterministic_rate_limit_is_black(self):
        tiny_d = HullWhiteModel(DC_D, 0.1, 1e-8)
        tiny_f = HullWhiteModel(DC_F, 0.05, 1e-8)
        m = make_model(hw_d=tiny_d, hw_f=tiny_f)
        t, k, sx = 5.0, 1.3, 0.10
        assert abs(m.fx_forward_variance(t) - sx * sx * t) < 5e-8
        f = float(m.fx_forward(t))
        df = float(DC_D.get_discount_factor(t))
        sp = sx * math.sqrt(t)
        d1 = (math.log(f / k) + 0.5 * sp * sp) / sp
        black = df * (f * _norm_cdf(d1) - k * _norm_cdf(d1 - sp))
        assert abs(m.fx_option(t, k) - black) < 5e-8

    def test_variance_correlation_signs(self):
        base = make_model(rho_dx=0.0, rho_fx=0.0).fx_forward_variance(5.0)
        up_dx = make_model(rho_dx=0.5, rho_fx=0.0).fx_forward_variance(5.0)
        up_fx = make_model(rho_dx=0.0, rho_fx=0.5).fx_forward_variance(5.0)
        assert up_dx > base > up_fx

    def test_piecewise_fx_vol(self):
        tiny_d = HullWhiteModel(DC_D, 0.1, 1e-8)
        tiny_f = HullWhiteModel(DC_F, 0.05, 1e-8)
        m = make_model(hw_d=tiny_d, hw_f=tiny_f, fx_vol=[0.10, 0.20],
                       fx_vol_times=[0.0, 2.0])
        assert abs(m.fx_forward_variance(5.0)
                   - (0.01 * 2.0 + 0.04 * 3.0)) < 5e-8
        assert m.fx_vol_at(1.0) == 0.10 and m.fx_vol_at(2.0) == 0.20


@pytest.fixture(scope="module")
def own_sim():
    """``tests/test_cross_currency.py``'s simulation: 150,000 antithetic
    paths, 20 semiannual steps, seed 5, on the port's stream."""
    td = TimeDiscretization(initial=0.0, num_steps=20, step=0.5)
    return tx.CrossCurrencySimulation(make_model(), td, num_paths=150_000,
                                      seed=5, antithetic=True, device=CPU)


class TestSimulation:
    def test_exact_martingales(self, own_sim):
        for t, tm in ((2.0, 7.0), (5.0, 10.0)):
            d = own_sim.martingale_diagnostics(t, tm)
            for key, (mc, an) in d.items():
                assert abs(mc / an - 1.0) < 6e-4, (key, mc, an)

    def test_fx_option_vs_closed_form(self, own_sim):
        m = own_sim.model
        strikes = [1.0, 1.25, 1.5, 1.8]
        fwd, prices, se = own_sim.mc_fx_option_prices(5.0, strikes)
        assert abs(fwd / m.fx_forward(5.0) - 1.0) < 1e-3
        for k, p, s in zip(strikes, prices, se):
            cf = m.fx_option(5.0, k)
            assert abs(p - cf) < 4.5 * s + 1e-5, (k, p, cf, s)
        _, puts, pse = own_sim.mc_fx_option_prices(5.0, strikes,
                                                   is_call=False)
        df = float(DC_D.get_discount_factor(5.0))
        for k, c, p, s1, s2 in zip(strikes, prices, puts, se, pse):
            assert abs((c - p) - df * (m.fx_forward(5.0) - k)) \
                < 4.5 * (s1 + s2) + 1e-5

    def test_eager_accessors(self, own_sim):
        fx = own_sim.fx(5.0)
        assert fx.get_filtration_time() == 5.0
        assert fx.get_average() == pytest.approx(
            float(np.mean(np.asarray(fx.get_realizations()))))
        pf = own_sim.bond(5.0, 10.0, foreign=True)
        n = own_sim.numeraire(5.0)
        v = fx.mult(pf).div(n).get_average()
        assert abs(v / (X0 * DC_F.get_discount_factor(10.0)) - 1.0) < 1e-3
        with pytest.raises(ValueError, match="not on the simulation"):
            own_sim.fx(0.3)
        with pytest.raises(ValueError, match="maturity"):
            own_sim.bond(5.0, 4.0)

    def test_ccs_par_identities(self, own_sim):
        pay = np.arange(1, 11) * 1.0
        dom, fgn = own_sim.mc_ccs_legs(pay)
        assert abs(dom - 1.0) < 5e-4
        assert abs(fgn / X0 - 1.0) < 5e-4
        assert abs(own_sim.mc_ccs_value(pay)) < 1e-3
        with pytest.raises(ValueError, match="payment_times"):
            own_sim.mc_ccs_legs([-1.0, 1.0])

    def test_antithetic_mirror_and_seed(self, own_sim):
        td = TimeDiscretization(initial=0.0, num_steps=4, step=0.5)
        a = tx.CrossCurrencySimulation(make_model(), td, num_paths=64,
                                       seed=5, antithetic=True, device=CPU)
        b = tx.CrossCurrencySimulation(make_model(), td, num_paths=64,
                                       seed=5, antithetic=True, device=CPU)
        assert torch.equal(a._hist, b._hist)
        np.testing.assert_array_equal(a._hist[:, :, :32].numpy(),
                                      -a._hist[:, :, 32:].numpy())

    def test_validation(self):
        td = TimeDiscretization(initial=0.0, num_steps=4, step=0.5)
        with pytest.raises(ValueError, match="even"):
            tx.CrossCurrencySimulation(make_model(), td, num_paths=101,
                                       antithetic=True, device=CPU)
        m = make_model(fx_vol=[0.1, 0.2], fx_vol_times=[0.0, 0.75])
        with pytest.raises(ValueError, match="breakpoint"):
            tx.CrossCurrencySimulation(m, td, num_paths=100, device=CPU)
        with pytest.raises(ValueError, match="start at 0"):
            tx.CrossCurrencySimulation(make_model(),
                                       TimeDiscretization([0.5, 1.0]),
                                       num_paths=100, device=CPU)
        with pytest.raises(ValueError, match="normals"):
            tx.CrossCurrencySimulation(make_model(), td, num_paths=8,
                                       device=CPU,
                                       normals=np.zeros((4, 4, 8)))
        with pytest.raises(NotImplementedError):
            tx.CrossCurrencySimulation(make_model(), td, num_paths=8,
                                       device=CPU, mesh=object())

    def test_default_device_raises_without_a_card(self, monkeypatch):
        monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        td = TimeDiscretization(initial=0.0, num_steps=4, step=0.5)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tx.CrossCurrencySimulation(make_model(), td, num_paths=8)


class TestCorrelationEffects:
    def test_mc_variance_tracks_rho(self):
        td = TimeDiscretization(initial=0.0, num_steps=10, step=0.5)
        out = {}
        for rho in (-0.5, 0.5):
            m = make_model(rho_dx=rho)
            sim = tx.CrossCurrencySimulation(m, td, num_paths=100_000,
                                             seed=11, antithetic=True,
                                             device=CPU)
            lnx = np.log(np.asarray(sim.fx(5.0).get_realizations(),
                                    dtype=np.float64))
            out[rho] = (float(np.var(lnx)), m.fx_forward_variance(5.0))
        for rho in (-0.5, 0.5):
            mc, cf = out[rho]
            assert abs(mc / cf - 1.0) < 0.02
        assert out[0.5][0] > out[-0.5][0]


class TestExposureEngine:
    def test_ccs_ee_matches_fx_option_oracle(self, own_sim):
        eng = tx.CrossCurrencyExposureEngine(own_sim, [tx.CCSTrade(PAY10)])
        prof = eng.profile()
        m = own_sim.model
        for t in (1.0, 5.0, 9.0):
            i = list(prof.times).index(t)
            oracle = m.fx_option(t, X0) / X0
            assert abs(prof.ee[i] / oracle - 1.0) < 6e-3, (t, prof.ee[i])
        for i, t in enumerate(prof.times):
            t_fix = float(np.floor(t + 1e-9))
            oracle = float(DC_F.get_discount_factor(t_fix)
                           - DC_D.get_discount_factor(t_fix))
            if t >= 10.0 - 1e-9:
                oracle = 0.0
            assert abs(prof.forward_value[i] - oracle) < 8e-4, (t,)
        assert np.allclose(prof.ee + prof.ene, prof.forward_value,
                           atol=1e-12)
        assert eng.cva(0.01) > 0.0

    def test_direction_and_netting(self, own_sim):
        rec = tx.CrossCurrencyExposureEngine(own_sim, [tx.CCSTrade(PAY5)])
        pay_side = tx.CrossCurrencyExposureEngine(
            own_sim, [tx.CCSTrade(PAY5, receive_foreign=False)])
        both = tx.CrossCurrencyExposureEngine(
            own_sim, [tx.CCSTrade(PAY5),
                      tx.CCSTrade(PAY5, receive_foreign=False)])
        p_r, p_p, p_b = rec.profile(), pay_side.profile(), both.profile()
        assert np.allclose(p_r.ee, -p_p.ene, atol=1e-12)
        assert np.allclose(p_b.ee, 0.0, atol=1e-12)
        assert np.all(p_b.ee_standalone[:-1] > 0.0)

    def test_fx_forward_trade_and_basis(self, own_sim):
        m = own_sim.model
        prof = tx.CrossCurrencyExposureEngine(
            own_sim, [tx.FXForwardTrade(5.0, 1.3)]).profile()
        live_oracle = X0 * float(DC_F.get_discount_factor(5.0)) \
            - 1.3 * float(DC_D.get_discount_factor(5.0))
        live = prof.times < 5.0 - 1e-9
        assert np.max(np.abs(prof.forward_value[live] - live_oracle)) < 8e-4
        assert np.allclose(prof.ee[~live], 0.0)
        i = int(np.searchsorted(prof.times, 4.5))
        oracle = m.fx_option(4.5, 1.3 * float(
            DC_D.get_discount_factor(5.0) / DC_F.get_discount_factor(5.0)))
        assert 0.0 < prof.ee[i] < 2.0 * oracle + 0.1
        base = tx.CrossCurrencyExposureEngine(
            own_sim, [tx.CCSTrade(PAY5)]).profile()
        sprd = tx.CrossCurrencyExposureEngine(
            own_sim, [tx.CCSTrade(PAY5, foreign_basis=0.005)]).profile()
        assert np.all(sprd.ee[:-1] >= base.ee[:-1] - 1e-12)
        assert sprd.ee[0] > base.ee[0]

    def test_validation(self, own_sim):
        with pytest.raises(ValueError, match="at least one"):
            tx.CrossCurrencyExposureEngine(own_sim, [])
        with pytest.raises(ValueError, match="not on the simulation"):
            tx.CrossCurrencyExposureEngine(own_sim,
                                           [tx.FXForwardTrade(5.3, 1.2)])
        with pytest.raises(ValueError, match="not on the"):
            tx.CrossCurrencyExposureEngine(own_sim, [tx.CCSTrade((1.0, 2.3))])
        with pytest.raises(ValueError, match="payment_times"):
            tx.CrossCurrencyExposureEngine(own_sim,
                                           [tx.CCSTrade((-1.0, 2.0))])
        with pytest.raises(ValueError, match="unsupported"):
            tx.CrossCurrencyExposureEngine(own_sim, ["swap"])
