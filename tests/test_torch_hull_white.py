"""The port's Hull-White model (``finmath_tpu_torch/models/hull_white.py``)
against finmath_tpu's.

Tolerances against the JAX package:
* the analytic layer (``gaussian_state``, ``bond_option``, ``caplet``,
  the Jamshidian ``swaption``, ``forward_rate``): 1e-12 relative; both are
  the same host NumPy float64 arithmetic (measured: equal);
* ``calibrate_hull_white`` on ``tests/test_hull_white.py``'s case: the
  same sigmas within 1e-8 relative, rms price error < 1e-9 (measured:
  equal sigmas, the same rms, 2.1e-14);
* the simulation on the JAX stream (the normals of ``_hw_scan`` drawn in
  the test with ``jax.random`` at its key path and injected through
  ``normals=``): the ``x`` and ``Y`` histories within 32 float32 ulps of
  each step's largest magnitude (measured at most 3.5 ulps: both are
  float32 step loops with the same order of operations, and XLA's CPU
  fusion rounds ``x * e^{-a dt} + lx z`` otherwise than torch's separate
  roundings), the float64 Monte-Carlo prices within 1e-6 relative
  (measured at most 5.9e-9), the random variables within 32 ulps;
* the port's own stream (torch's generator) against Jamshidian at the
  JAX test's bound, ``max(4e-5, 0.012 an)``, and the curve fit of E[1/N]
  within 1e-3.
The histories agree whether ``jax_threefry_partitionable`` is on or off
(measured 2-4 ulps either way): the flag changes the stream, and the test
draws it at the same flag as the simulation."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.convert import hull_white_model_from_jax  # noqa: E402
from finmath_tpu_torch.models import hull_white as thw  # noqa: E402
from finmath_tpu_torch.models.curves import DiscountCurve  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

CPU = "cpu"
PILLARS = [0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 15.0, 20.0]
ZEROS = [0.010, 0.012, 0.015, 0.017, 0.020, 0.022, 0.024, 0.025, 0.0255]
DFS = list(np.exp(-np.array(ZEROS) * np.array(PILLARS)))
A, SIGMA = 0.12, 0.012
PW_SIGMAS, PW_TIMES = [0.010, 0.014, 0.008], [0.0, 2.0, 5.0]
PTS = [3.0, 3.5, 4.0, 4.5, 5.0]
# (flat or piecewise vol, steps, paths, seed): bench.py's 20-step grid and
# tests/test_hull_white.py's piecewise-vol grid
CASES = {"flat_20": (False, 20, 20_000, 7),
         "piecewise_16": (True, 16, 2_000, 3)}
CAL_SWAPTIONS = [
    {"expiry": 1.0, "payment_times": [1.5, 2.0, 2.5, 3.0], "strike": 0.015},
    {"expiry": 2.0, "payment_times": [2.5, 3.0, 3.5, 4.0], "strike": 0.018},
    {"expiry": 5.0, "payment_times": [5.5, 6.0, 6.5, 7.0], "strike": 0.022},
]


def _port_model(piecewise):
    curve = DiscountCurve(PILLARS, DFS)
    if piecewise:
        return thw.HullWhiteModel(curve, A, PW_SIGMAS, vol_times=PW_TIMES)
    return thw.HullWhiteModel(curve, A, SIGMA)


def jax_normals(seed, steps, paths, antithetic=True):
    """``_hw_scan``'s normals: ``keys = split(PRNGKey(seed), steps)``, each
    step's key split into (k1, k2), ``normal(k_i, (half,), float32)``,
    mirrored ``[z, -z]`` when antithetic; two ``[steps, paths]`` blocks."""
    import jax
    import jax.numpy as jnp

    half = paths // 2 if antithetic else paths
    z1, z2 = [], []
    for k in jax.random.split(jax.random.PRNGKey(seed), steps):
        k1, k2 = jax.random.split(k)
        for out, kk in ((z1, k1), (z2, k2)):
            z = np.asarray(jax.random.normal(kk, (half,), dtype=jnp.float32))
            out.append(np.concatenate([z, -z]) if antithetic else z)
    return np.stack(z1), np.stack(z2)


def within_ulps(a, b, n=32):
    """Rows of ``b`` within ``n`` float32 ulps of each row's largest |a|."""
    a = np.asarray(a, dtype=np.float64).reshape(-1, np.shape(a)[-1])
    b = np.asarray(b, dtype=np.float64).reshape(a.shape)
    u = np.spacing(np.max(np.abs(a), axis=1).astype(np.float32))
    return np.all(np.abs(a - b) <= n * u.astype(np.float64)[:, None])


@pytest.fixture(scope="module")
def jax_side():
    """The JAX models, simulations and the stream each simulation drew."""
    from finmath_tpu.models import hull_white as jhw
    from finmath_tpu.models.curves import DiscountCurve as JDC
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    curve = JDC(PILLARS, DFS)
    models = {False: jhw.HullWhiteModel(curve, A, SIGMA),
              True: jhw.HullWhiteModel(curve, A, PW_SIGMAS,
                                       vol_times=PW_TIMES)}
    sims, normals = {}, {}
    for name, (pw, steps, paths, seed) in CASES.items():
        sims[name] = jhw.HullWhiteSimulation(
            models[pw], JTD(initial=0.0, num_steps=steps, step=0.5),
            num_paths=paths, seed=seed, antithetic=True)
        normals[name] = jax_normals(seed, steps, paths)
    truth = jhw.HullWhiteModel(curve, A, [0.009, 0.013], vol_times=[0.0, 3.0])
    targets = [truth.swaption(s["expiry"], s["payment_times"], s["strike"])
               for s in CAL_SWAPTIONS]
    cal = jhw.calibrate_hull_white(curve, A, [0.0, 3.0], CAL_SWAPTIONS,
                                   targets)
    return dict(jhw=jhw, models=models, sims=sims, normals=normals,
                targets=targets, cal=cal)


@pytest.fixture(scope="module")
def port_sims(jax_side):
    out = {}
    for name, (pw, steps, paths, seed) in CASES.items():
        out[name] = thw.HullWhiteSimulation(
            _port_model(pw), TimeDiscretization(initial=0.0, num_steps=steps,
                                                step=0.5),
            num_paths=paths, seed=seed, normals=jax_side["normals"][name],
            device=CPU)
    return out


class TestAnalytic:
    @pytest.mark.parametrize("piecewise", [False, True])
    def test_analytic_layer_matches_jax(self, jax_side, piecewise):
        jm, tm = jax_side["models"][piecewise], _port_model(piecewise)
        for t in (0.3, 2.0, 4.7, 7.3, 12.0):
            np.testing.assert_allclose(tm.gaussian_state(t),
                                       jm.gaussian_state(t), rtol=1e-12)
            np.testing.assert_allclose(tm.forward_rate(t), jm.forward_rate(t),
                                       rtol=1e-12)
            assert tm.sigma_at(t) == jm.sigma_at(t)
        for args in ((2.0, 5.0, 0.9, True), (1.0, 3.0, 0.95, False),
                     (4.0, 4.5, 0.99, True)):
            np.testing.assert_allclose(tm.bond_option(*args),
                                       jm.bond_option(*args), rtol=1e-12)
        for k in (0.01, 0.02, 0.04):
            np.testing.assert_allclose(tm.caplet(2.0, 2.5, k),
                                       jm.caplet(2.0, 2.5, k), rtol=1e-12)
        for k, payer in ((0.015, True), (0.025, True), (0.02, False)):
            np.testing.assert_allclose(
                tm.swaption(2.0, PTS, k, payer=payer, notional=2.0),
                jm.swaption(2.0, PTS, k, payer=payer, notional=2.0),
                rtol=1e-12)

    def test_calibration_matches_jax(self, jax_side):
        res = thw.calibrate_hull_white(DiscountCurve(PILLARS, DFS), A,
                                       [0.0, 3.0], CAL_SWAPTIONS,
                                       jax_side["targets"])
        ref = jax_side["cal"]
        assert res.rms_price_error < 1e-9
        np.testing.assert_allclose(res.model.sigmas, ref.model.sigmas,
                                   rtol=1e-8)
        np.testing.assert_allclose(res.model.sigmas, [0.009, 0.013],
                                   rtol=2e-3)
        assert res.converged == ref.converged

    def test_model_from_jax_prices_the_same(self, jax_side):
        jm = jax_side["cal"].model
        tm = hull_white_model_from_jax(jm)
        np.testing.assert_array_equal(tm.sigmas, jm.sigmas)
        np.testing.assert_array_equal(tm.vol_times, jm.vol_times)
        ts = np.array([0.25, 1.0, 6.0, 25.0])
        np.testing.assert_array_equal(tm.df(ts), jm.df(ts))
        for s in CAL_SWAPTIONS:
            np.testing.assert_allclose(
                tm.swaption(s["expiry"], s["payment_times"], s["strike"]),
                jm.swaption(s["expiry"], s["payment_times"], s["strike"]),
                rtol=1e-12)


class TestSimulationOnTheJaxStream:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_histories_within_32_ulps(self, jax_side, port_sims, case):
        js, ts = jax_side["sims"][case], port_sims[case]
        assert ts._xs.dtype == torch.float32 and ts._xs.device.type == CPU
        assert within_ulps(np.asarray(js._xs), ts._xs.numpy())
        assert within_ulps(np.asarray(js._ys), ts._ys.numpy())

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_prices_within_1e6(self, jax_side, port_sims, case):
        js, ts = jax_side["sims"][case], port_sims[case]
        calls = [lambda s: s.mc_bond_price(5.0),
                 lambda s: s.mc_bond_price(8.0),
                 lambda s: s.mc_caplet_price(2.0, 2.5, 0.01),
                 lambda s: s.mc_caplet_price(3.0, 3.5, 0.02),
                 lambda s: s.mc_swaption_price(2.0, PTS, 0.02),
                 lambda s: s.mc_swaption_price(2.0, PTS, 0.015, payer=False)]
        for f in calls:
            np.testing.assert_allclose(f(ts), f(js), rtol=1e-6)

    def test_random_variables(self, jax_side, port_sims):
        js, ts = jax_side["sims"]["flat_20"], port_sims["flat_20"]
        for f in (lambda s: s.short_rate(2.5), lambda s: s.numeraire(4.0),
                  lambda s: s.bond(3.0, 7.5)):
            a, b = f(js), f(ts)
            assert b.get_filtration_time() == a.get_filtration_time()
            assert within_ulps(np.asarray(a.get_realizations())[None],
                               np.asarray(b.get_realizations())[None])


class TestOwnStream:
    @pytest.fixture(scope="class")
    def sim(self):
        return thw.HullWhiteSimulation(
            _port_model(False), TimeDiscretization(initial=0.0, num_steps=20,
                                                   step=0.5),
            num_paths=200_000, seed=7, antithetic=True, device=CPU)

    def test_swaption_vs_jamshidian(self, sim):
        model = _port_model(False)
        for k, payer in [(0.015, True), (0.025, True), (0.02, False)]:
            mc = sim.mc_swaption_price(2.0, PTS, k, payer=payer)
            an = model.swaption(2.0, PTS, k, payer=payer)
            assert abs(mc - an) < max(4e-5, 0.012 * an), (k, payer, mc, an)

    def test_caplet_and_curve(self, sim):
        model = _port_model(False)
        for k in (0.01, 0.02, 0.04):
            mc = sim.mc_caplet_price(2.0, 2.5, k)
            an = model.caplet(2.0, 2.5, k)
            assert abs(mc - an) < max(3e-5, 0.01 * an), (k, mc, an)
        assert abs(sim.mc_bond_price(10.0) / float(model.df(10.0)) - 1) < 1e-3

    def test_antithetic_mirror_and_seed(self, sim):
        half = sim.num_paths // 2
        np.testing.assert_array_equal(sim._xs[:, :half].numpy(),
                                      -sim._xs[:, half:].numpy())
        again = thw.HullWhiteSimulation(
            _port_model(False), TimeDiscretization(initial=0.0, num_steps=4,
                                                   step=0.5),
            num_paths=64, seed=7, device=CPU)
        same = thw.HullWhiteSimulation(
            _port_model(False), TimeDiscretization(initial=0.0, num_steps=4,
                                                   step=0.5),
            num_paths=64, seed=7, device=CPU)
        assert torch.equal(again._ys, same._ys)


class TestValidation:
    def test_model_errors(self):
        curve = DiscountCurve(PILLARS, DFS)
        with pytest.raises(ValueError, match="mean_reversion"):
            thw.HullWhiteModel(curve, 0.0, 0.01)
        with pytest.raises(ValueError, match="positive"):
            thw.HullWhiteModel(curve, 0.1, -0.01)
        with pytest.raises(ValueError, match="vol_times"):
            thw.HullWhiteModel(curve, 0.1, [0.01, 0.02])
        with pytest.raises(ValueError, match="vol_times"):
            thw.HullWhiteModel(curve, 0.1, [0.01, 0.02], vol_times=[0.5, 1.0])
        m = _port_model(False)
        with pytest.raises(ValueError, match="expiry"):
            m.bond_option(3.0, 2.0, 0.9)
        with pytest.raises(ValueError, match="follow"):
            m.swaption(2.0, [1.5, 3.0], 0.02)
        with pytest.raises(ValueError, match="increase"):
            m.swaption(2.0, [3.0, 2.5], 0.02)
        with pytest.raises(ValueError, match="align"):
            thw.calibrate_hull_white(m.curve, A, [0.0], CAL_SWAPTIONS, [0.1])

    def test_simulation_errors(self, port_sims):
        pw = _port_model(True)
        with pytest.raises(ValueError, match="breakpoint"):
            thw.HullWhiteSimulation(pw, TimeDiscretization(
                initial=0.0, num_steps=5, step=1.3), num_paths=8, device=CPU)
        td = TimeDiscretization(initial=0.0, num_steps=4, step=0.5)
        with pytest.raises(ValueError, match="even"):
            thw.HullWhiteSimulation(pw, td, num_paths=7, antithetic=True,
                                    device=CPU)
        with pytest.raises(ValueError, match="start at 0"):
            thw.HullWhiteSimulation(pw, TimeDiscretization([0.5, 1.0]),
                                    num_paths=8, device=CPU)
        with pytest.raises(ValueError, match="normals"):
            thw.HullWhiteSimulation(pw, td, num_paths=8, device=CPU,
                                    normals=(np.zeros((4, 8)),
                                             np.zeros((3, 8))))
        with pytest.raises(NotImplementedError):
            thw.HullWhiteSimulation(pw, td, num_paths=8, device=CPU,
                                    mesh=object())
        sim = port_sims["flat_20"]
        with pytest.raises(ValueError, match="grid"):
            sim.numeraire(0.77)
        with pytest.raises(ValueError, match="maturity"):
            sim.bond(3.0, 2.0)
