"""The port's Heston model (``finmath_tpu_torch/models/heston.py``) against
finmath_tpu's, on ``tests/test_heston.py`` and ``bench.py``'s
``heston_qe_1m_x64`` parameters at a small size.

* Host layer (NumPy float64, copied): the characteristic-function prices
  within 1e-12 relative (measured: equal), the validation errors of the
  same type, and ``calibrate_heston``'s residuals and Jacobian at two
  points within 1e-12 plus a round trip over one maturity.
* ``mc_heston_european_prices`` on the JAX kernel's own Threefry draws
  (``heston.py:_mc_heston_kernel``'s key path, rebuilt here): Euler in
  float32 within 1e-6 relative (measured at most 3.8e-8); both schemes in
  float64 within 1e-10 (measured 7.6e-16). The QE step is written as XLA
  compiles the JAX kernel (``x * rsqrt(y)``, ``log(.) m / (1 - p)``); XLA's
  CPU ``rsqrt`` rounds low (mean -0.095 ulp over [0.9, 1.3]) where
  ``torch.rsqrt`` rounds to nearest, and in float32 that moves the
  martingale correction of every step the same way. With the reference's
  ``rsqrt`` in the port's step the packed prices agree within 1e-6
  (measured 1.8e-7); with torch's own, within 3e-6 (measured 1.4e-6 at the
  deepest out-of-the-money strike, where the JAX float32 engine itself sits
  1.5e-5 from its float64 oracle). No path is within 4 ulps of a regime
  switch in these runs (the count is asserted and would widen the
  envelope).
* The facade end to end on ``BrownianMotionFinmathMersenne`` (2 factors):
  the ``[steps + 1, 2, paths]`` states within 1e-6 relative of the largest
  state of their component (measured 2.6e-7 and 3.0e-7), the products on
  them within 1e-6 (measured 2.0e-8).
* The device rule and ``mesh=``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models import brownian_motion as tbm  # noqa: E402
from finmath_tpu_torch.models import calibration as tcal  # noqa: E402
from finmath_tpu_torch.models import heston as th  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)
from test_torch_fourier_bachelier import (  # noqa: E402, F401
    _raises_alike, captured_problem, jax_normal_blocks, packed_rel,
    threads_one, one_blas_thread)

CPU = "cpu"
P = dict(initial_value=100.0, risk_free_rate=0.03, v0=0.04, kappa=1.5,
         theta=0.05, xi=0.6, rho=-0.7)
KS = np.array([80.0, 90.0, 100.0, 110.0, 125.0])
T = 1.5
N, STEPS, SEED = 20_000, 16, 5
FACADE_P = dict(P, xi=0.4, rho=-0.6, theta=0.05)
F_PATHS, F_STEPS, F_SEED = 20_000, 50, 17


def jp():
    from finmath_tpu.models import heston as jh
    return jh.HestonParams(**P)


def jax_rsqrt(x):
    import jax
    import jax.numpy as jnp
    return torch.as_tensor(np.array(jax.jit(jax.lax.rsqrt)(
        jnp.asarray(x.numpy()))))


# -- host layer ------------------------------------------------------------------

@pytest.mark.parametrize("maturity", [0.25, 1.5, 15.0])
def test_characteristic_prices(maturity):
    from finmath_tpu.models import heston as jh

    for is_call in (True, False):
        np.testing.assert_allclose(
            th.heston_characteristic_prices(th.HestonParams(**P), maturity,
                                            KS, is_call),
            jh.heston_characteristic_prices(jp(), maturity, KS, is_call),
            rtol=1e-12)
    assert th.HestonParams(**P).feller_ratio == jp().feller_ratio


def test_validation_errors_alike():
    from finmath_tpu.models import heston as jh

    for call in (
            lambda m: m.HestonParams(100.0, 0.0, 0.04, 1.0, 0.04, 0.5, 1.0),
            lambda m: m.HestonParams(100.0, 0.0, -0.04, 1.0, 0.04, 0.5, 0.0),
            lambda m: m.HestonParams(0.0, 0.0, 0.04, 1.0, 0.04, 0.5, 0.0),
            lambda m: m.heston_characteristic_prices(
                m.HestonParams(**P), 0.0, KS),
            lambda m: m.heston_characteristic_prices(
                m.HestonParams(**P), 1.0, [-5.0]),
            lambda m: m.calibrate_heston(100.0, 0.03, [1.0], [KS, KS], [KS])):
        _raises_alike(lambda: call(th), lambda: call(jh))
    params = th.HestonParams(**P)
    with pytest.raises(ValueError, match="scheme"):
        th.mc_heston_european_prices(params, T, [100.0], 1000,
                                     scheme="milstein", device=CPU)
    with pytest.raises(ValueError, match="even"):
        th.mc_heston_european_prices(params, T, [100.0], 101,
                                     antithetic=True, device=CPU)
    with pytest.raises(ValueError, match="both"):
        th.mc_heston_european_prices(params, T, [100.0], 10, 2, device=CPU,
                                     normals=np.zeros((2, 10)))
    with pytest.raises(ValueError, match="shape"):
        th.mc_heston_european_prices(params, T, [100.0], 10, 2, device=CPU,
                                     scheme="euler",
                                     normals=(np.zeros((2, 9)),
                                              np.zeros((2, 9))))


def test_calibration_problem_and_round_trip(monkeypatch):
    from finmath_tpu.models import calibration as jcal
    from finmath_tpu.models import heston as jh

    mats = [0.5, 1.0, 2.0]
    strikes = [KS, KS, KS]
    with threads_one():
        targets = [jh.heston_characteristic_prices(jp(), t, k)
                   for t, k in zip(mats, strikes)]
        start = dict(initial_value=100.0, risk_free_rate=0.03, v0=0.09,
                     kappa=0.5, theta=0.09, xi=0.8, rho=-0.2)
        jr, jj = captured_problem(monkeypatch, jcal, jh.calibrate_heston,
                                  100.0, 0.03, mats, strikes, targets,
                                  x0=jh.HestonParams(**start))
        tr, tj = captured_problem(monkeypatch, tcal, th.calibrate_heston,
                                  100.0, 0.03, mats, strikes, targets,
                                  x0=th.HestonParams(**start))
        for y in (th._to_unconstrained(th.HestonParams(**start)),
                  th._to_unconstrained(th.HestonParams(**P)) + 0.05):
            np.testing.assert_allclose(tr(y), jr(y), rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(tj(y), jj(y), rtol=1e-12, atol=1e-12)
        one = (100.0, 0.03, [1.0], [KS], [targets[1]])
        got = th.calibrate_heston(*one, x0=th.HestonParams(**start),
                                  max_iterations=30)
        want = jh.calibrate_heston(*one, x0=jh.HestonParams(**start),
                                   max_iterations=30)
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    for f in ("v0", "kappa", "theta", "xi", "rho"):
        assert getattr(got.params, f) == pytest.approx(
            getattr(want.params, f), rel=1e-8)


# -- engines on the JAX draws ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_engines():
    """The JAX engines at 20,000 paths x 16 steps in float32 and float64,
    plain and antithetic, and their draws: QE splits each step key in two
    (ku, kz), uniforms in [1e-7, 1 - 1e-7]; Euler in two (z1, z2)."""
    import jax.numpy as jnp
    from finmath_tpu.models import heston as jh

    out = {}
    for scheme, kinds in (("qe", ["uniform_guarded", "normal"]),
                          ("euler", ["normal", "normal"])):
        for anti in (False, True):
            half = N // 2 if anti else N
            blocks = jax_normal_blocks(SEED, STEPS, half, 2, kinds)
            for dtype in (None, jnp.float64):
                out[scheme, anti, dtype is None] = (
                    jh.mc_heston_european_prices(
                        jp(), T, KS, N, STEPS, SEED, scheme, anti, dtype),
                    blocks)
    return out


def _port(scheme, anti, f32, blocks):
    kw = dict(uniforms=blocks[0], normals=blocks[1]) if scheme == "qe" \
        else dict(normals=tuple(blocks))
    return th.mc_heston_european_prices(
        th.HestonParams(**P), T, KS, N, STEPS, SEED, scheme, anti,
        None if f32 else torch.float64, device=CPU, **kw)


def _switch_candidates(blocks, anti):
    """Paths of the port's float32 QE run whose regime test sits within 4
    ulps of the switch (psi near 1.5, or u near p_mass): the only paths
    whose regime a last-bit gap can flip."""
    f = np.float32
    c = {k: float(x) for k, x in th._qe_constants(
        f, P["risk_free_rate"], P["v0"], P["kappa"], P["theta"], P["xi"],
        P["rho"], T / STEPS).items()}
    u_all, z_all = (torch.as_tensor(b) for b in blocks)
    if anti:
        u_all = torch.cat([u_all, 1.0 - u_all], dim=-1)
        z_all = torch.cat([z_all, -z_all], dim=-1)
    log_s = torch.full((N,), float(np.log(f(100.0))))
    v = torch.full((N,), float(f(P["v0"])))
    count = 0
    for i in range(STEPS):
        m = c["theta"] + (v - c["theta"]) * c["e_kdt"]
        psi = (v * c["c1"] + c["c2"]) / torch.clamp_min(m * m, 1e-30)
        psi_e = torch.clamp_min(psi, 1.5)
        p_mass = (psi_e - 1.0) / (psi_e + 1.0)
        near = (torch.abs(psi - 1.5) <= 4 * 1.2e-7 * 1.5) | (
            (psi > 1.5) & (torch.abs(u_all[i] - p_mass) <= 4 * 6e-8))
        count += int(near.sum())
        log_s, v = th._qe_step(log_s, v, u_all[i], z_all[i], c)
    return count


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("scheme", ["qe", "euler"])
def test_engine_on_jax_draws(jax_engines, monkeypatch, scheme, antithetic):
    want64, blocks = jax_engines[scheme, antithetic, False]
    assert packed_rel(_port(scheme, antithetic, False, blocks),
                      want64) < 1e-10
    want32, _ = jax_engines[scheme, antithetic, True]
    got32 = _port(scheme, antithetic, True, blocks)
    if scheme == "euler":
        assert packed_rel(got32, want32) < 1e-6
        return
    assert _switch_candidates(blocks, antithetic) == 0
    assert packed_rel(got32, want32) < 3e-6
    monkeypatch.setattr(torch, "rsqrt", jax_rsqrt)
    assert packed_rel(_port(scheme, antithetic, True, blocks), want32) < 1e-6


def test_port_stream_against_the_characteristic_function():
    """The port's own stream at 100,000 antithetic paths (QE at 16 steps,
    Euler at 64) against the CF within ``tests/test_heston.py``'s bounds
    widened for the smaller path count (4 standard errors of the ATM
    payoff), and E[V_T] against the CIR mean."""
    params = th.HestonParams(**P)
    cf = th.heston_characteristic_prices(params, T, KS)
    ev_cir = P["theta"] + (P["v0"] - P["theta"]) * math.exp(-P["kappa"] * T)
    for scheme, steps in (("qe", 16), ("euler", 64)):
        px, fwd, ev = th.mc_heston_european_prices(
            params, T, KS, 100_000, steps, seed=3, scheme=scheme,
            antithetic=True, device=CPU)
        np.testing.assert_allclose(px, cf, atol=0.2)
        assert abs(fwd - 100.0) < 0.25
        assert abs(ev - ev_cir) < 4e-3


# -- the object API on the Mersenne increments -----------------------------------

@pytest.fixture(scope="module")
def mersenne_pair():
    from finmath_tpu.models import brownian_motion as jbm
    from finmath_tpu.models import heston as jh
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    jtd = JTD(initial=0.0, num_steps=F_STEPS, step=1.0 / F_STEPS)
    jsim = jh.MonteCarloHestonModel(
        jtd, F_PATHS, jh.HestonParams(**FACADE_P),
        brownian=jbm.BrownianMotionFinmathMersenne(jtd, 2, F_PATHS, F_SEED))
    td = TimeDiscretization(initial=0.0, num_steps=F_STEPS,
                            step=1.0 / F_STEPS)
    tsim = th.MonteCarloHestonModel(
        td, F_PATHS, th.HestonParams(**FACADE_P),
        brownian=tbm.BrownianMotionFinmathMersenne(td, 2, F_PATHS, F_SEED,
                                                   device=CPU))
    return jsim, np.asarray(jsim.process._lazy_states()), tsim


def test_facade_states_on_mersenne_paths(mersenne_pair):
    jsim, js, tsim = mersenne_pair
    ts = tsim.process._lazy_states().numpy()
    assert ts.shape == js.shape == (F_STEPS + 1, 2, F_PATHS)
    for c in range(2):
        scale = np.abs(js[:, c]).max()
        assert np.abs(ts[:, c] - js[:, c]).max() <= 1e-6 * scale
    times = [0.5, 1.0]
    np.testing.assert_allclose(
        tsim.get_asset_values(times).numpy(),
        np.asarray(jsim.get_asset_values(times)), rtol=2e-6)
    np.testing.assert_allclose(
        tsim.get_asset_values(times, asset_index=1).numpy(),
        np.asarray(jsim.get_asset_values(times, asset_index=1)),
        atol=1e-6 * np.abs(js[:, 1]).max())


def test_facade_products_on_mersenne_paths(mersenne_pair):
    from finmath_tpu.models import black_scholes as jbs
    from finmath_tpu.models import equity_products as jep
    from finmath_tpu.models import hedging as jhd
    from finmath_tpu_torch.models import black_scholes as tbs
    from finmath_tpu_torch.models import equity_products as tep
    from finmath_tpu_torch.models import hedging as thd

    jsim, _, tsim = mersenne_pair
    times = [0.1 * (i + 1) for i in range(10)]
    for build in (lambda m: m.DigitalOption(1.0, 100.0),
                  lambda m: m.DigitalOption(1.0, 70.0, is_call=False),
                  lambda m: m.AsianOption(times, 100.0),
                  lambda m: m.BarrierOption(1.0, 100.0, 130.0, "up-out"),
                  lambda m: m.LookbackOption(1.0, "floating-call")):
        v, e = build(tep).get_value_and_error(tsim)
        jv, je = build(jep).get_value_and_error(jsim)
        assert v == pytest.approx(jv, rel=1e-6, abs=2.0 / F_PATHS)
        assert e == pytest.approx(je, rel=1e-4)
    assert tbs.EuropeanOption(1.0, 100.0).get_value(tsim) == pytest.approx(
        jbs.EuropeanOption(1.0, 100.0).get_value(jsim), rel=1e-6)
    assert thd.VarianceSwap(1.0).fair_strike(tsim) == pytest.approx(
        jhd.VarianceSwap(1.0).fair_strike(jsim), rel=1e-5)
    # the identities of tests/test_heston_facade.py on the port
    c, _ = tep.DigitalOption(1.0, 100.0).get_value_and_error(tsim)
    p, _ = tep.DigitalOption(1.0, 100.0, is_call=False) \
        .get_value_and_error(tsim)
    assert abs(c + p - math.exp(-P["risk_free_rate"])) < 1e-9
    vi, _ = tep.BarrierOption(1.0, 100.0, 130.0, "up-in") \
        .get_value_and_error(tsim)
    vo, _ = tep.BarrierOption(1.0, 100.0, 130.0, "up-out") \
        .get_value_and_error(tsim)
    ve = tbs.EuropeanOption(1.0, 100.0).get_value(tsim)
    assert abs(vi + vo - ve) < 1e-6 * ve
    with pytest.raises(NotImplementedError):
        tep.BarrierOption(1.0, 100.0, 130.0, "up-out",
                          monitoring="bridge").get_value(tsim)
    with pytest.raises(ValueError):
        tsim.get_asset_value(1.177)


def test_process_model_coefficients():
    from finmath_tpu.models import heston as jh

    rng = np.random.default_rng(3)
    state = np.stack([np.log(100.0) + 0.2 * rng.standard_normal(64),
                      0.05 * rng.standard_normal(64) + 0.03]).astype(
        np.float32)
    jm = jh.HestonModel(jh.HestonParams(**P))
    tmod = th.HestonModel(th.HestonParams(**P))
    st = torch.as_tensor(state)
    np.testing.assert_allclose(tmod.drift(0, st).numpy(),
                               np.asarray(jm.drift(0, state)), rtol=1e-6)
    np.testing.assert_allclose(tmod.factor_loadings(0, st).numpy(),
                               np.asarray(jm.factor_loadings(0, state)),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        tmod.initial_state(4, CPU).numpy(), np.asarray(jm.initial_state(4)))
    assert tmod.numeraire(2.0).get_average() == pytest.approx(
        math.exp(0.06), rel=1e-15)
    assert tmod == th.HestonModel(th.HestonParams(**P))
    assert hash(tmod) == hash(th.HestonModel(th.HestonParams(**P)))
    td = TimeDiscretization(initial=0.0, num_steps=4, step=0.25)
    m = th.MonteCarloHestonModel(td, 1_000, tmod, seed=3, device=CPU)
    assert m.get_number_of_paths() == 1_000
    assert m.get_asset_value(0.5).values.shape == (1_000,)


def test_device_rule_and_mesh(monkeypatch):
    td = TimeDiscretization(initial=0.0, num_steps=2, step=0.5)
    params = th.HestonParams(**P)
    with pytest.raises(NotImplementedError, match="mesh"):
        th.MonteCarloHestonModel(td, 8, params, mesh=object(), device=CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    for call in (lambda: th.mc_heston_european_prices(params, T, [100.0], 8,
                                                      2),
                 lambda: th.mc_heston_european_prices(params, T, [100.0], 8,
                                                      2, scheme="euler"),
                 lambda: th.MonteCarloHestonModel(td, 8, params)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
