"""The port's Dupire local-volatility model
(``finmath_tpu_torch/models/local_vol.py``) against finmath_tpu's, on
``tests/test_local_vol.py``'s surfaces at a small size.

* ``SSVISurface`` on floats (float64 Python numbers in both packages)
  within 1e-12 relative (measured: equal) and on float32 tensors within 4
  float32 ulps (measured 3, near the smile's minimum); ``validate`` and the validation errors alike.
* ``local_variance`` (nested ``torch.func.jvp``) on a grid of k in [-1, 1]
  and t in [0.01, 3], in float32, within 8 float32 ulps of the JAX nested
  ``jax.jvp`` values (measured 5, 0 and 1), for the skewed and the flat
  SSVI surface and for a ``DupireLocalVolSurface``; in float64 within
  1e-12 relative of the SSVI derivatives written in closed form here
  (measured 8.9e-16).
* ``LocalVolatilityModel``'s coefficients on a shared state: the local
  volatility within 8 ulps (measured 6), the drift within 8 ulps of sig^2; the once-a-step cache bit-equal to evaluating twice.
* ``MonteCarloLocalVolModel`` end to end on ``BrownianMotionFinmathMersenne``
  (1 factor): the states within 1e-6 of the largest log-state over all
  steps (measured 7.7e-7: the local variance's last-bit gaps feed the
  paths, at most 17 ulps on a low path), ``european_call_values``
  within 1e-6 relative (measured 5.3e-8).
* The port's own stream: the flat surface against term-vol Black-Scholes
  and the skewed surface's Gyongy round trip at the JAX tests' bounds
  widened for 50,000 paths. ``mesh=`` and the device rule."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models import brownian_motion as tbm  # noqa: E402
from finmath_tpu_torch.models import local_vol as tlv  # noqa: E402
from finmath_tpu_torch.models.analytic import (  # noqa: E402
    black_implied_volatility, black_scholes_option_value)
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)
from test_torch_fourier_bachelier import (  # noqa: E402, F401
    _raises_alike, one_blas_thread)

CPU = "cpu"
S0, R = 100.0, 0.03
SURF = dict(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65, eta=0.6,
            gamma=0.4)
FLAT = dict(sigma0=0.28, sigma_inf=0.18, tau=1.5, rho=0.0, eta=0.0)
PATHS, STEPS, SEED = 20_000, 40, 12
K_GRID = np.linspace(-1.0, 1.0, 41)
T_GRID = np.array([0.01, 0.05, 0.25, 0.5, 1.0, 1.7, 3.0])


def jlv():
    from finmath_tpu.models import local_vol
    return local_vol


def ulps32(a, b):
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def custom_w(xp):
    """A smooth SVI-like total variance in ``xp`` (torch or jax.numpy)."""
    def w(k, t):
        return 0.04 * t + 0.02 * t * xp.sqrt(k * k + 0.09) - 0.006 * t * k
    return w


# -- surfaces ---------------------------------------------------------------------

@pytest.mark.parametrize("surf", [SURF, FLAT], ids=["skew", "flat"])
def test_ssvi_surface(surf):
    import jax.numpy as jnp

    ts, js = tlv.SSVISurface(**surf), jlv().SSVISurface(**surf)
    for k, t in ((0.0, 1.0), (-0.4, 0.3), (0.7, 2.5)):
        assert ts.theta(t) == pytest.approx(float(js.theta(t)), rel=1e-12)
        assert ts.total_variance(k, t) == pytest.approx(
            float(js.total_variance(k, t)), rel=1e-12)
        assert ts.implied_volatility(k, t) == pytest.approx(
            float(js.implied_volatility(k, t)), rel=1e-12)
        assert ts.implied_volatility(np.float64(k), np.float64(t)) == \
            pytest.approx(float(js.implied_volatility(k, t)), rel=1e-12)
    k32 = K_GRID.astype(np.float32)
    for t in (0.05, 1.0):
        t32 = np.float32(t)
        got = ts.total_variance(torch.as_tensor(k32), torch.tensor(t32))
        want = js.total_variance(jnp.asarray(k32), jnp.asarray(t32))
        assert got.dtype == torch.float32
        assert ulps32(got.numpy(), want).max() <= 4
    ts.validate(10.0)
    _raises_alike(lambda: tlv.SSVISurface(0.2, 0.2, 1.0, -0.9, 8.0)
                  .validate(10.0),
                  lambda: jlv().SSVISurface(0.2, 0.2, 1.0, -0.9, 8.0)
                  .validate(10.0))


def test_validation_errors_alike():
    for call in (lambda m: m.SSVISurface(0.2, 0.2, 1.0, 1.5, 0.1),
                 lambda m: m.SSVISurface(-0.2, 0.2, 1.0, 0.0, 0.1),
                 lambda m: m.SSVISurface(0.2, 0.2, -1.0, 0.0, 0.1),
                 lambda m: m.SSVISurface(0.2, 0.2, 1.0, 0.0, -0.1),
                 lambda m: m.SSVISurface(0.2, 0.2, 1.0, 0.0, 0.1, gamma=1.0)):
        _raises_alike(lambda: call(tlv), lambda: call(jlv()))


# -- local variance ---------------------------------------------------------------

def _surfaces():
    import jax.numpy as jnp

    return {
        "skew": (tlv.SSVISurface(**SURF), jlv().SSVISurface(**SURF)),
        "flat": (tlv.SSVISurface(**FLAT), jlv().SSVISurface(**FLAT)),
        "dupire": (tlv.DupireLocalVolSurface(w=custom_w(torch)),
                   jlv().DupireLocalVolSurface(w=custom_w(jnp))),
    }


@pytest.mark.parametrize("name", ["skew", "flat", "dupire"])
def test_local_variance_against_jax(name):
    import jax.numpy as jnp

    tsurf, jsurf = _surfaces()[name]
    k32 = torch.as_tensor(K_GRID.astype(np.float32))
    worst = 0
    for t in T_GRID:
        t32 = np.float32(t)
        got = tlv.local_variance(tsurf, k32, torch.tensor(t32))
        want = jlv().local_variance(jsurf, jnp.asarray(k32.numpy()),
                                    jnp.asarray(t32))
        assert got.dtype == torch.float32
        worst = max(worst, int(ulps32(got.numpy(), want).max()))
    assert worst <= 8
    # t as an array broadcast against k
    kk, tt = np.meshgrid(K_GRID, T_GRID)
    got = tlv.local_variance(tsurf, torch.as_tensor(kk.astype(np.float32)),
                             torch.as_tensor(tt.astype(np.float32)))
    want = jlv().local_variance(jsurf, jnp.asarray(kk.astype(np.float32)),
                                jnp.asarray(tt.astype(np.float32)))
    assert ulps32(got.numpy(), want).max() <= 8


def _ssvi_local_variance_closed_form(s, k, t, floor=0.05):
    """Dupire's local variance of an SSVI surface with its derivatives in
    closed form, float64."""
    s0, si = s.sigma0 ** 2, s.sigma_inf ** 2
    th = si * t + (s0 - si) * s.tau * (1.0 - np.exp(-t / s.tau))
    th_t = si + (s0 - si) * np.exp(-t / s.tau)
    phi = s.eta * th ** (-s.gamma)
    phi_t = -s.gamma * s.eta * th ** (-s.gamma - 1.0) * th_t
    x = phi * k
    root = np.sqrt((x + s.rho) ** 2 + 1.0 - s.rho ** 2)
    g = 1.0 + s.rho * x + root
    g1 = s.rho + (x + s.rho) / root
    g2 = (1.0 - s.rho ** 2) / root ** 3
    w = 0.5 * th * g
    wk = 0.5 * th * phi * g1
    wkk = 0.5 * th * phi * phi * g2
    wt = 0.5 * th_t * g + 0.5 * th * g1 * k * phi_t
    kw = k / w
    denom = (1.0 - kw * wk + 0.25 * (-0.25 - 1.0 / w + kw * kw) * wk * wk
             + 0.5 * wkk)
    return np.maximum(wt, 0.0) / np.maximum(denom, floor)


@pytest.mark.parametrize("surf", [SURF, FLAT], ids=["skew", "flat"])
def test_local_variance_float64_closed_form(surf):
    s = tlv.SSVISurface(**surf)
    kk, tt = np.meshgrid(K_GRID, T_GRID)
    got = tlv.local_variance(s, torch.as_tensor(kk), torch.as_tensor(tt))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(),
                               _ssvi_local_variance_closed_form(s, kk, tt),
                               rtol=1e-12)
    if surf is FLAT:    # strike-flat: v_loc = theta'(t)
        th_t = (surf["sigma_inf"] ** 2 + (surf["sigma0"] ** 2
                - surf["sigma_inf"] ** 2) * np.exp(-tt / surf["tau"]))
        np.testing.assert_allclose(got.numpy(), th_t, rtol=1e-12)


# -- the model and the facade -------------------------------------------------------

def _grid():
    return TimeDiscretization(initial=0.0, num_steps=STEPS, step=1.0 / STEPS)


def test_model_coefficients_and_cache():
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    jtd = JTD(initial=0.0, num_steps=STEPS, step=1.0 / STEPS)
    jm = jlv().LocalVolatilityModel(S0, R, jlv().SSVISurface(**SURF), jtd,
                                    dividend_yield=0.01)
    tm = tlv.LocalVolatilityModel(S0, R, tlv.SSVISurface(**SURF), _grid(),
                                  dividend_yield=0.01)
    state = (math.log(S0) + 0.3 * np.random.default_rng(2).standard_normal(
        (1, 500))).astype(np.float32)
    for i in (0, 7, STEPS - 1):
        st = torch.as_tensor(state)
        sig = tm.factor_loadings(i, st).numpy()
        assert ulps32(sig, np.asarray(jm.factor_loadings(i, state))).max() \
            <= 8
        # the drift r - q - sig^2 / 2 cancels: within ulps of sig^2
        np.testing.assert_allclose(tm.drift(i, st).numpy(),
                                   np.asarray(jm.drift(i, state)),
                                   rtol=0, atol=8 * 2.0 ** -24 * np.max(
                                       sig * sig))
    np.testing.assert_array_equal(np.asarray(jm._coeff_times),
                                  tm._coeff_times)
    assert tm.t_floor == jm.t_floor
    assert tm == tlv.LocalVolatilityModel(S0, R, tlv.SSVISurface(**SURF),
                                          _grid(), dividend_yield=0.01)
    td = _grid()
    runs = []
    for cached in (True, False):
        model = tlv.LocalVolatilityModel(S0, R, tlv.SSVISurface(**SURF), td)
        if not cached:      # evaluate for the drift and again for the loadings
            model._local_vol = model._compute_local_vol
        sim = tlv.MonteCarloLocalVolModel(td, 2_000, model, seed=3,
                                          device=CPU)
        runs.append(sim.process._lazy_states())
    assert torch.equal(runs[0], runs[1])


@pytest.fixture(scope="module")
def mersenne_pair():
    from finmath_tpu.models import brownian_motion as jbm
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    jtd = JTD(initial=0.0, num_steps=STEPS, step=1.0 / STEPS)
    jsim = jlv().MonteCarloLocalVolModel(
        jtd, PATHS, jlv().LocalVolatilityModel(S0, R,
                                               jlv().SSVISurface(**SURF),
                                               jtd),
        brownian=jbm.BrownianMotionFinmathMersenne(jtd, 1, PATHS, SEED))
    td = _grid()
    tsim = tlv.MonteCarloLocalVolModel(
        td, PATHS, tlv.LocalVolatilityModel(S0, R, tlv.SSVISurface(**SURF),
                                            td),
        brownian=tbm.BrownianMotionFinmathMersenne(td, 1, PATHS, SEED,
                                                   device=CPU))
    return jsim, np.asarray(jsim.process._lazy_states()), tsim


def test_facade_on_mersenne_paths(mersenne_pair):
    jsim, js, tsim = mersenne_pair
    ts = tsim.process._lazy_states().numpy()
    assert ts.shape == js.shape == (STEPS + 1, 1, PATHS)
    assert np.abs(ts - js).max() <= 1e-6 * np.abs(js).max()
    strikes, expiries = [80.0, 90.0, 100.0, 110.0, 120.0], [0.5, 1.0]
    got = tlv.european_call_values(tsim, strikes, expiries)
    want = jlv().european_call_values(jsim, strikes, expiries)
    assert got.shape == want.shape == (2, 5, 2) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_port_stream_round_trip():
    """The port's own stream at 50,000 paths: the flat surface within 4
    standard errors + 1e-3 of term-vol Black-Scholes, and the skewed
    surface's Black-implied vols within 0.006 of the input (the JAX test's
    0.004 at 200,000 paths, widened for the fourfold standard error)."""
    td = TimeDiscretization(initial=0.0, num_steps=50, step=0.02)
    flat = tlv.SSVISurface(**FLAT)
    sim = tlv.MonteCarloLocalVolModel(
        td, 50_000, tlv.LocalVolatilityModel(S0, R, flat, td), seed=11,
        device=CPU)
    out = tlv.european_call_values(sim, [80.0, 100.0, 125.0], [1.0])
    sig = math.sqrt(flat.theta(1.0))
    for j, k in enumerate([80.0, 100.0, 125.0]):
        v, e = out[0, j]
        an = black_scholes_option_value(S0, R, sig, 1.0, k)
        assert abs(v - an) < 4 * e + 1e-3 * an
    skew = tlv.SSVISurface(**SURF)
    sim = tlv.MonteCarloLocalVolModel(
        td, 50_000, tlv.LocalVolatilityModel(S0, R, skew, td), seed=12,
        device=CPU)
    strikes = [80.0, 90.0, 100.0, 110.0, 120.0]
    out = tlv.european_call_values(sim, strikes, [1.0])
    fwd, df = S0 * math.exp(R), math.exp(-R)
    for j, k in enumerate(strikes):
        iv = black_implied_volatility(fwd, k, 1.0, out[0, j, 0] / df)
        assert abs(iv - skew.implied_volatility(math.log(k / fwd), 1.0)) \
            < 0.006


def test_device_rule_and_mesh(monkeypatch):
    td = TimeDiscretization(initial=0.0, num_steps=2, step=0.5)
    model = tlv.LocalVolatilityModel(S0, R, tlv.SSVISurface(**SURF), td)
    with pytest.raises(NotImplementedError, match="mesh"):
        tlv.MonteCarloLocalVolModel(td, 8, model, mesh=object(), device=CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlv.MonteCarloLocalVolModel(td, 8, model)
