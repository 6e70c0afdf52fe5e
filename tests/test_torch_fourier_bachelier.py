"""The port's Fourier layer, the Variance-Gamma closed form, Bachelier and
displaced lognormal (``finmath_tpu_torch/models/{fourier,variance_gamma,bachelier}.py``)
against finmath_tpu's, on ``tests/test_fourier_models.py``'s parameters.

* Host layers (NumPy float64, copied): every characteristic-function price,
  the VG Fourier prices and the Bachelier and displaced closed forms within
  1e-12 relative of the JAX ones (measured: equal); every validation error
  of the same type.
* The Bachelier and displaced engines on the JAX kernels' own Threefry
  normals, rebuilt here from their key path and injected (``normals=``):
  the packed ``[forward, prices]`` within 1e-6 relative (measured at most
  9.2e-8).
* The port's own streams against the closed forms.
* ``convert.equity_model_from_jax`` on every JAX object of the slice, and
  the device rule."""

import contextlib
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import bachelier as tba  # noqa: E402
from finmath_tpu_torch.models import fourier as tfo  # noqa: E402
from finmath_tpu_torch.models import heston as th  # noqa: E402
from finmath_tpu_torch.models import merton as tm  # noqa: E402
from finmath_tpu_torch.models import variance_gamma as tvg  # noqa: E402

CPU = "cpu"
STRIKES = np.array([80.0, 90.0, 100.0, 110.0, 125.0])
T = 1.25
VG = dict(initial_value=100.0, risk_free_rate=0.04, sigma=0.18,
          theta=-0.14, nu=0.25)
MERTON = dict(initial_value=100.0, risk_free_rate=0.05, volatility=0.2,
              jump_intensity=0.6, jump_size_mean=-0.15, jump_size_std=0.25)
HESTON = dict(initial_value=100.0, risk_free_rate=0.03, v0=0.04, kappa=1.5,
              theta=0.05, xi=0.6, rho=-0.7)
BACH = dict(initial_value=100.0, risk_free_rate=0.03, volatility=15.0)
DISP = dict(initial_value=100.0, risk_free_rate=0.03, volatility=0.2,
            displacement=30.0)


def threads_one():
    """NumPy's BLAS on one thread: the host calibrations contend with the
    other test workers otherwise."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        return contextlib.nullcontext()
    return threadpool_limits(1)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """The module's host NumPy on one BLAS thread (the test workers share
    the cores; a file that imports this fixture gets it too)."""
    with threads_one():
        yield


class CaptureLM:
    """A stand-in for ``LevenbergMarquardt`` that records the residual and
    Jacobian functions a calibration builds and returns its start."""

    last = None

    def __init__(self, residual_fn, jacobian_fn, **kwargs):
        CaptureLM.last = (residual_fn, jacobian_fn)

    def run(self, x0):
        return SimpleNamespace(parameters=np.asarray(x0, dtype=np.float64),
                               iterations=0, converged=False)


def captured_problem(monkeypatch, module, calibrate, *args, **kwargs):
    """(residuals, jacobian) that ``calibrate`` builds, ``module`` being
    its package's ``calibration`` module."""
    monkeypatch.setattr(module, "LevenbergMarquardt", CaptureLM)
    calibrate(*args, **kwargs)
    monkeypatch.undo()
    return CaptureLM.last


def jax_normal_blocks(seed, steps, half, splits, kinds):
    """The JAX engines' per-step draws: ``split(PRNGKey(seed), steps)``,
    each step key split in ``splits`` and drawn as ``kinds`` ("normal",
    "uniform" in [0, 1), "uniform_guarded" in [1e-7, 1 - 1e-7], or
    ("gamma", shape)); one ``[steps, half]`` float32 block per kind."""
    import jax
    import jax.numpy as jnp

    blocks = [[] for _ in kinds]
    for key in jax.random.split(jax.random.PRNGKey(seed), steps):
        subs = jax.random.split(key, splits)
        for j, kind in enumerate(kinds):
            if kind == "normal":
                x = jax.random.normal(subs[j], (half,), dtype=jnp.float32)
            elif kind == "uniform":
                x = jax.random.uniform(subs[j], (half,), dtype=jnp.float32)
            elif kind == "uniform_guarded":
                x = jax.random.uniform(subs[j], (half,), dtype=jnp.float32,
                                       minval=1e-7, maxval=1.0 - 1e-7)
            else:
                x = jax.random.gamma(subs[j], jnp.asarray(kind[1],
                                                          jnp.float32),
                                     (half,), dtype=jnp.float32)
            blocks[j].append(np.asarray(x))
    return [np.stack(b) for b in blocks]


def packed_rel(port, ref):
    """The largest relative gap of two ``(prices, forward, ...)`` tuples."""
    a = np.concatenate([np.atleast_1d(x) for x in port])
    b = np.concatenate([np.atleast_1d(x) for x in ref])
    return float(np.max(np.abs(a - b) / np.abs(b)))


# -- host layers ---------------------------------------------------------------

def _cf_cases():
    from finmath_tpu.models import fourier as jfo
    from finmath_tpu.models import heston as jh
    from finmath_tpu.models import merton as jm

    return {
        "black_scholes": (jfo.black_scholes_cf(100.0, 0.04, 0.25, T),
                          tfo.black_scholes_cf(100.0, 0.04, 0.25, T), 0.04),
        "merton": (jfo.merton_cf(jm.MertonParams(**MERTON), T),
                   tfo.merton_cf(tm.MertonParams(**MERTON), T), 0.05),
        "heston": (jfo.heston_cf(jh.HestonParams(**HESTON), T),
                   tfo.heston_cf(th.HestonParams(**HESTON), T), 0.03),
        "variance_gamma": (
            jfo.variance_gamma_cf(100.0, 0.04, 0.18, -0.14, 0.25, T),
            tfo.variance_gamma_cf(100.0, 0.04, 0.18, -0.14, 0.25, T), 0.04),
    }


@pytest.mark.parametrize("name", ["black_scholes", "merton", "heston",
                                  "variance_gamma"])
@pytest.mark.parametrize("is_call", [True, False])
def test_characteristic_function_prices(name, is_call):
    from finmath_tpu.models import fourier as jfo

    jcf, tcf, r = _cf_cases()[name]
    u = np.linspace(-3.0, 40.0, 57) - 0.5j
    np.testing.assert_allclose(tcf(u), jcf(u), rtol=1e-12)
    got = tfo.european_call_from_cf(tcf, r, T, STRIKES, is_call=is_call,
                                    initial_value=100.0)
    want = jfo.european_call_from_cf(jcf, r, T, STRIKES, is_call=is_call,
                                     initial_value=100.0)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_closed_forms():
    from finmath_tpu.models import bachelier as jba
    from finmath_tpu.models import variance_gamma as jvg

    pairs = [
        (tvg.vg_analytic_prices(tvg.VarianceGammaParams(**VG), T, STRIKES),
         jvg.vg_analytic_prices(jvg.VarianceGammaParams(**VG), T, STRIKES)),
        (tvg.vg_analytic_prices(tvg.VarianceGammaParams(**VG), T, STRIKES,
                                is_call=False),
         jvg.vg_analytic_prices(jvg.VarianceGammaParams(**VG), T, STRIKES,
                                is_call=False)),
        ([tvg.VarianceGammaParams(**VG).omega],
         [jvg.VarianceGammaParams(**VG).omega]),
    ]
    ks = np.array([-50.0, 0.1, 80.0, 100.0, 120.0])
    for is_call in (True, False):
        pairs.append((tba.bachelier_analytic_price(
            tba.BachelierParams(**BACH), T, ks, is_call),
            jba.bachelier_analytic_price(jba.BachelierParams(**BACH), T, ks,
                                         is_call)))
        pairs.append((tba.displaced_analytic_price(
            tba.DisplacedLognormalParams(**DISP), T, STRIKES, is_call),
            jba.displaced_analytic_price(
                jba.DisplacedLognormalParams(**DISP), T, STRIKES, is_call)))
    for r in (0.0, 1e-13, 0.03):
        p = dict(BACH, risk_free_rate=r)
        pairs.append(([tba.bachelier_terminal_std(tba.BachelierParams(**p),
                                                  2.0)],
                      [jba.bachelier_terminal_std(jba.BachelierParams(**p),
                                                  2.0)]))
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-12)


def _raises_alike(port_call, jax_call):
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(type(want.value)):
        port_call()


def test_validation_errors_alike():
    from finmath_tpu.models import bachelier as jba
    from finmath_tpu.models import fourier as jfo
    from finmath_tpu.models import variance_gamma as jvg

    def bad_cf(u):
        u = np.asarray(u, dtype=np.complex128)
        return np.exp(1j * u * math.log(100.0) - 0.5 * 0.04 * u * u)

    cases = [
        (lambda m: m.european_call_from_cf(bad_cf, 0.04, T, [100.0],
                                           initial_value=100.0), tfo, jfo),
        (lambda m: m.european_call_from_cf(m.black_scholes_cf(
            100.0, 0.0, 0.2, 1.0), 0.0, 0.0, [100.0]), tfo, jfo),
        (lambda m: m.european_call_from_cf(m.black_scholes_cf(
            100.0, 0.0, 0.2, 1.0), 0.0, 1.0, [-1.0]), tfo, jfo),
        (lambda m: m.variance_gamma_cf(100.0, 0.0, 2.0, 0.5, 1.0, 1.0),
         tfo, jfo),
        (lambda m: m.VarianceGammaParams(100.0, 0.0, sigma=2.0, theta=0.5,
                                         nu=1.0), tvg, jvg),
        (lambda m: m.VarianceGammaParams(100.0, 0.0, sigma=-0.2, theta=0.1,
                                         nu=0.2), tvg, jvg),
        (lambda m: m.VarianceGammaParams(-1.0, 0.0, sigma=0.2, theta=0.1,
                                         nu=0.2), tvg, jvg),
        (lambda m: m.BachelierParams(100.0, 0.0, volatility=0.0), tba, jba),
        (lambda m: m.DisplacedLognormalParams(10.0, 0.0, 0.2,
                                              displacement=-20.0), tba, jba),
        (lambda m: m.DisplacedLognormalParams(10.0, 0.0, -0.2,
                                              displacement=20.0), tba, jba),
        (lambda m: m.displaced_analytic_price(m.DisplacedLognormalParams(
            100.0, 0.0, 0.2, displacement=10.0), T, [-20.0]), tba, jba),
        (lambda m: m.calibrate_variance_gamma(100.0, 0.0, [1.0], [[100.0]] * 2,
                                              [[1.0]]), tvg, jvg),
    ]
    for call, port, ref in cases:
        _raises_alike(lambda: call(port), lambda: call(ref))
    for call in (lambda: tba.mc_bachelier_european_prices(
                     tba.BachelierParams(**BACH), T, [100.0], num_paths=101,
                     antithetic=True, device=CPU),
                 lambda: tba.mc_displaced_european_prices(
                     tba.DisplacedLognormalParams(**DISP), T, [100.0],
                     num_paths=101, antithetic=True, device=CPU),
                 lambda: tvg.mc_vg_european_prices(
                     tvg.VarianceGammaParams(**VG), T, [100.0], num_paths=101,
                     antithetic=True, device=CPU)):
        with pytest.raises(ValueError, match="even"):
            call()


# -- engines on the JAX draws --------------------------------------------------

@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("family", ["bachelier", "displaced"])
def test_gaussian_engines_on_jax_normals(family, antithetic):
    import jax
    import jax.numpy as jnp
    from finmath_tpu.models import bachelier as jba

    n, seed = 40_000, 6
    ks = np.array([-20.0, 80.0, 100.0, 120.0]) if family == "bachelier" \
        else STRIKES
    # bachelier.py:_mc_bachelier_kernel / _mc_displaced_kernel: one
    # normal(PRNGKey(seed), (half,)) draw
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                     (n // 2 if antithetic else n,),
                                     dtype=jnp.float32))
    if family == "bachelier":
        want = jba.mc_bachelier_european_prices(
            jba.BachelierParams(**BACH), T, ks, n, seed, antithetic)
        got = tba.mc_bachelier_european_prices(
            tba.BachelierParams(**BACH), T, ks, n, seed, antithetic,
            device=CPU, normals=z)
    else:
        want = jba.mc_displaced_european_prices(
            jba.DisplacedLognormalParams(**DISP), T, ks, n, seed, antithetic)
        got = tba.mc_displaced_european_prices(
            tba.DisplacedLognormalParams(**DISP), T, ks, n, seed, antithetic,
            device=CPU, normals=z)
    assert packed_rel(got, want) < 1e-6


def test_port_stream_prices():
    """The port's own streams against the closed forms (4 standard errors
    of each price, from the payoff's spread at 100,000 antithetic paths)."""
    from finmath_tpu_torch.models.analytic import black_scholes_option_value

    vp = tvg.VarianceGammaParams(**VG)
    px, fwd = tvg.mc_vg_european_prices(vp, T, STRIKES, 100_000, 8, seed=2,
                                        antithetic=True, device=CPU)
    ref = tvg.vg_analytic_prices(vp, T, STRIKES)
    se = 0.6 * 100.0 * math.sqrt((vp.sigma ** 2 + vp.theta ** 2 * vp.nu)
                                 * T / 100_000)
    assert np.all(np.abs(px - ref) < 4 * se)
    assert abs(fwd - 100.0) < 4 * se
    bp = tba.BachelierParams(**BACH)
    px, fwd = tba.mc_bachelier_european_prices(bp, T, [90.0, 100.0], 100_000,
                                               seed=6, antithetic=True,
                                               device=CPU)
    se = tba.bachelier_terminal_std(bp, T) / math.sqrt(100_000)
    np.testing.assert_allclose(px, tba.bachelier_analytic_price(
        bp, T, [90.0, 100.0]), atol=4 * se)
    dp = tba.DisplacedLognormalParams(**DISP)
    px, _ = tba.mc_displaced_european_prices(dp, T, STRIKES, 100_000, seed=8,
                                             antithetic=True, device=CPU)
    se = 130.0 * 0.2 * math.sqrt(T / 100_000)
    np.testing.assert_allclose(px, tba.displaced_analytic_price(dp, T,
                                                                STRIKES),
                               atol=4 * se)
    # zero displacement is Black-Scholes
    p0 = tba.DisplacedLognormalParams(100.0, 0.04, 0.25, displacement=1e-9)
    np.testing.assert_allclose(
        tba.displaced_analytic_price(p0, T, STRIKES),
        [black_scholes_option_value(100.0, 0.04, 0.25, T, k)
         for k in STRIKES], rtol=1e-5)


# -- calibration ---------------------------------------------------------------

# -- convert --------------------------------------------------------------------

def test_equity_model_from_jax():
    """Each JAX object of the slice converts to the port's class with the
    same fields; the port's closed forms on it equal the JAX ones."""
    from finmath_tpu.models import bachelier as jba
    from finmath_tpu.models import bates as jb
    from finmath_tpu.models import heston as jh
    from finmath_tpu.models import local_vol as jlv
    from finmath_tpu.models import merton as jm
    from finmath_tpu.models import slv as jslv
    from finmath_tpu.models import variance_gamma as jvg
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)
    from finmath_tpu_torch.models import bates as tb
    from finmath_tpu_torch.models import local_vol as tlv
    from finmath_tpu_torch.models import slv as tslv

    bates = dict(HESTON, jump_intensity=0.6, jump_size_mean=-0.12,
                 jump_size_std=0.18)
    surf = dict(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65, eta=0.6,
                gamma=0.4)
    pricings = [
        (jh.HestonParams(**HESTON), th.HestonParams,
         lambda m, p: m.heston_characteristic_prices(p, T, STRIKES), th, jh),
        (jm.MertonParams(**MERTON), tm.MertonParams,
         lambda m, p: m.merton_series_prices(p, T, STRIKES), tm, jm),
        (jvg.VarianceGammaParams(**VG), tvg.VarianceGammaParams,
         lambda m, p: m.vg_analytic_prices(p, T, STRIKES), tvg, jvg),
        (jb.BatesParams(**bates), tb.BatesParams,
         lambda m, p: m.bates_characteristic_prices(p, T, STRIKES), tb, jb),
        (jba.BachelierParams(**BACH), tba.BachelierParams,
         lambda m, p: m.bachelier_analytic_price(p, T, STRIKES), tba, jba),
        (jba.DisplacedLognormalParams(**DISP), tba.DisplacedLognormalParams,
         lambda m, p: m.displaced_analytic_price(p, T, STRIKES), tba, jba),
        (jlv.SSVISurface(**surf), tlv.SSVISurface,
         lambda m, p: np.asarray(p.total_variance(np.linspace(-1, 1, 9)
                                                  * 1.0, 1.5)), tlv, jlv),
    ]
    for obj, cls, price, port, ref in pricings:
        got = convert.equity_model_from_jax(obj)
        assert type(got) is cls and got == cls(**vars(obj))
        np.testing.assert_allclose(price(port, got), price(ref, obj),
                                   rtol=1e-12)
    jtd = JTD(initial=0.0, num_steps=10, step=0.1)
    hm = convert.equity_model_from_jax(jh.HestonModel(jh.HestonParams(
        **HESTON)))
    assert hm == th.HestonModel(th.HestonParams(**HESTON))
    lvm = convert.equity_model_from_jax(jlv.LocalVolatilityModel(
        100.0, 0.03, jlv.SSVISurface(**surf), jtd, dividend_yield=0.01))
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)
    tlvm = tlv.LocalVolatilityModel(100.0, 0.03, tlv.SSVISurface(**surf),
                                    TimeDiscretization(initial=0.0, num_steps=10, step=0.1),
                                    dividend_yield=0.01)
    for f in ("initial_value", "risk_free_rate", "dividend_yield", "min_vol",
              "max_vol", "t_floor", "denominator_floor", "surface"):
        assert getattr(lvm, f) == getattr(tlvm, f)
    np.testing.assert_array_equal(lvm._coeff_times, tlvm._coeff_times)
    sm = convert.equity_model_from_jax(jslv.HestonSLVModel(
        jh.HestonParams(**HESTON), jlv.SSVISurface(**surf), jtd,
        mixing=0.5))
    tsm = tslv.HestonSLVModel(th.HestonParams(**HESTON),
                              tlv.SSVISurface(**surf),
                              TimeDiscretization(initial=0.0, num_steps=10, step=0.1), mixing=0.5)
    assert sm.params == tsm.params and sm.mixing == 0.5
    np.testing.assert_array_equal(sm._nodes_np, tsm._nodes_np)
    np.testing.assert_array_equal(sm._coeff_times, tsm._coeff_times)
    with pytest.raises(ValueError, match="no equity model"):
        convert.equity_model_from_jax(jlv.DupireLocalVolSurface(
            w=lambda k, t: 0.04 * t))


# -- device ---------------------------------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device=`` every entry point of the slice computes on the
    current CUDA device, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    calls = (
        lambda: tba.mc_bachelier_european_prices(
            tba.BachelierParams(**BACH), T, [100.0], 8),
        lambda: tba.mc_displaced_european_prices(
            tba.DisplacedLognormalParams(**DISP), T, [100.0], 8),
        lambda: tvg.mc_vg_european_prices(
            tvg.VarianceGammaParams(**VG), T, [100.0], 8),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
