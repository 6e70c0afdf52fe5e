"""The port's Merton jump-diffusion and Variance-Gamma engines
(``finmath_tpu_torch/models/{merton,variance_gamma}.py``) against
finmath_tpu's, on ``tests/test_merton.py``'s and
``tests/test_fourier_models.py``'s parameters at a small size.

* Merton host layer (NumPy float64, copied): the series prices within
  1e-12 relative (measured: equal), ``calibrate_merton``'s residuals and
  Jacobian at two points within 1e-12 and a round trip over one maturity.
* The Poisson sampler: the float64 CDF within 4 ulps of the JAX one
  (measured 3: XLA's float64 ``exp`` and torch's differ by an ulp on some
  terms, and the ``cumsum`` carries them) and the counts equal on the same uniforms, among them uniforms placed on the
  CDF's steps.
* ``mc_merton_european_prices`` on the JAX kernel's own Threefry draws
  (``merton.py:_mc_merton_kernel``: each step key split in three, (kd, kj,
  ku)): float32 within 1e-6 relative (measured 1.9e-8), float64 within
  1e-10 (measured 3.5e-16).
* ``MonteCarloMertonModel``'s history on the JAX ``_merton_path_history``
  draws (``split(key, dts.shape[0])``, then three): within 1e-6 of the
  largest log-state (measured 2 ulps, 1.6e-7).
* VG on the JAX ``_mc_vg_kernel``'s gammas and normals (each step key
  split in two, (kg, kz)): within 1e-6 relative (measured 2.0e-8). The port's own gamma
  clock (``torch._standard_gamma``, another rejection sampler than
  ``jax.random.gamma``) held to the statistical contract at phase 39's
  shape dt / nu = 0.3125. ``calibrate_variance_gamma`` as Merton's.
* Validation, the jump-cap guard and the device rule."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models import calibration as tcal  # noqa: E402
from finmath_tpu_torch.models import merton as tm  # noqa: E402
from finmath_tpu_torch.models import variance_gamma as tvg  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)
from test_torch_fourier_bachelier import (  # noqa: E402, F401
    STRIKES, VG, _raises_alike, captured_problem, jax_normal_blocks,
    packed_rel, threads_one, one_blas_thread)

CPU = "cpu"
T = 1.25
P = dict(initial_value=100.0, risk_free_rate=0.05, volatility=0.2,
         jump_intensity=0.6, jump_size_mean=-0.15, jump_size_std=0.25)
N, STEPS, SEED = 20_000, 8, 11


def jm():
    from finmath_tpu.models import merton
    return merton


# -- host layer ------------------------------------------------------------------

@pytest.mark.parametrize("lam", [0.0, 0.6, 3.0])
def test_series_prices(lam):
    p = dict(P, jump_intensity=lam)
    for is_call in (True, False):
        np.testing.assert_allclose(
            tm.merton_series_prices(tm.MertonParams(**p), T, STRIKES,
                                    is_call),
            jm().merton_series_prices(jm().MertonParams(**p), T, STRIKES,
                                      is_call), rtol=1e-12)


def test_validation_errors_alike():
    for call in (
            lambda m: m.MertonParams(100.0, 0.03, -0.1, 0.5, 0.0, 0.1),
            lambda m: m.MertonParams(100.0, 0.03, 0.2, -0.5, 0.0, 0.1),
            lambda m: m.MertonParams(0.0, 0.03, 0.2, 0.5, 0.0, 0.1),
            lambda m: m.MertonParams(100.0, 0.03, 0.2, 0.5, 0.0, -0.1),
            lambda m: m.merton_series_prices(m.MertonParams(**P), 0.0,
                                             STRIKES),
            lambda m: m.merton_series_prices(m.MertonParams(**P), 1.0,
                                             [-1.0]),
            lambda m: m.calibrate_merton(100.0, 0.03, [1.0], [STRIKES] * 2,
                                         [STRIKES])):
        _raises_alike(lambda: call(tm), lambda: call(jm()))
    params = tm.MertonParams(**P)
    with pytest.raises(ValueError, match="jump cap"):
        tm.mc_merton_european_prices(params, 10.0, [100.0], num_paths=8,
                                     num_steps=2, device=CPU)
    with pytest.raises(ValueError, match="even"):
        tm.mc_merton_european_prices(params, T, [100.0], num_paths=101,
                                     antithetic=True, device=CPU)
    with pytest.raises(ValueError, match="both"):
        tm.mc_merton_european_prices(params, T, [100.0], 8, 2, device=CPU,
                                     uniforms=np.zeros((2, 8)))


def test_calibration_problem_and_round_trip(monkeypatch):
    from finmath_tpu.models import calibration as jcal

    truth = dict(initial_value=100.0, risk_free_rate=0.03, volatility=0.17,
                 jump_intensity=0.8, jump_size_mean=-0.1, jump_size_std=0.18)
    mats = [0.5, 1.0, 2.0]
    ks = [[90.0, 100.0, 110.0]] * 3
    with threads_one():
        targets = [jm().merton_series_prices(jm().MertonParams(**truth), t,
                                             k) for t, k in zip(mats, ks)]
        args = (100.0, 0.03, mats, ks, targets)
        jr, jj = captured_problem(monkeypatch, jcal, jm().calibrate_merton,
                                  *args)
        tr, tj = captured_problem(monkeypatch, tcal, tm.calibrate_merton,
                                  *args)
        for y in (tm._to_unconstrained(tm.MertonParams(100.0, 0.03, 0.2, 0.3,
                                                       -0.1, 0.2)),
                  np.array([-1.6, -0.4, -0.05, -1.8])):
            np.testing.assert_allclose(tr(y), jr(y), rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(tj(y), jj(y), rtol=1e-12, atol=1e-12)
        one = (100.0, 0.03, [1.0], [ks[0]], [targets[1]])
        got = tm.calibrate_merton(*one, max_iterations=40)
        want = jm().calibrate_merton(*one, max_iterations=40)
    assert got.iterations == want.iterations
    for f in ("volatility", "jump_intensity", "jump_size_mean",
              "jump_size_std"):
        assert getattr(got.params, f) == pytest.approx(
            getattr(want.params, f), rel=1e-8)


# -- the Poisson sampler ---------------------------------------------------------

@pytest.mark.parametrize("lam_dt", [0.0, 0.0375, 0.35, 2.0])
def test_poisson_counts_equal(lam_dt):
    import jax.numpy as jnp

    cdf_t = tm._poisson_cdf(torch.tensor(lam_dt, dtype=torch.float64), 16)
    ulp = np.spacing(np.maximum(np.asarray(cdf_t), 1e-300))
    u = np.random.default_rng(7).random(200_000).astype(np.float32)
    # uniforms on and around the steps of the CDF
    steps = np.asarray(cdf_t, dtype=np.float32)
    u = np.concatenate([u, steps, np.nextafter(steps, 0), np.nextafter(
        steps, 1)]).astype(np.float32)
    ud = u.astype(np.float64)
    want = np.asarray(jm()._poisson_icdf_branchless(
        jnp.asarray(ud), jnp.float64(lam_dt), 16))
    got = tm._poisson_icdf_branchless(torch.as_tensor(ud), lam_dt, 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the JAX CDF: XLA's float64 exp and torch's differ by an ulp on
    # some terms, and the cumsum carries them
    jk = jnp.arange(16, dtype=jnp.float64)
    jlog = (-lam_dt + jk * jnp.log(jnp.maximum(lam_dt, 1e-300))
            - jnp.cumsum(jnp.log(jnp.maximum(jk, 1.0))))
    jcdf = np.asarray(jnp.cumsum(jnp.exp(jlog)))
    assert np.all(np.abs(np.asarray(cdf_t) - jcdf) <= 4 * ulp)


# -- the engine on the JAX draws -------------------------------------------------

@pytest.fixture(scope="module")
def jax_engine():
    import jax.numpy as jnp

    out = {}
    for anti in (False, True):
        half = N // 2 if anti else N
        blocks = jax_normal_blocks(SEED, STEPS, half, 3,
                                   ["normal", "normal", "uniform"])
        for f32 in (True, False):
            out[anti, f32] = (jm().mc_merton_european_prices(
                jm().MertonParams(**P), T, STRIKES, N, STEPS, SEED, anti,
                dtype=None if f32 else jnp.float64), blocks)
    return out


@pytest.mark.parametrize("antithetic", [False, True])
def test_engine_on_jax_draws(jax_engine, antithetic):
    for f32, bound in ((True, 1e-6), (False, 1e-10)):
        want, (zd, zj, u) = jax_engine[antithetic, f32]
        got = tm.mc_merton_european_prices(
            tm.MertonParams(**P), T, STRIKES, N, STEPS, SEED, antithetic,
            dtype=None if f32 else torch.float64, device=CPU,
            normals=(zd, zj), uniforms=u)
        assert packed_rel(got, want) < bound


def test_facade_history_on_jax_draws():
    import jax
    import jax.numpy as jnp

    td = TimeDiscretization(initial=0.0, num_steps=10, step=0.1)
    dts = np.asarray(td.get_step_sizes())
    params = jm().MertonParams(**P)
    # merton.py:_merton_path_history: split(key, dts.shape[0]), then three
    want = np.asarray(jm()._merton_path_history(
        jax.random.PRNGKey(9), 5_000, 10, 16,
        *(jnp.float64(x) for x in (100.0, 0.05, 0.2, 0.6, -0.15, 0.25)),
        jnp.asarray(dts)))
    zd, zj, u = jax_normal_blocks(9, 10, 5_000, 3,
                                  ["normal", "normal", "uniform"])
    sim = tm.MonteCarloMertonModel(td, 5_000, tm.MertonParams(**P), seed=9,
                                   device=CPU, normals=(zd, zj), uniforms=u)
    got = sim._states().numpy()
    assert got.shape == want.shape == (11, 5_000)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(sim.get_asset_values([0.5, 1.0]).numpy(),
                               np.exp(want[[5, 10]]), rtol=2e-6)
    rv = sim.get_asset_value(0.5)
    assert rv.get_filtration_time() == 0.5 and rv.size() == 5_000
    with pytest.raises(ValueError, match="grid"):
        sim.get_asset_value(0.33)


def test_port_stream_against_the_series():
    """The port's own stream at 200,000 antithetic paths: the European
    within 4 standard errors of the series (one facade, one engine), and
    the sampler's counts against the Poisson pmf."""
    from finmath_tpu_torch.models.black_scholes import EuropeanOption

    params = tm.MertonParams(**P)
    ref = tm.merton_series_prices(params, 1.0, STRIKES)
    px, fwd = tm.mc_merton_european_prices(params, 1.0, STRIKES, 200_000, 8,
                                           seed=11, antithetic=True,
                                           device=CPU)
    se = 100.0 * 0.35 / math.sqrt(200_000)
    assert np.all(np.abs(px - ref) < 4 * se)
    assert abs(fwd - 100.0) < 4 * se
    td = TimeDiscretization(initial=0.0, num_steps=8, step=1.0 / 8)
    sim = tm.MonteCarloMertonModel(td, 100_000, params, seed=9, device=CPU)
    v = EuropeanOption(1.0, 100.0).get_value(sim)
    assert abs(v - ref[2]) < 4 * 100.0 * 0.35 / math.sqrt(100_000)
    u = torch.rand(200_000, generator=torch.Generator().manual_seed(7),
                   dtype=torch.float64)
    counts = tm._poisson_icdf_branchless(u, 0.35, 16).numpy()
    pmf = [math.exp(-0.35) * 0.35 ** k / math.factorial(k) for k in range(6)]
    np.testing.assert_allclose([(counts == k).mean() for k in range(6)], pmf,
                               atol=5e-3)


# -- Variance-Gamma ---------------------------------------------------------------

@pytest.fixture(scope="module")
def vg_jax():
    """The JAX VG engine at 20,000 paths x 8 steps, plain and antithetic,
    and its gamma and normal draws (variance_gamma.py:_mc_vg_kernel: each
    step key split in two, (kg, kz))."""
    from finmath_tpu.models import variance_gamma as jvg

    n, steps, seed = 20_000, 8, 2
    shape_a = float(np.float32(T / steps / VG["nu"]))
    out = {}
    for anti in (False, True):
        half = n // 2 if anti else n
        g, z = jax_normal_blocks(seed, steps, half, 2,
                                 [("gamma", shape_a), "normal"])
        out[anti] = (jvg.mc_vg_european_prices(
            jvg.VarianceGammaParams(**VG), T, STRIKES, n, steps, seed, anti),
            g, z)
    return n, steps, out


@pytest.mark.parametrize("antithetic", [False, True])
def test_vg_engine_on_jax_gammas(vg_jax, antithetic):
    n, steps, out = vg_jax
    want, g, z = out[antithetic]
    got = tvg.mc_vg_european_prices(
        tvg.VarianceGammaParams(**VG), T, STRIKES, n, steps, 2, antithetic,
        device=CPU, gammas=g, normals=z)
    assert packed_rel(got, want) < 1e-6
    with pytest.raises(ValueError, match="both"):
        tvg.mc_vg_european_prices(tvg.VarianceGammaParams(**VG), T, STRIKES,
                                  n, steps, device=CPU, gammas=g)


def test_port_gamma_clock_statistics():
    """torch's gamma sampler at phase 39's shape: the sample mean and
    variance of 1M draws within 4 standard errors of alpha."""
    alpha = float(np.float32(1.25 / 16 / 0.25))
    gen = torch.Generator().manual_seed(5)
    g = torch._standard_gamma(torch.full((1_000_000,), alpha), generator=gen)
    g = g.double()
    n = g.numel()
    assert abs(float(g.mean()) - alpha) < 4 * math.sqrt(alpha / n)
    var_se = math.sqrt((2 * alpha ** 2 + 6 * alpha) / n)
    assert abs(float(g.var()) - alpha) < 4 * var_se


def test_vg_calibration_problem_and_round_trip(monkeypatch):
    from finmath_tpu.models import calibration as jcal
    from finmath_tpu.models import variance_gamma as jvg

    truth = dict(initial_value=100.0, risk_free_rate=0.02, sigma=0.2,
                 theta=-0.1, nu=0.3)
    mats = [0.5, 1.0, 2.0]
    ks = [[90.0, 100.0, 110.0]] * 3
    with threads_one():
        targets = [jvg.vg_analytic_prices(jvg.VarianceGammaParams(**truth),
                                          t, k) for t, k in zip(mats, ks)]
        args = (100.0, 0.02, mats, ks, targets)
        jr, jj = captured_problem(monkeypatch, jcal,
                                  jvg.calibrate_variance_gamma, *args)
        tr, tj = captured_problem(monkeypatch, tcal,
                                  tvg.calibrate_variance_gamma, *args)
        for y in (np.array([math.log(0.2), math.log(0.9), math.log(0.2)]),
                  np.array([-1.4, -0.3, -1.1])):
            np.testing.assert_allclose(tr(y), jr(y), rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(tj(y), jj(y), rtol=1e-12, atol=1e-12)
        one = (100.0, 0.02, [1.0], [ks[0]], [targets[1]])
        got = tvg.calibrate_variance_gamma(*one, max_iterations=40)
        want = jvg.calibrate_variance_gamma(*one, max_iterations=40)
    assert got.iterations == want.iterations
    for f in ("sigma", "theta", "nu"):
        assert getattr(got.params, f) == pytest.approx(
            getattr(want.params, f), rel=1e-8)


# -- device -----------------------------------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    td = TimeDiscretization(initial=0.0, num_steps=2, step=0.5)
    params = tm.MertonParams(**P)
    for call in (lambda: tm.mc_merton_european_prices(params, T, [100.0], 8,
                                                      2),
                 lambda: tm.MonteCarloMertonModel(td, 8, params),
                 lambda: tvg.mc_vg_european_prices(
                     tvg.VarianceGammaParams(**VG), T, [100.0], 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
