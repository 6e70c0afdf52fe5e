"""The port's Bates model (``finmath_tpu_torch/models/bates.py``) against
finmath_tpu's, on ``tests/test_bates.py``'s parameters at a small size.

* Host layer (NumPy float64, copied): the characteristic function and its
  Gil-Pelaez prices within 1e-12 relative (measured: equal), and the
  validation errors of the same type.
* ``mc_bates_european_prices`` on the JAX kernel's own Threefry draws
  (``bates.py:_bates_step_factory``: each step key split in four, (z1, z2,
  z_j, u) with u in [1e-7, 1 - 1e-7]): float32 within 1e-6 relative
  (measured 4.6e-8), float64 within 1e-10 (measured 3.5e-16); the
  Poisson counts of the shared step equal.
* ``MonteCarloBatesModel``'s history on the JAX ``_bates_path_history``
  draws (``split(key, dts.shape[0])``, then four): every log-state within
  16 float32 ulps (measured 13, 1.3e-6 relative), all but 0.1% of the
  paths within 4 (measured: 3 of 5,000 paths beyond 4 ulps, paths whose
  variance sits at the full-truncation floor, where sqrt(V+) turns a
  last-bit gap of V into a larger one of log S).
* The jump-cap guard and the device rule."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models import bates as tb  # noqa: E402
from finmath_tpu_torch.models import heston as th  # noqa: E402
from finmath_tpu_torch.models import merton as tm  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)
from test_torch_fourier_bachelier import (  # noqa: E402, F401
    _raises_alike, jax_normal_blocks, packed_rel, one_blas_thread)

CPU = "cpu"
KS = np.array([80.0, 90.0, 100.0, 110.0, 125.0])
P = dict(initial_value=100.0, risk_free_rate=0.03, v0=0.04, kappa=1.5,
         theta=0.05, xi=0.6, rho=-0.7, jump_intensity=0.6,
         jump_size_mean=-0.12, jump_size_std=0.18)
T = 1.5
N, STEPS, SEED = 20_000, 24, 3141
KINDS = ["normal", "normal", "normal", "uniform_guarded"]


def jb():
    from finmath_tpu.models import bates
    return bates


@pytest.mark.parametrize("maturity", [0.5, 1.5, 5.0])
def test_characteristic_prices(maturity):
    u = np.linspace(-2.0, 30.0, 41) - 0.5j
    np.testing.assert_allclose(
        tb.bates_cf(tb.BatesParams(**P), maturity)(u),
        jb().bates_cf(jb().BatesParams(**P), maturity)(u), rtol=1e-12)
    for is_call in (True, False):
        np.testing.assert_allclose(
            tb.bates_characteristic_prices(tb.BatesParams(**P), maturity,
                                           KS, is_call),
            jb().bates_characteristic_prices(jb().BatesParams(**P),
                                             maturity, KS, is_call),
            rtol=1e-12)
    p = tb.BatesParams(**P)
    assert p.heston == th.HestonParams(*list(P.values())[:7])
    assert p.jump_compensator == jb().BatesParams(**P).jump_compensator


def test_validation_errors_alike():
    for call in (
            lambda m: m.BatesParams(100.0, 0.03, -0.04, 1.5, 0.05, 0.6, -0.7,
                                    0.6, -0.12, 0.18),
            lambda m: m.BatesParams(100.0, 0.03, 0.04, 1.5, 0.05, 0.6, -0.7,
                                    -0.6, -0.12, 0.18),
            lambda m: m.BatesParams(100.0, 0.03, 0.04, 1.5, 0.05, 0.6, -1.7,
                                    0.6, -0.12, 0.18),
            lambda m: m.bates_characteristic_prices(m.BatesParams(**P), 0.0,
                                                    KS)):
        _raises_alike(lambda: call(tb), lambda: call(jb()))
    hot = tb.BatesParams(**dict(P, jump_intensity=200.0))
    with pytest.raises(ValueError, match="tail mass"):
        tb.mc_bates_european_prices(hot, T, KS, num_paths=1000, num_steps=4,
                                    device=CPU)
    td = TimeDiscretization(initial=0.0, num_steps=2, step=0.75)
    with pytest.raises(ValueError, match="tail mass"):
        tb.MonteCarloBatesModel(td, 10, hot, device=CPU)


@pytest.fixture(scope="module")
def jax_engine():
    import jax.numpy as jnp

    out = {}
    for anti in (False, True):
        half = N // 2 if anti else N
        blocks = jax_normal_blocks(SEED, STEPS, half, 4, KINDS)
        for f32 in (True, False):
            out[anti, f32] = (jb().mc_bates_european_prices(
                jb().BatesParams(**P), T, KS, N, STEPS, SEED, anti,
                dtype=None if f32 else jnp.float64), blocks)
    return out


@pytest.mark.parametrize("antithetic", [False, True])
def test_engine_on_jax_draws(jax_engine, antithetic):
    for f32, bound in ((True, 1e-6), (False, 1e-10)):
        want, (z1, z2, zj, u) = jax_engine[antithetic, f32]
        got = tb.mc_bates_european_prices(
            tb.BatesParams(**P), T, KS, N, STEPS, SEED, antithetic,
            dtype=None if f32 else torch.float64, device=CPU,
            normals=(z1, z2, zj), uniforms=u)
        assert packed_rel(got, want) < bound


def test_step_counts_equal(jax_engine):
    """The shared step's jump counts: the port's CDF and comparison against
    the JAX sampler on the same guarded uniforms."""
    import jax.numpy as jnp
    from finmath_tpu.models import merton as jm

    _, (_, _, _, u) = jax_engine[False, True]
    lam_dt = P["jump_intensity"] * T / STEPS
    cdf = tm._poisson_cdf(torch.tensor(lam_dt, dtype=torch.float64), 16)
    for row in u[:4]:
        ud = row.astype(np.float64)
        want = np.asarray(jm._poisson_icdf_branchless(
            jnp.asarray(ud), jnp.float64(lam_dt), 16))
        got = tm._poisson_icdf_branchless(torch.as_tensor(ud), None, 16, cdf)
        np.testing.assert_array_equal(got.numpy(), want)


def test_facade_history_on_jax_draws():
    import jax
    import jax.numpy as jnp

    td = TimeDiscretization(initial=0.0, num_steps=30, step=0.05)
    dts = np.asarray(td.get_step_sizes())
    paths = 5_000
    want = np.asarray(jb()._bates_path_history(
        jax.random.PRNGKey(5), paths, 30, 16,
        *(jnp.float64(x) for x in P.values()), jnp.asarray(dts)))
    blocks = jax_normal_blocks(5, 30, paths, 4, KINDS)
    sim = tb.MonteCarloBatesModel(td, paths, tb.BatesParams(**P), seed=5,
                                  device=CPU, normals=tuple(blocks[:3]),
                                  uniforms=blocks[3])
    got = sim._states().numpy()
    assert got.shape == want.shape == (31, paths)
    # sqrt(V+) near V = 0 (the Feller ratio is 0.42) turns a last-bit gap
    # of V into a few ulps of log S on a handful of paths
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32)).max(axis=0)
    assert ulps.max() <= 16
    assert np.mean(ulps > 4) <= 1e-3
    np.testing.assert_allclose(sim.get_asset_values([0.5, 1.5]).numpy(),
                               np.exp(got[[10, 30]]), rtol=1e-6)


def test_port_stream_against_the_characteristic_function():
    """The port's own stream at 100,000 antithetic paths x 48 steps within
    4 standard errors of the CF, and the facade's martingale."""
    params = tb.BatesParams(**P)
    cf = tb.bates_characteristic_prices(params, T, KS)
    px, fwd, ev = tb.mc_bates_european_prices(params, T, KS, 100_000, 48,
                                              antithetic=True, device=CPU)
    se = 100.0 * 0.3 / math.sqrt(100_000)
    assert np.all(np.abs(px - cf) < 4 * se + 0.01 * cf)
    assert abs(fwd - 100.0) < 4 * se
    assert abs(ev - (0.05 + (0.04 - 0.05) * math.exp(-1.5 * T))) < 3e-3
    td = TimeDiscretization(initial=0.0, num_steps=30, step=0.05)
    sim = tb.MonteCarloBatesModel(td, 50_000, params, seed=5, device=CPU)
    s = sim.get_asset_value(1.5)
    df = math.exp(-0.03 * 1.5)
    assert abs(float(s.get_average()) * df - 100.0) < 4 * float(
        s.get_standard_error()) * df + 0.05
    from finmath_tpu_torch.models.equity_products import (AsianOption,
                                                           DigitalOption)
    dig = DigitalOption(1.0, 100.0).get_value(sim)
    assert 0.2 < dig < 0.8
    assert 0.0 < AsianOption([0.25, 0.5, 0.75, 1.0], 100.0).get_value(sim)


def test_entry_points_default_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    td = TimeDiscretization(initial=0.0, num_steps=2, step=0.5)
    params = tb.BatesParams(**P)
    for call in (lambda: tb.mc_bates_european_prices(params, T, [100.0], 8,
                                                     2),
                 lambda: tb.MonteCarloBatesModel(td, 8, params)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_grid_products_on_the_facade():
    """The JAX Bates facade has no ``time_discretization`` (nor a
    ``process``), so the JAX products that read the simulation grid
    (lookback, discrete barrier) raise AttributeError on it; the port's
    facade exposes its grid and prices them (``ROADMAP.md`` Queue 3)."""
    from finmath_tpu.models import equity_products as jep
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)
    from finmath_tpu_torch.models import equity_products as tep

    jsim = jb().MonteCarloBatesModel(JTD(initial=0.0, num_steps=10,
                                         step=0.1), 1_000,
                                     jb().BatesParams(**P), seed=5)
    td = TimeDiscretization(initial=0.0, num_steps=10, step=0.1)
    sim = tb.MonteCarloBatesModel(td, 20_000, tb.BatesParams(**P), seed=5,
                                  device=CPU)
    for build in (lambda m: m.LookbackOption(1.0, "floating-call"),
                  lambda m: m.BarrierOption(1.0, 100.0, 130.0, "up-out")):
        with pytest.raises(AttributeError):
            build(jep).get_value(jsim)
        v, e = build(tep).get_value_and_error(sim)
        assert np.isfinite(v) and v > 0 and e < 0.5
    assert sim.time_discretization is td
