"""Slice C's models against finmath_tpu: the closed forms to 1e-12 (float64
on both sides); the Euler scheme, ``BlackScholesModel`` and
``EuropeanOption`` of both packages on the same
``BrownianMotionFinmathMersenne`` paths (16,384 paths x 20 steps), states
and price to 1e-6 relative (float32 paths on both sides, the same
operation order, two float32 exp implementations); the Brownian drivers;
and, on the port's own torch stream (which is not JAX's), the reference
test's bound: within 0.005 of the analytic price at 100k paths x 50
steps, the martingale property, determinism and Asian < European."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu.models import analytic as janalytic  # noqa: E402
from finmath_tpu.models import black_scholes as jbs  # noqa: E402
from finmath_tpu.models import brownian_motion as jbm  # noqa: E402
from finmath_tpu.models import time_discretization as jtd  # noqa: E402

from finmath_tpu_torch.models import analytic as tanalytic  # noqa: E402
from finmath_tpu_torch.models import black_scholes as tbs  # noqa: E402
from finmath_tpu_torch.models import brownian_motion as tbm  # noqa: E402
from finmath_tpu_torch.models import time_discretization as ttd  # noqa: E402
from finmath_tpu_torch.models.process import EulerScheme  # noqa: E402
from finmath_tpu_torch.ops import RandomVariableTorch  # noqa: E402
from finmath_tpu_torch.ops.random_variable_float import (  # noqa: E402
    RandomVariableFloat)

# the reference test's parameters (MonteCarloBlackScholesModelTest.java:60-75)
S0, R, SIGMA, T, K = 1.0, 0.05, 0.30, 1.0, 1.05
CPU = "cpu"
MERSENNE_PATHS, MERSENNE_STEPS, MERSENNE_SEED = 16_384, 20, 3141
PATHS, STEPS = 100_000, 50


def test_closed_forms_match_jax():
    host = [
        ("black_scholes_option_value", (1.0, 0.05, 0.3, 1.0, 1.05)),
        ("black_scholes_option_value", (100.0, 0.05, 0.2, 1.0, 90.0, False)),
        ("black_scholes_option_value", (1.0, 0.05, 0.0, 1.0, 0.9)),
        ("black_formula", (0.03, 0.031, 0.25, 5.0, 7.5)),
        ("bachelier_formula", (0.02, 0.019, 0.005, 4.0, 3.0)),
        ("black_implied_volatility", (0.03, 0.031, 5.0, 0.05, 7.5)),
        ("bachelier_implied_volatility", (0.02, 0.019, 4.0, 0.012, 3.0)),
        ("digital_option_value", (1.0, 0.05, 0.3, 1.0, 1.05)),
        ("digital_option_value", (1.0, 0.05, 0.3, 1.0, 1.05, False)),
        ("geometric_asian_option_value",
         (1.0, 0.05, 0.3, np.linspace(0.1, 1.0, 10), 1.0)),
        ("geometric_asian_option_value",
         (1.0, 0.05, 0.3, [0.5, 1.0], 1.0, False, 1.5)),
        ("lookback_floating_strike_value", (1.0, 0.05, 0.3, 1.0)),
        ("lookback_floating_strike_value", (1.0, 0.05, 0.3, 1.0, False, 1.2)),
        ("lookback_fixed_strike_value", (1.0, 0.05, 0.3, 1.0, 1.1)),
        ("lookback_fixed_strike_value", (1.0, 0.05, 0.3, 1.0, 0.9, False)),
    ]
    for kind in ("up-out", "down-out", "up-in", "down-in"):
        for is_call in (True, False):
            host.append(("barrier_option_value",
                         (1.0, 0.05, 0.3, 1.0, 1.0,
                          1.3 if kind.startswith("up") else 0.8, kind,
                          is_call)))
    for name, args in host:
        a = getattr(janalytic, name)(*args)
        b = getattr(tanalytic, name)(*args)
        assert b == pytest.approx(a, rel=1e-12, abs=1e-15), name
    fwd = np.asarray([0.02, 0.03, 0.025])
    strike = np.asarray([0.021, 0.03, 0.02])
    vol = np.asarray([0.2, 0.0, 0.35])
    mat = np.asarray([1.0, 2.0, 0.0])
    import jax.numpy as jnp

    for jfn, tfn in ((janalytic.black_formula_jnp,
                      tanalytic.black_formula_torch),
                     (janalytic.bachelier_formula_jnp,
                      tanalytic.bachelier_formula_torch)):
        a = np.asarray(jfn(*(jnp.asarray(v) for v in (fwd, strike, vol, mat)),
                           2.0))
        b = tfn(*(torch.as_tensor(v) for v in (fwd, strike, vol, mat)), 2.0)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12, atol=1e-15)


@pytest.fixture(scope="module")
def mersenne_pair():
    """The same finmath Mersenne paths through both packages' object API."""
    kw = dict(initial=0.0, num_steps=MERSENNE_STEPS, step=T / MERSENNE_STEPS)
    jtd_, ttd_ = jtd.TimeDiscretization(**kw), ttd.TimeDiscretization(**kw)
    jsim = jbs.MonteCarloBlackScholesModel(
        jtd_, MERSENNE_PATHS, jbs.BlackScholesModel(S0, R, SIGMA),
        brownian=jbm.BrownianMotionFinmathMersenne(jtd_, 1, MERSENNE_PATHS,
                                                   MERSENNE_SEED))
    tsim = tbs.MonteCarloBlackScholesModel(
        ttd_, MERSENNE_PATHS, tbs.BlackScholesModel(S0, R, SIGMA),
        brownian=tbm.BrownianMotionFinmathMersenne(ttd_, 1, MERSENNE_PATHS,
                                                   MERSENNE_SEED, device=CPU))
    return jsim, tsim


def test_euler_states_and_price_on_mersenne_paths(mersenne_pair):
    jsim, tsim = mersenne_pair
    np.testing.assert_array_equal(tsim.brownian.increments,
                                  np.asarray(jsim.brownian.increments))
    j_states = np.asarray(jsim.process._lazy_states())
    t_states = tsim.process._lazy_states()
    assert t_states.dtype == torch.float32 and t_states.device.type == "cpu"
    assert tuple(t_states.shape) == (MERSENNE_STEPS + 1, 1, MERSENNE_PATHS)
    np.testing.assert_allclose(t_states.numpy(), j_states, rtol=1e-6,
                               atol=1e-7)
    times = [0.0, 0.5, T]
    for t in times:
        np.testing.assert_allclose(
            tsim.get_asset_value(t).get_realizations(),
            np.asarray(jsim.get_asset_value(t).get_realizations()),
            rtol=1e-6)
    np.testing.assert_allclose(tsim.get_asset_values(times).numpy(),
                               np.asarray(jsim.get_asset_values(times)),
                               rtol=1e-6)
    for is_call in (True, False):
        jo, to = jbs.EuropeanOption(T, K, is_call), tbs.EuropeanOption(
            T, K, is_call)
        assert to.get_value(tsim) == pytest.approx(jo.get_value(jsim),
                                                   rel=1e-6)
        np.testing.assert_allclose(to.get_value_and_error(tsim),
                                   jo.get_value_and_error(jsim), rtol=1e-6)
    with pytest.raises(ValueError, match="not on the simulation grid"):
        tsim.get_asset_value(0.33)


def test_brownian_drivers():
    td = ttd.TimeDiscretization(initial=0.0, num_steps=8, step=0.25)
    jtd_ = jtd.TimeDiscretization(initial=0.0, num_steps=8, step=0.25)
    bm = tbm.BrownianMotion(td, 2, 20_000, 7, device=CPU)
    inc = bm.increments
    assert tuple(inc.shape) == (8, 2, 20_000) and inc.dtype == torch.float32
    # the statistical contract: mean 0, variance dt (5 sigma bounds)
    n = inc.numel()
    assert abs(float(inc.double().mean())) < 5 * math.sqrt(0.25 / n)
    assert abs(float(inc.double().var()) / 0.25 - 1) < 5 * math.sqrt(2 / n)
    assert torch.equal(tbm.BrownianMotion(td, 2, 20_000, 7,
                                          device=CPU).increments, inc)
    assert bm == tbm.BrownianMotion(td, 2, 20_000, 7, device=CPU)
    other = bm.get_clone_with_modified_seed(8)
    assert other != bm and not torch.equal(other.increments, inc)
    w = bm.get_brownian_motion(3, 1)
    assert w.get_filtration_time() == 0.75
    np.testing.assert_allclose(w.get_realizations(),
                               inc[:3, 1].sum(0).numpy(), rtol=0, atol=0)
    dw = bm.getBrownianIncrement(2, 1)
    assert isinstance(dw, RandomVariableTorch)
    assert dw.get_filtration_time() == 0.75
    assert bm.get_random_variable_for_constant(2.0).double_value() == 2.0
    # host drivers: the JAX package's increments bit for bit
    for algo in ("mersenne", "java"):
        h = tbm.BrownianMotionHostRandom(td, 2, 300, 11, algorithm=algo)
        jh = jbm.BrownianMotionHostRandom(jtd_, 2, 300, 11, algorithm=algo)
        np.testing.assert_array_equal(h.increments, jh.increments)
        assert isinstance(h.get_brownian_increment(0), RandomVariableFloat)
    hyb = tbm.BrownianMotionTorchWithHostRandomVariable(td, 2, 50, 7,
                                                        device=CPU)
    np.testing.assert_array_equal(hyb.increments,
                                  tbm.BrownianMotion(td, 2, 50, 7, device=CPU)
                                  .increments.numpy())
    assert isinstance(hyb.get_brownian_increment(1, 1), RandomVariableFloat)
    view = tbm.BrownianMotionView(bm, [1])
    assert view.get_number_of_factors() == 1
    assert torch.equal(view.increments[:, 0], inc[:, 1])
    np.testing.assert_array_equal(
        view.get_brownian_increment(4).get_realizations(),
        inc[4, 1].numpy())
    m = tbm.BrownianMotionFinmathMersenne(td, 2, 64, 314151, device=CPU)
    jm = jbm.BrownianMotionFinmathMersenne(jtd_, 2, 64, 314151)
    np.testing.assert_array_equal(m.increments, jm.increments)
    np.testing.assert_array_equal(
        m.get_brownian_increment(5, 1).get_realizations(),
        np.asarray(jm.get_brownian_increment(5, 1).get_realizations()))
    np.testing.assert_array_equal(tbm.BrownianMotionView(m, [1]).increments,
                                  m.increments[:, [1]])
    with pytest.raises(NotImplementedError, match="sharding"):
        EulerScheme(tbs.BlackScholesModel(S0, R, SIGMA), bm, mesh=object())


@pytest.fixture(scope="module")
def own_stream():
    td = ttd.TimeDiscretization(initial=0.0, num_steps=STEPS, step=T / STEPS)
    return tbs.MonteCarloBlackScholesModel(
        td, PATHS, tbs.BlackScholesModel(S0, R, SIGMA), seed=3141, device=CPU)


def test_prices_against_analytic(own_stream):
    analytic = tanalytic.black_scholes_option_value(S0, R, SIGMA, T, K)
    value = tbs.EuropeanOption(T, K).get_value(own_stream)
    assert value == pytest.approx(analytic, abs=0.005)
    mc = tbs.mc_european_call_price(3141, PATHS, STEPS, S0, R, SIGMA, T, K,
                                    device=CPU)
    assert mc == pytest.approx(analytic, abs=0.005)
    # the float64 oracle mode on the same float32 normals
    mc64 = tbs.mc_european_call_price(3141, PATHS, STEPS, S0, R, SIGMA, T, K,
                                      dtype=torch.float64, device=CPU)
    assert mc64 == pytest.approx(mc, rel=1e-5)


def test_martingale_property(own_stream):
    """E[S_T / N_T] N_0 = S_0 within 3 standard errors."""
    s_t = own_stream.get_asset_value(T)
    discounted = s_t.div(own_stream.get_numeraire(T)).mult(
        own_stream.get_numeraire(0.0))
    assert discounted.get_average() == pytest.approx(
        S0, abs=3 * discounted.get_standard_error())


def test_determinism_and_asian_below_european():
    args = (50_000, 20, S0, R, SIGMA, T, K)
    v1 = tbs.mc_european_call_price(7, *args, device=CPU)
    assert v1 == tbs.mc_european_call_price(7, *args, device=CPU)
    assert v1 != tbs.mc_european_call_price(8, *args, device=CPU)
    asian = tbs.mc_asian_call_price(1, PATHS, STEPS, S0, R, SIGMA, T, 1.0,
                                    device=CPU)
    euro = tbs.mc_european_call_price(1, PATHS, STEPS, S0, R, SIGMA, T, 1.0,
                                      device=CPU)
    assert 0 < asian < euro
    assert asian == tbs.mc_asian_call_price(1, PATHS, STEPS, S0, R, SIGMA, T,
                                            1.0, device=CPU)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device=`` every entry point computes on the current CUDA
    device, and raises where there is none: no quiet CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from finmath_tpu_torch.ops import kernels

    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    td = ttd.TimeDiscretization(initial=0.0, num_steps=2, step=0.5)
    args = (1, 8, 2, S0, R, SIGMA, T, K)
    for call in (lambda: tbs.MonteCarloBlackScholesModel(
                     td, 8, tbs.BlackScholesModel(S0, R, SIGMA)),
                 lambda: tbs.mc_european_call_price(*args),
                 lambda: tbs.mc_asian_call_price(*args),
                 lambda: kernels.mc_european_call_price_kernel(*args),
                 lambda: kernels.mc_asian_call_price_kernel(*args),
                 lambda: tbm.BrownianMotion(td, 1, 8, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
