"""The port's tape AAD (``ops/aad.py``), its eager LMM valuation
(``models/lmm/eager.py``), caps and floors (``models/lmm/products.py``)
and the differentiable Black-Scholes pricer, against finmath_tpu on the
same seeded NumPy inputs.

Tolerances: tape gradients within 1e-6 relative of the JAX tape's on the
same inputs (both sweep float32 adjoints with float64 path sums); the
eager LMM swaption value within 1e-5 relative of JAX's
``eager_swaption_valuation`` on the same increments (tests/test_aad.py:211)
and its tape vega within 2e-3 (tests/test_aad.py:233); the cap within
1e-5 relative of the JAX engine's caplets on the same increments (the
engines' values bound, tests/test_torch_atm_calibration.py) and the floor
by parity on the curves; the differentiable pricer's autograd delta and
vega within 1e-3 relative of a common-random-numbers central difference
of itself (float32 paths: the difference quotient carries about 1e-4 of
rounding), and its price, in float32 and in the float64 oracle mode,
bit-equal to the same Euler loop written with host-float constants."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.models.black_scholes import (  # noqa: E402
    mc_european_call_price, mc_european_call_price_differentiable)
from finmath_tpu_torch.models.lmm.eager import (  # noqa: E402
    eager_swaption_valuation)
from finmath_tpu_torch.ops import (RandomVariableFloat,  # noqa: E402
                                   RandomVariableFloatFactory,
                                   RandomVariableTorch,
                                   RandomVariableTorchFactory)
from finmath_tpu_torch.ops.aad import (  # noqa: E402
    RandomVariableDifferentiable, RandomVariableDifferentiableFactory)
from finmath_tpu_torch.ops.conditional_expectation import (  # noqa: E402
    monomial_basis)

S0, R, SIGMA, T, K = 1.0, 0.05, 0.30, 1.0, 1.05
N_PATHS, CPU = 20_000, "cpu"

jax_aad = pytest.importorskip("finmath_tpu.ops.aad")
from finmath_tpu.ops.random_variable import RandomVariableTPU  # noqa: E402


def _pair(values):
    """The same leaf in both packages: (JAX node, port node)."""
    return (jax_aad.RandomVariableDifferentiable(RandomVariableTPU(0.0, values)),
            RandomVariableDifferentiable(
                RandomVariableTorch(0.0, values, device=CPU)))


def _grad(y, x):
    g = y.get_gradient([x])[x.get_id()]
    return g.double_value() if g.is_deterministic() else \
        np.asarray(g.get_realizations(), np.float64)


def _growth(seed=0, n=N_PATHS):
    z = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return np.exp((R - SIGMA ** 2 / 2) * T
                  + SIGMA * math.sqrt(T) * z).astype(np.float32)


VALS = np.asarray([0.5, 1.0, 2.0, 3.0], np.float32)
OTHER = np.asarray([1.5, -0.5, 0.25, 2.0], np.float32)

# (id, f(x, other_in_the_same_package)) -> scalar or vector node
CHAINS = [
    ("elementwise", lambda x, o: x.mult(2.0).add(3.0).squared().average()),
    ("unary", lambda x, o: x.log().mult(2.0).exp().average()),
    ("sqrt_invert_pow", lambda x, o: x.sqrt().invert().add(x.pow(1.5)).average()),
    ("trig_abs", lambda x, o: x.sin().mult(x.cos()).add(x.abs()).average()),
    ("binary", lambda x, o: x.mult(o).div(x.add(1.0)).sub(o.vid(x)).average()),
    ("bus_cap_floor", lambda x, o: x.bus(o).cap(0.5).floor(-1.0).mult(x).average()),
    ("fused", lambda x, o: x.accrue(o, 0.5).discount(x, 0.25).add_product(x, o)
     .average()),
    ("ratio_choose", lambda x, o: x.add_ratio(o, x).sub_ratio(x, x.add(2.0))
     .mult(x.sub(1.0).choose(x, o)).average()),
    ("vector_output", lambda x, o: x.squared().mult(o)),
]


@pytest.mark.parametrize("name,chain", CHAINS, ids=[c[0] for c in CHAINS])
def test_tape_gradients_match_jax(name, chain):
    xj, xt = _pair(VALS)
    oj = RandomVariableTPU(0.0, OTHER)
    ot = RandomVariableTorch(0.0, OTHER, device=CPU)
    gj, gt = _grad(chain(xj, oj), xj), _grad(chain(xt, ot), xt)
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=0)


def test_deterministic_leaf_adjoint_is_summed():
    """The adjoint of a broadcast scalar is summed over the paths."""
    v = np.asarray([1.0, 2.0, 3.0], np.float32)
    sj = jax_aad.RandomVariableDifferentiable(RandomVariableTPU(0.0, 2.0))
    st = RandomVariableDifferentiable(RandomVariableTorch(0.0, 2.0))
    gj = _grad(sj.mult(RandomVariableTPU(0.0, v)).average(), sj)
    gt = _grad(st.mult(RandomVariableTorch(0.0, v, device=CPU)).average(), st)
    assert isinstance(gt, float) and gt == pytest.approx(2.0, rel=1e-6)
    assert gt == pytest.approx(gj, rel=1e-6)


def test_type_priority_promotion():
    x = RandomVariableDifferentiable(
        RandomVariableTorch(0.0, np.asarray([1.0, 2.0], np.float32), device=CPU))
    plain = RandomVariableTorch(0.0, np.asarray([5.0, 5.0], np.float32),
                                device=CPU)
    mixed = plain.sub(x)          # lower priority: promotes, flipped
    assert isinstance(mixed, RandomVariableDifferentiable)
    np.testing.assert_allclose(mixed.get_realizations(), [4.0, 3.0])
    g = _grad(mixed.average(), x)
    np.testing.assert_allclose(g, -0.5)
    oracle = RandomVariableFloat(0.0, np.asarray([1.0, 1.0], np.float32))
    assert isinstance(oracle.mult(x), RandomVariableDifferentiable)
    # a host-side operand goes to the node's device
    assert x.mult(oracle).values.values.device.type == "cpu"


def test_aad_delta_matches_jax_and_analytic():
    from finmath_tpu.models.analytic import black_scholes_option_value

    growth = _growth()
    deltas = []
    for leaf, g in ((jax_aad.RandomVariableDifferentiable(
            RandomVariableTPU(0.0, S0)), RandomVariableTPU(0.0, growth)),
            (RandomVariableDifferentiable(RandomVariableTorch(0.0, S0)),
             RandomVariableTorch(0.0, growth, device=CPU))):
        price = leaf.mult(g).sub(K).floor(0.0).mult(math.exp(-R * T)).average()
        deltas.append(_grad(price, leaf))
    assert deltas[1] == pytest.approx(deltas[0], rel=1e-6)
    eps = 1e-4
    analytic = (black_scholes_option_value(S0 + eps, R, SIGMA, T, K)
                - black_scholes_option_value(S0 - eps, R, SIGMA, T, K)) / (2 * eps)
    assert deltas[1] == pytest.approx(analytic, abs=0.02)


def test_conditional_expectation_through_the_tape():
    rng = np.random.default_rng(3)
    xs = rng.uniform(-1, 1, 2_000).astype(np.float32)
    x = RandomVariableDifferentiable(RandomVariableTorch(0.0, xs, device=CPU))
    est = monomial_basis(RandomVariableTorch(0.0, xs, device=CPU), 2)
    fitted = x.squared().get_conditional_expectation(est)
    assert isinstance(fitted, RandomVariableDifferentiable)
    np.testing.assert_allclose(fitted.get_realizations(), xs * xs, atol=1e-5)
    # the regression enters as the identity: d mean(fit(x^2)) / dx = 2x / n
    np.testing.assert_allclose(_grad(fitted.average(), x), 2 * xs / xs.size,
                               rtol=1e-6)


def test_factory_and_contract_delegation():
    f = RandomVariableDifferentiableFactory(device=CPU)
    rv = f.create_random_variable(1.0, 3.0)
    assert isinstance(rv, RandomVariableDifferentiable)
    assert rv.get_filtration_time() == 1.0 and rv.double_value() == 3.0
    vals = np.linspace(0.5, 2.0, 64).astype(np.float32)
    rv = f.create_random_variable(0.0, vals)
    assert rv.values.values.device.type == "cpu"
    assert rv.get_sample_variance() == pytest.approx(
        float(np.var(vals.astype(np.float64), ddof=1)), rel=1e-5)
    assert rv.get_quantile_expectation(0.25, 0.75) == pytest.approx(
        rv.values.get_quantile_expectation(0.25, 0.75))
    assert np.allclose(rv.get_histogram(interval_points=[0.6, 1.0, 1.5]),
                       rv.values.get_histogram(interval_points=[0.6, 1.0, 1.5]))
    assert rv.equals(rv.values) and rv.getAverage() == rv.get_average()
    applied = rv.apply(lambda v: v * 2.0)
    assert isinstance(applied, RandomVariableDifferentiable)
    assert applied.get_average() == pytest.approx(2.0 * rv.get_average(),
                                                  rel=1e-6)
    g = applied.mult(1.0).average().get_gradient([rv]).get(rv.get_id())
    assert g is None or abs(g.get_average()) == 0.0


# ---------------------------------------------------------------------------
# the eager LMM valuation: tests/test_aad.py's 6-period setup
# ---------------------------------------------------------------------------

DELTAS = [0.5] * 6
L0 = [0.020, 0.025, 0.030, 0.032, 0.034, 0.036]
E, M, STRIKE, VOL, LMM_PATHS = 2, 4, 0.030, 0.012, 20_000


@pytest.fixture(scope="module")
def increments():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((E, LMM_PATHS)) * math.sqrt(0.5)).astype(
        np.float32)


def test_eager_lmm_value_and_vega_match_jax(increments):
    from finmath_tpu.models.lmm.eager import (
        eager_swaption_valuation as jax_valuation)
    from finmath_tpu.ops.random_variable import RandomVariableTPUFactory

    args = (L0, DELTAS)
    v_jax = jax_valuation(RandomVariableTPUFactory(), *args, VOL, increments,
                          E, M, STRIKE).get_average()
    v_port = eager_swaption_valuation(RandomVariableTorchFactory(CPU), *args,
                                      VOL, increments, E, M, STRIKE)
    assert isinstance(v_port, RandomVariableTorch)
    assert v_port.get_average() == pytest.approx(v_jax, rel=1e-5)
    v_float = eager_swaption_valuation(RandomVariableFloatFactory(), *args,
                                       VOL, increments, E, M, STRIKE)
    assert v_float.get_average() == pytest.approx(v_jax, rel=1e-5)

    jf = jax_aad.RandomVariableDifferentiableFactory()
    js = jf.create_random_variable(0.0, VOL)
    vega_jax = _grad(jax_valuation(jf, *args, js, increments, E, M, STRIKE)
                     .average(), js)
    tf = RandomVariableDifferentiableFactory(CPU)
    ts = tf.create_random_variable(0.0, VOL)
    value = eager_swaption_valuation(tf, *args, ts, increments, E, M, STRIKE)
    vega = _grad(value.average(), ts)
    assert value.get_average() == pytest.approx(v_jax, rel=1e-5)
    assert vega != 0.0 and vega == pytest.approx(vega_jax, rel=2e-3)
    # and a central difference of the same valuation on the same increments
    h = 1e-5
    up, down = (eager_swaption_valuation(
        RandomVariableTorchFactory(CPU), *args, VOL + s, increments, E, M,
        STRIKE).get_average() for s in (h, -h))
    assert vega == pytest.approx((up - down) / (2 * h), rel=2e-3)
    with pytest.raises(ValueError):
        eager_swaption_valuation(RandomVariableTorchFactory(CPU), *args, VOL,
                                 increments[:1], E, M, STRIKE)


def test_cap_and_floor_match_jax_caplets():
    from finmath_tpu.models.lmm import atm_calibration as jatm
    from finmath_tpu.models.lmm.model import (
        LMMValuationEngine as JaxEngine, SwaptionProduct as JaxSwaption)

    from finmath_tpu_torch.models.lmm import atm_calibration as tatm
    from finmath_tpu_torch.models.lmm.model import LMMValuationEngine
    from finmath_tpu_torch.models.lmm.products import CapFloor

    paths, first, last, strike = 1024, 2, 12, 0.02
    rng = np.random.default_rng(11)
    inc = (np.sqrt(0.5) * rng.standard_normal((last, 1, paths))).astype(
        np.float32)
    sj = jatm.build_atm_calibration(num_paths=paths, num_factors=1)
    st = tatm.build_atm_calibration(num_paths=paths, num_factors=1, device=CPU)
    x = np.asarray(st.covariance.initial_parameters)
    caplets = JaxEngine(sj.model, [JaxSwaption(e, 1, strike, 0.0,
                                               value_unit="VALUE")
                                   for e in range(first, last)],
                        paths, 1, increments=inc)
    cap_jax = float(np.sum(caplets.values(x)))
    cap = CapFloor(st.model, first, last, strike, num_paths=paths,
                   device=CPU)
    floor = CapFloor(st.model, first, last, strike, is_cap=False,
                     num_paths=paths, device=CPU)
    # both on the JAX engine's increments
    for product in (cap, floor):
        product._engine = LMMValuationEngine(
            st.model, list(product._engine.products), paths, 1, device=CPU,
            increments=inc)
    assert cap.get_value(x) == pytest.approx(cap_jax, rel=1e-5)
    # parity on the curves: floor = cap - swap
    m = st.model
    swap = sum(m.deltas[e] * (float(m.forward_curve.get_forward(
        m.tenor_times[e])) - strike) * float(
        m.discount_curve.get_discount_factor(m.tenor_times[e + 1]))
        for e in range(first, last))
    assert floor.get_value(x) == pytest.approx(cap.get_value(x) - swap,
                                               rel=1e-12)
    with pytest.raises(ValueError):
        CapFloor(st.model, 0, 4, strike, device=CPU)


# ---------------------------------------------------------------------------
# the differentiable Black-Scholes pricer (bench_aad_greeks route 1)
# ---------------------------------------------------------------------------

def _euler_price_reference(seed, paths, steps, s0, sigma, dtype):
    """The Euler loop with its constants formed as host floats and rounded
    to the path dtype (NumPy), the mean divided on the host."""
    as_dtype = np.float32 if dtype == torch.float32 else np.float64
    dt = T / steps
    sqrt_dt = float(as_dtype(math.sqrt(dt)))
    drift = float(as_dtype((R - 0.5 * sigma * sigma) * dt))
    vol = float(as_dtype(sigma))
    gen = torch.Generator(device=CPU)
    gen.manual_seed(seed)
    log_s = torch.full((paths,), math.log(s0), dtype=dtype)
    for _ in range(steps):
        dw = torch.randn(paths, generator=gen, dtype=torch.float32).to(
            dtype) * sqrt_dt
        log_s = log_s + drift + vol * dw
    payoff = torch.clamp_min(torch.exp(log_s) - K, 0.0)
    return float(torch.sum(payoff, dtype=torch.float64)) / paths \
        * math.exp(-R * T)


def test_differentiable_pricer_greeks_against_its_difference_quotient():
    paths, steps, seed = 20_000, 20, 7

    def price(s0, sigma):
        return mc_european_call_price_differentiable(
            seed, paths, steps, s0, R, sigma, T, K, device=CPU)

    s0 = torch.tensor(S0, dtype=torch.float64, requires_grad=True)
    sigma = torch.tensor(SIGMA, dtype=torch.float64, requires_grad=True)
    p = price(s0, sigma)
    assert p.dtype == torch.float64
    delta, vega = (float(g) for g in torch.autograd.grad(p, (s0, sigma)))
    # the price is the plain loop's, bit for bit, in both path dtypes and
    # at an S0 whose logarithm is inexact
    assert float(p.detach()) == _euler_price_reference(
        seed, paths, steps, S0, SIGMA, torch.float32)
    for s0_, dtype in ((0.97, torch.float32), (S0, torch.float64),
                       (0.97, torch.float64)):
        assert mc_european_call_price(
            seed, paths, steps, s0_, R, SIGMA, T, K, dtype=dtype,
            device=CPU) == _euler_price_reference(seed, paths, steps, s0_,
                                                  SIGMA, dtype)
    h = 1e-3
    with torch.no_grad():
        fd_delta = (float(price(S0 + h, SIGMA)) - float(price(S0 - h, SIGMA))) \
            / (2 * h)
        fd_vega = (float(price(S0, SIGMA + h)) - float(price(S0, SIGMA - h))) \
            / (2 * h)
    assert delta == pytest.approx(fd_delta, rel=1e-3)
    assert vega == pytest.approx(fd_vega, rel=1e-3)
