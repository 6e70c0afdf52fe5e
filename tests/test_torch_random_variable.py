"""The port's vector engine against finmath_tpu's: the JAX parity sweep's
inputs (seeded NumPy, 50,000 paths) through ``RandomVariableTPU`` and the
port's ``RandomVariableTorch(device="cpu")``, one case per operation, at
the JAX sweep's tolerances (tests/test_random_variable_parity.py:28,
184-262): 1e-7 * max(1, |x|), 2.5e-7 for the division family, exp, sin and
cos, 5e-7 for sqrt, log and invert, 1.5e-6 for pow. Both sides compute in
float32 (the port with torch's exp/log/pow, the JAX package with its
precise_math), so the bounds are the ULP envelopes of two float32 math
libraries. Also: the float64 reductions to 1e-12 relative, the
deterministic fast path, the filtration-time rule, type-priority dispatch
against the port's float oracle, and ``convert``'s round trip."""

import math
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu.ops.random_variable import RandomVariableTPU  # noqa: E402
from finmath_tpu.ops.random_variable_float import (  # noqa: E402
    RandomVariableFloat as JaxRandomVariableFloat)

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.ops import (RandomVariableFloat,  # noqa: E402
                                   RandomVariableFloatFactory,
                                   RandomVariableTorch,
                                   RandomVariableTorchFactory)

RTOL = 1e-7
N_PATHS, SEED = 50_000, 3141
CPU = "cpu"


def _uniforms(n=N_PATHS, lo=-1.0, hi=1.0, seed=SEED):
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random(n)).astype(np.float32)


def _torch(vals, time=0.0):
    return RandomVariableTorch(time, vals, device=CPU)


@pytest.fixture(scope="module")
def inputs():
    a = _uniforms(N_PATHS, -1.0, 1.0)
    b = _uniforms(N_PATHS, 0.1, 2.1, seed=SEED + 1)
    return {"jax": (RandomVariableTPU(0.0, a), RandomVariableTPU(0.0, b)),
            "torch": (_torch(a), _torch(b))}


# (id, operation on (x, y), tolerance); the positive-domain operations
# act on y, in [0.1, 2.1)
OPS = [
    ("squared", lambda x, y: x.squared(), RTOL),
    ("addScalar", lambda x, y: x.add(1.0), RTOL),
    ("subScalar", lambda x, y: x.sub(0.5), RTOL),
    ("busScalar", lambda x, y: x.bus(0.5), RTOL),
    ("multScalar", lambda x, y: x.mult(3.14159), RTOL),
    ("divScalar", lambda x, y: x.div(2.71828), 2.5e-7),
    ("vidScalar", lambda x, y: x.vid(2.71828), 2.5e-7),
    ("capScalar", lambda x, y: x.cap(0.2), RTOL),
    ("floorScalar", lambda x, y: x.floor(-0.2), RTOL),
    ("exp", lambda x, y: x.exp(), 2.5e-7),
    ("abs", lambda x, y: x.abs(), RTOL),
    ("sin", lambda x, y: x.sin(), 2.5e-7),
    ("cos", lambda x, y: x.cos(), 2.5e-7),
    ("geZero", lambda x, y: x.ge_zero(), RTOL),
    ("isNaN", lambda x, y: x.is_nan(), RTOL),
    ("add", lambda x, y: x.add(y), RTOL),
    ("sub", lambda x, y: x.sub(y), RTOL),
    ("bus", lambda x, y: x.bus(y), RTOL),
    ("mult", lambda x, y: x.mult(y), RTOL),
    ("div", lambda x, y: x.div(y), 2.5e-7),
    ("vid", lambda x, y: x.vid(y), 2.5e-7),
    ("cap", lambda x, y: x.cap(y), RTOL),
    ("floor", lambda x, y: x.floor(y), RTOL),
    ("accrue", lambda x, y: x.accrue(y, 0.25), RTOL),
    ("discount", lambda x, y: x.discount(y, 0.25), 2.5e-7),
    ("addProduct_vs", lambda x, y: x.add_product(y, 2.0), RTOL),
    ("addProduct_vv", lambda x, y: x.add_product(y, y), RTOL),
    ("addRatio", lambda x, y: x.add_ratio(y, y.add(3.0)), 2.5e-7),
    ("subRatio", lambda x, y: x.sub_ratio(y, y.add(3.0)), 2.5e-7),
    ("choose", lambda x, y: x.choose(y, y.mult(-1.0)), RTOL),
    ("addSumProduct", lambda x, y: x.add_sum_product([y, x], [x, y]), RTOL),
    ("apply", lambda x, y: x.apply(lambda a, b: a * a + 2.0 * b, y), RTOL),
    ("sqrt", lambda x, y: y.sqrt(), 5e-7),
    ("log", lambda x, y: y.log(), 5e-7),
    ("invert", lambda x, y: y.invert(), 5e-7),
    ("pow", lambda x, y: y.pow(1.5), 1.5e-6),
]


@pytest.mark.parametrize("op,rtol", [(op, rtol) for _, op, rtol in OPS],
                         ids=[name for name, _, _ in OPS])
def test_operation_matches_jax(inputs, op, rtol):
    a = op(*inputs["jax"])
    b = op(*inputs["torch"])
    assert isinstance(b, RandomVariableTorch)
    assert b.values.dtype == torch.float32 and b.size() == N_PATHS
    av = np.asarray(a.get_realizations(), dtype=np.float64)
    bv = b.get_realizations().astype(np.float64)
    assert np.array_equal(np.isnan(av), np.isnan(bv))
    ok = np.isfinite(av)
    tol = rtol * np.maximum(1.0, np.abs(av[ok]))
    diff = np.abs(av[ok] - bv[ok])
    assert np.all(diff <= tol), (diff.max(), np.argmax(diff - tol))
    assert b.get_filtration_time() == a.get_filtration_time()


def test_reductions_match_jax(inputs):
    """float32 input, float64 accumulation on both sides: the sums differ
    only in their float64 summation order."""
    (ja, jb), (ta, tb) = inputs["jax"], inputs["torch"]
    w = np.full(N_PATHS, 1.0 / N_PATHS, dtype=np.float32)
    pairs = [
        (ja.get_average(), ta.get_average()),
        (ja.get_variance(), ta.get_variance()),
        (ja.get_sample_variance(), ta.get_sample_variance()),
        (ja.get_standard_deviation(), ta.get_standard_deviation()),
        (ja.get_standard_error(), ta.get_standard_error()),
        (ja.get_average(RandomVariableTPU(0.0, w)),
         ta.get_average(_torch(w))),
        (ja.get_variance(RandomVariableTPU(0.0, w)),
         ta.get_variance(_torch(w))),
        (jb.get_quantile_expectation(0.1, 0.9),
         tb.get_quantile_expectation(0.1, 0.9)),
    ]
    for a, b in pairs:
        assert b == pytest.approx(a, rel=1e-12, abs=1e-15)
    for q in (0.0, 0.075, 0.5, 0.99, 1.0):
        assert tb.get_quantile(q) == jb.get_quantile(q)
    assert tb.get_quantile(0.3, _torch(w)) == jb.get_quantile(
        0.3, RandomVariableTPU(0.0, w))
    assert (tb.get_min(), tb.get_max()) == (jb.get_min(), jb.get_max())
    np.testing.assert_array_equal(
        tb.get_histogram(interval_points=[-0.5, 0.0, 0.7, 1.5]),
        jb.get_histogram(interval_points=[-0.5, 0.0, 0.7, 1.5]))
    np.testing.assert_allclose(
        tb.get_histogram(number_of_points=7, standard_deviations=2.0),
        jb.get_histogram(number_of_points=7, standard_deviations=2.0),
        rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n", [2, 1023, 1025, 200_000])
def test_average_awkward_sizes(n):
    vals = (np.arange(n, dtype=np.float64) / n).astype(np.float32)
    assert _torch(vals).get_average() == pytest.approx(
        float(np.mean(vals.astype(np.float64))), rel=1e-12)


class TestDeterministicFastPath:
    def test_scalar_algebra_matches_jax(self):
        for cls, kw in ((RandomVariableTPU, {}),
                        (RandomVariableTorch, {"device": CPU})):
            x = cls(0.0, 2.0, **kw)
            y = x.add(3.0).mult(2.0).sub(4.0).div(2.0)
            assert y.is_deterministic() and y.double_value() == 3.0
        t = RandomVariableTorch(0.0, 2.0, device=CPU)
        j = RandomVariableTPU(0.0, 2.0)
        for op in (lambda x: x.exp(), lambda x: x.log(), lambda x: x.sqrt(),
                   lambda x: x.invert(), lambda x: x.bus(10.0),
                   lambda x: x.vid(10.0), lambda x: x.cap(1.5),
                   lambda x: x.floor(2.5), lambda x: x.pow(3.0),
                   lambda x: x.sin(), lambda x: -x, lambda x: 3.0 / x,
                   lambda x: x ** 2, lambda x: 1.0 - x):
            assert op(t).is_deterministic()
            assert op(t).double_value() == op(j).double_value()

    def test_no_device_work_and_errors(self):
        x = RandomVariableTorch(1.5, 7.0)          # no device needed
        assert x.is_deterministic() and x.size() == 1
        assert x.get_average() == 7.0 and x.get_variance() == 0.0
        assert x.get_standard_error() == 0.0
        assert (x.get_min(), x.get_max(), x.get_quantile(0.3)) == (7.0,) * 3
        with pytest.raises(ValueError):
            x.get_realizations()
        with pytest.raises(ValueError):
            _torch(np.ones(3, np.float32)).double_value()
        # the reference's IEEE semantics: NaN and signed infinity, no raise
        assert math.isnan(RandomVariableTorch(0.0, -1.0).log().double_value())
        assert RandomVariableTorch(0.0, 0.0).invert().double_value() == math.inf
        assert RandomVariableTorch(0.0, -1.0).div(
            RandomVariableTorch(0.0, 0.0)).double_value() == -math.inf

    def test_stochastic_special_values_match_jax(self):
        v = _uniforms()                     # the sweep's shape: no recompile
        v[:3] = [-1.0, 0.0, 1.0]
        for op in (lambda x: x.log(), lambda x: x.invert(),
                   lambda x: x.log().is_nan()):
            a = np.asarray(op(RandomVariableTPU(0.0, v)).get_realizations())
            b = op(_torch(v)).get_realizations()
            np.testing.assert_array_equal(b[:3], a[:3])   # NaN, -inf/inf, 0
            np.testing.assert_array_equal(np.isnan(b), np.isnan(a))


def test_filtration_time_rule():
    a = _torch(_uniforms(16), time=1.0)
    b = RandomVariableTorch(3.0, 4.0)
    c = RandomVariableTorch(2.0, 1.5)
    assert a.add(b).get_filtration_time() == 3.0
    assert b.mult(a).get_filtration_time() == 3.0
    assert a.add_product(c, b).get_filtration_time() == 3.0
    assert a.discount(c, 0.5).get_filtration_time() == 2.0
    assert a.choose(b, c).get_filtration_time() == 3.0
    assert a.add_ratio(c, b).get_filtration_time() == 3.0
    assert a.apply(lambda x, y: x + y, c).get_filtration_time() == 2.0
    assert a.exp().get_filtration_time() == 1.0


class TestTypePriority:
    """Mixed float-oracle / device operands resolve to the device type, with
    the non-commutative operations flipped."""

    def test_mixed_operations_match_jax(self):
        u = np.asarray([1.0, 2.0, -3.0], np.float32)
        v = np.asarray([10.0, 20.0, 0.5], np.float32)
        for op in (lambda x, y: x.add(y), lambda x, y: x.sub(y),
                   lambda x, y: x.div(y), lambda x, y: x.bus(y),
                   lambda x, y: x.vid(y), lambda x, y: x.cap(y),
                   lambda x, y: x.add_product(y, 2.0),
                   lambda x, y: x.discount(y, 0.5),
                   lambda x, y: x.choose(y, y.mult(2.0))):
            r = op(RandomVariableFloat(0.0, u), _torch(v))
            assert isinstance(r, RandomVariableTorch)
            j = op(JaxRandomVariableFloat(0.0, u), RandomVariableTPU(0.0, v))
            np.testing.assert_allclose(r.get_realizations(),
                                       np.asarray(j.get_realizations()),
                                       rtol=RTOL)
        assert RandomVariableFloat(0.0, 1.0).get_type_priority() == 1
        assert RandomVariableTorch(0.0, 1.0).get_type_priority() == 20

    def test_float_oracle_is_the_jax_packages(self, inputs):
        """The port's copy of the NumPy oracle: bit for bit the JAX
        package's, Kahan sums included."""
        a, b = _uniforms(), _uniforms(N_PATHS, 0.1, 2.1, seed=SEED + 1)
        for op in (lambda x, y: x.exp().add_ratio(y, y.add(3.0)),
                   lambda x, y: x.choose(y.log(), y.pow(1.5))):
            np.testing.assert_array_equal(
                op(RandomVariableFloat(0.0, a),
                   RandomVariableFloat(0.0, b)).get_realizations(),
                op(JaxRandomVariableFloat(0.0, a),
                   JaxRandomVariableFloat(0.0, b)).get_realizations())
        x, jx = RandomVariableFloat(0.0, b), JaxRandomVariableFloat(0.0, b)
        assert x.get_average() == jx.get_average()
        assert x.get_variance() == jx.get_variance()
        # the oracle and the device type agree as the JAX sweep requires
        assert _torch(b).get_average() == pytest.approx(x.get_average(),
                                                        rel=1e-12)


class TestApiSurface:
    def test_convert_round_trip_with_jax(self):
        vals = _uniforms()
        j = RandomVariableTPU(2.5, vals)
        t = convert.random_variable_from_numpy(
            j.get_filtration_time(), np.asarray(j.get_realizations()), CPU)
        assert isinstance(t, RandomVariableTorch)
        assert t.values.device.type == "cpu"
        time, back = convert.random_variable_to_numpy(t.exp())
        assert time == 2.5 and back.dtype == np.float32
        np.testing.assert_allclose(
            back, np.asarray(RandomVariableTPU(time, vals).exp()
                             .get_realizations()), rtol=2.5e-7)
        d = convert.random_variable_from_numpy(1.0, 3.5, CPU)
        assert d.is_deterministic()
        assert convert.random_variable_to_numpy(d) == (1.0, 3.5)
        with pytest.raises(ValueError):
            convert.random_variable_from_numpy(0.0, np.ones((2, 2)), CPU)

    def test_pickle_factories_and_aliases(self):
        vals = _uniforms(100)
        rv = _torch(vals, time=2.5)
        rv2 = pickle.loads(pickle.dumps(rv))
        assert rv2.get_filtration_time() == 2.5
        np.testing.assert_array_equal(rv2.get_realizations(), vals)
        det = pickle.loads(pickle.dumps(RandomVariableTorch(1.0, 4.0,
                                                            device=CPU)))
        assert det.double_value() == 4.0 and det.device.type == "cpu"
        f = RandomVariableTorchFactory(device=CPU)
        assert f.createRandomVariable(0.5, vals).values.device.type == "cpu"
        assert isinstance(RandomVariableFloatFactory().create_random_variable(
            0.0, vals), RandomVariableFloat)
        assert rv.getAverage() == rv.get_average()
        assert rv.getFiltrationTime() == 2.5 and not rv.isDeterministic()
        assert rv.equals(_torch(vals, time=2.5))
        assert not rv.equals(_torch(vals, time=1.0))
        assert rv.get(3) == float(vals[3])
        assert list(rv.get_realizations_stream())[:2] == list(vals[:2])

    def test_device_default_and_unported(self, monkeypatch):
        monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
        if not torch.cuda.is_available():
            # host values need a device: no quiet CPU fallback
            with pytest.raises(RuntimeError, match='device="cpu"'):
                RandomVariableTorch(0.0, np.ones(3, np.float32))
        # a tensor keeps its device
        t = RandomVariableTorch(0.0, torch.ones(3))
        assert t.values.device.type == "cpu"
        # the regression hook delegates to its estimator (it raised before
        # ops/conditional_expectation.py was ported): the constant basis
        # fits the mean
        from finmath_tpu_torch.ops.conditional_expectation import (
            MonteCarloConditionalExpectationRegression)
        est = MonteCarloConditionalExpectationRegression(
            [RandomVariableTorch(0.0, 1.0, device=CPU)])
        fit = t.get_conditional_expectation(est)
        assert fit.values.device.type == "cpu"
        assert torch.equal(fit.values, torch.ones(3))
