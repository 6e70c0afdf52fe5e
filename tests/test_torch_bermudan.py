"""The port's Longstaff-Schwartz Bermudan swaption
(``models/lmm/bermudan.py``) against finmath_tpu's, on the ATM setup
(80 libors, 1 factor) at 4,000 paths and one injected realization
(seeded NumPy, sqrt(dt)-scaled) for pricing and another for the bounds.

The JAX pricer draws its own Threefry paths inside ``_price_fn`` (its
``_collect_exercise_data`` calls the engine's ``_simulate_collect``
without increments), so the test rebuilds its ``_engine`` and
``_bounds_engine`` with ``increments=`` and a ``_simulate_collect`` that
passes them on, and rebuilds ``_price_fn`` and ``_bounds_fn`` from them;
``bermudan.py`` is used as it is. The port's pricer gets the same
increments the same way: its two engines are rebuilt with ``increments=``.

Precision contract of the collector, held exactly: the swap value is
formed in float32 (it is the swap feature) and z is that float32 value
times the float64 reciprocal numeraire, bit for bit, h = max(z, 0); a
collector that formed the swap value in float64 fails this, as
``test_float64_collector_fails_the_contract`` shows. Against the JAX
package the discounted swap values z and h per exercise date agree within
32 float32 ulps of the date's max |z| (23.6 measured: the two float32
collectors differ only in order of operations, the JAX package's cumprod
being an associative scan on the CPU and its annuity an XLA dot, and the
forwards of the two Euler sweeps differ by rounding after up to 16
steps), the features within 1e-6 of their largest value (at least 1); the
two fitted policies' betas within
1e-2 of the largest coefficient and their continuation values on the same
features within 5e-4 of the largest (the annuity varies little across
paths, so the Gram matrix of {1, annuity, swap, swap^2} has a condition
number of 1e11..1e12 here, and the fit passes the features' rounding on
to the coefficients: 1.6e-3 and 1.8e-4 measured); the price within 1e-6
absolute; the bounds with the JAX-fitted policy carried across by
``convert.betas_from_numpy`` within 1e-6 absolute. The remaining cases are
the JAX package's own (tests/test_bermudan.py), on the port with 3e-4 for
Monte-Carlo slack."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models.curves import par_swap_rate  # noqa: E402
from finmath_tpu_torch.models.lmm import atm_calibration as tatm  # noqa: E402
from finmath_tpu_torch.models.lmm.bermudan import (  # noqa: E402
    BermudanSwaption, BermudanSwaptionPricer)
from finmath_tpu_torch.models.lmm.model import (  # noqa: E402
    LIBORMarketModelTorch, LMMValuationEngine, SwaptionProduct)

PATHS, STEPS, CPU = 4000, 20, "cpu"
EXERCISES, MATURITY, STRIKE = (4, 8, 12, 16), 20, 0.01


def _increments(seed):
    rng = np.random.default_rng(seed)
    return (np.sqrt(0.5) * rng.standard_normal((STEPS, 1, PATHS))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def port():
    st = tatm.build_atm_calibration(num_paths=PATHS, num_factors=1,
                                    device=CPU)
    return st, np.asarray(st.covariance.initial_parameters)


@pytest.fixture(scope="module")
def both(port):
    import jax
    import jax.numpy as jnp
    from finmath_tpu.models.lmm import atm_calibration as jatm
    from finmath_tpu.models.lmm.bermudan import (
        BermudanSwaption as JaxBermudan,
        BermudanSwaptionPricer as JaxPricer)
    from finmath_tpu.models.lmm.model import LMMValuationEngine as JaxEngine

    st, x = port
    inc, inc2 = _increments(7), _increments(8)
    sj = jatm.build_atm_calibration(num_paths=PATHS, num_factors=1)
    jprod = JaxBermudan(EXERCISES, MATURITY, STRIKE)
    jp = JaxPricer(sj.model, jprod, PATHS, 1)

    def injected(increments, seed):
        engine = JaxEngine(sj.model, list(jp._engine.products), PATHS, 1,
                           seed, increments=increments, scan_mode="fused")
        simulate = engine._simulate_collect
        engine._simulate_collect = (
            lambda params, collect: simulate(params, collect,
                                             inc=engine._inc_dev))
        return engine

    jp._engine = injected(inc, jp.seed)
    jp._price_fn = jax.jit(jp._build_price_fn(jp._engine))
    jp._bounds_engine = injected(inc2, jp.seed + 1)
    jp._bounds_fn = jax.jit(jp._build_bounds_fn(jp._bounds_engine))
    xj = jnp.asarray(x)
    value_j, betas_j = jp._price_fn(xj)
    lo_j, hi_j = jp._bounds_fn(xj, betas_j)

    tp = BermudanSwaptionPricer(st.model, convert.bermudan_swaption_from_jax(
        jprod), PATHS, 1, device=CPU)
    products = list(tp._engine.products)
    tp._engine = LMMValuationEngine(st.model, products, PATHS, 1, tp.seed,
                                    device=CPU, increments=inc)
    tp._bounds_engine = LMMValuationEngine(st.model, products, PATHS, 1,
                                           tp.seed + 1, device=CPU,
                                           increments=inc2)
    return dict(
        jax=dict(pricer=jp, x=xj, value=float(value_j),
                 betas=tuple(np.asarray(b) for b in betas_j),
                 bounds=(float(lo_j), float(hi_j))),
        port=dict(pricer=tp, x=x))


def _numeraires(engine, params):
    return engine._simulate_collect(params, lambda e, ev, L, N: N)


def _float32_contract(data, numeraires) -> bool:
    """z is the float32 swap feature times the float64 reciprocal
    numeraire, bit for bit, and h = max(z, 0)."""
    return all(
        ft.dtype == torch.float32
        and torch.equal(zt, ft[2].double() * (1.0 / n))
        and torch.equal(ht, torch.clamp_min(zt, 0.0))
        for (zt, ht, ft), n in zip(data, numeraires))


def test_exercise_data_match_jax(both):
    jp, xj = both["jax"]["pricer"], both["jax"]["x"]
    tp, x = both["port"]["pricer"], both["port"]["x"]
    params = tp._engine._params(x)
    data_j = jp._collect_exercise_data(jp._engine, xj)
    data_t = tp._collect_exercise_data(tp._engine, params)
    assert len(data_t) == len(EXERCISES)
    assert _float32_contract(data_t, _numeraires(tp._engine, params))
    for (zj, hj, fj), (zt, ht, ft) in zip(data_j, data_t):
        assert zt.dtype == torch.float64 and ft.dtype == torch.float32
        assert ft.shape == (4, PATHS)
        ulps = 32 * np.spacing(np.float32(np.max(np.abs(np.asarray(zj)))))
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0,
                                   atol=ulps)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                                   atol=ulps)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0,
                                   atol=1e-6 * max(1.0, float(np.max(
                                       np.abs(np.asarray(fj))))))


def test_policy_and_price_match_jax(both):
    from finmath_tpu_torch.ops.conditional_expectation import (
        regression_predict)

    tp, x = both["port"]["pricer"], both["port"]["x"]
    value, betas, _ = tp._price(x)
    assert abs(float(value) - both["jax"]["value"]) <= 1e-6
    data_t = tp._collect_exercise_data(tp._engine, tp._engine._params(x))
    for k, (bj, bt) in enumerate(zip(both["jax"]["betas"], betas)):
        assert bt.dtype == torch.float64
        np.testing.assert_allclose(bt.numpy(), bj, rtol=0,
                                   atol=1e-2 * np.max(np.abs(bj)))
        feats = data_t[k][2]
        cont_t = regression_predict(feats, bt).numpy()
        cont_j = regression_predict(feats, torch.from_numpy(bj.copy())).numpy()
        np.testing.assert_allclose(cont_t, cont_j, rtol=0,
                                   atol=5e-4 * np.max(np.abs(cont_j)))
    # the JAX-fitted policy applied to the port's paths prices the same
    jbetas = convert.betas_from_numpy(both["jax"]["betas"])
    assert abs(tp.get_value(x, betas=jbetas) - both["jax"]["value"]) <= 1e-6


def test_bounds_with_jax_policy_match_jax(both):
    tp, x = both["port"]["pricer"], both["port"]["x"]
    lo_j, hi_j = both["jax"]["bounds"]
    lo, hi = tp.get_value_bounds(
        x, betas=convert.betas_from_numpy(both["jax"]["betas"]))
    assert abs(lo - lo_j) <= 1e-6 and abs(hi - hi_j) <= 1e-6
    # the port's own policy brackets its price, as the JAX tests demand
    v = tp.get_value(x)
    lo, hi = tp.get_value_bounds(x)
    assert lo <= hi and lo - 3e-4 <= v <= hi + 3e-4
    assert hi - lo < 0.25 * max(v, 1e-4)
    stop = tp._price(x)[2]
    shares = [float(torch.mean((stop == k).double()))
              for k in range(len(EXERCISES))]
    assert 0.0 < sum(shares) <= 1.0


def test_float64_collector_fails_the_contract(both):
    """The contract check rejects the European collector's choice: the same
    collector fed float64 forwards and deltas forms the swap value in
    float64, and rounding its features to float32 afterwards breaks z on
    most paths."""
    tp, x = both["port"]["pricer"], both["port"]["x"]
    engine = tp._engine
    params = engine._params(x)
    states = engine._simulate_collect(params, lambda e, ev, L, N: (L, N))

    class Float64Engine:
        _t = {"deltas32": engine._t["deltas32"].double()}

        @staticmethod
        def _simulate_collect(params, collect):
            return [collect(e, k, L.double(), N) for k, (e, (L, N))
                    in enumerate(zip(EXERCISES, states))]

    data = tp._collect_exercise_data(Float64Engine, params)
    numeraires = [n for _, n in states]
    assert not _float32_contract(data, numeraires)
    rounded = [(z, h, f.float()) for z, h, f in data]
    assert not _float32_contract(rounded, numeraires)
    for (z, _, f), n in zip(rounded, numeraires):
        assert torch.mean((z != f[2].double() * (1.0 / n)).double()) > 0.5


def test_single_exercise_equals_european(port):
    st, x = port
    model = st.model
    e, m = 10, 10
    strike = par_swap_rate(model.forward_curve, model.discount_curve,
                           model.tenor_times[e:e + m + 1])
    pricer = BermudanSwaptionPricer(
        model, BermudanSwaption((e,), e + m, strike), PATHS, 1, device=CPU)
    engine = LMMValuationEngine(
        model, [SwaptionProduct(e, m, strike, 0.0, value_unit="VALUE")],
        PATHS, 1, device=CPU, increments=pricer._engine.increments)
    assert pricer.get_value(x) == pytest.approx(engine.values(x)[0], abs=3e-4)
    # single-exercise bounds are degenerate
    lo, hi = pricer.get_value_bounds(x)
    assert lo == hi == pricer.get_value(x)


def test_more_exercise_rights_worth_more(port):
    st, x = port
    model = st.model
    e, m = 10, 10
    strike = par_swap_rate(model.forward_curve, model.discount_curve,
                           model.tenor_times[e:e + m + 1])
    v1 = BermudanSwaptionPricer(
        model, BermudanSwaption((e,), e + m, strike), PATHS, 1,
        device=CPU).get_value(x)
    v4 = BermudanSwaptionPricer(
        model, BermudanSwaption((e, e + 2, e + 4, e + 6), e + m, strike),
        PATHS, 1, device=CPU).get_value(x)
    assert v4 >= v1 - 1e-4


def test_deterministic_and_deep_otm(port):
    st, x = port
    pricer = BermudanSwaptionPricer(
        st.model, BermudanSwaption((4, 6), 12, 0.01), PATHS, 1, device=CPU)
    assert pricer.get_value(x) == pricer.get_value(x)
    deep = BermudanSwaptionPricer(
        st.model, BermudanSwaption((4, 6, 8), 12, 0.15), PATHS, 1, device=CPU)
    assert deep.get_value(x) >= 0.0


def test_invalid_exercise_and_terminal_measure(port):
    with pytest.raises(ValueError):
        BermudanSwaption((12,), 12, 0.01)
    m = port[0].model
    terminal = LIBORMarketModelTorch(m.libor_td, m.forward_curve,
                                     m.discount_curve, m.covariance,
                                     measure="terminal")
    # the terminal measure prices the same Bermudan on the same paths
    # within Monte-Carlo slack of the spot measure
    product = BermudanSwaption((6, 8), 14, 0.02)
    x = port[1]
    v_term = BermudanSwaptionPricer(terminal, product, PATHS, 1,
                                    device=CPU).get_value(x)
    v_spot = BermudanSwaptionPricer(m, product, PATHS, 1,
                                    device=CPU).get_value(x)
    assert v_term >= 0.0 and v_term == pytest.approx(v_spot, abs=3e-4)
