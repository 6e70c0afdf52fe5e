"""The port's structured products (``finmath_tpu_torch/models/
structured_products.py``) against finmath_tpu's, on
``tests/test_structured_products.py``'s market (S0 100, r 5%, sigma 30%,
T 1, 50 steps).

* The host float64 closed forms (forward-start, cliquet, Geske compound,
  chooser, the two-date express certificate): within 1e-12 of the JAX
  ones (the same code; measured equal).
* Each product on the SAME asset matrix (the JAX facade's on 20,000
  ``BrownianMotionFinmathMersenne`` paths, copied with NumPy): the
  autocallables compare the same float32 numbers with the same levels and
  agree within 1e-12 relative (measured at most 3.5e-16); the forward-start
  and cliquet float64 reductions of float32 payoffs within 1e-9 (measured
  at most 1.4e-16; the forward-start's s2 - m s1 is one FMA, as XLA
  contracts it, through ``torch.addcmul``); the compound and chooser,
  whose inner Black-Scholes value is float32 ``log`` and ``erf`` in both
  packages (two implementations), within 1e-6 (measured at most 5.3e-8).
* End to end on the Mersenne paths: within 1e-6 relative (the float32
  log-states are 4 ulps apart, ``tests/test_torch_equity_products.py``;
  measured at most 6.0e-8) plus the payoff of the autocall paths whose
  comparison with a level flips, over N (measured: none).
* The JAX tests' bounds and identities on the port's own torch stream,
  and the validation errors of the JAX module.
* On the Heston facade (``tests/test_structured_products.py:96, 132``):
  the cliquet on the JAX facade's matrix and on the port's own, and the
  compound option's Black-Scholes gate."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import analytic as tanalytic  # noqa: E402
from finmath_tpu_torch.models import black_scholes as tbs  # noqa: E402
from finmath_tpu_torch.models import brownian_motion as tbm  # noqa: E402
from finmath_tpu_torch.models import structured_products as tsp  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

from test_torch_equity_products import (jax_facade,  # noqa: E402
                                        torch_facade)

S0, R, SIG, T = 100.0, 0.05, 0.3, 1.0
STEPS, PATHS, SEED, OWN_PATHS = 50, 20_000, 3141, 50_000
CPU = "cpu"
CLIQUET_TIMES = [0.2, 0.4, 0.6, 0.8, 1.0]
EXPRESS = dict(observation_dates=[0.5, T], autocall_levels=[105.0, 100.0],
               coupons=[0.05, 0.08], protection_level=70.0)
PHOENIX = dict(observation_dates=[0.2, 0.4, 0.6, T],
               autocall_levels=[108.0, 106.0, 104.0, 1e18],
               coupons=[0.03, 0.03, 0.03, 0.05], protection_level=65.0,
               coupon_levels=[85.0, 85.0, 85.0, 85.0], memory=True)

# (id, class name, args, kwargs, relative bound on the same matrix)
PRODUCTS = [
    ("forward-start", "ForwardStartOption", (0.4, T, 1.05), {}, 1e-9),
    ("forward-start-put", "ForwardStartOption", (0.5, T, 0.9, False), {},
     1e-9),
    ("cliquet", "CliquetOption", (CLIQUET_TIMES, -0.05, 0.08), {}, 1e-9),
    ("cliquet-uncapped", "CliquetOption", (CLIQUET_TIMES, -0.05, np.inf),
     {"notional": 2.0}, 1e-9),
    ("compound", "CompoundOption", (0.5, 5.0, T, 100.0), {}, 1e-6),
    ("compound-on-put", "CompoundOption", (0.5, 4.0, T, 95.0, False), {},
     1e-6),
    ("chooser", "ChooserOption", (0.5, T, 100.0), {}, 1e-6),
    ("express", "AutocallableNote", (), EXPRESS, 1e-12),
    ("phoenix-memory", "AutocallableNote", (), PHOENIX, 1e-12),
    ("phoenix-no-memory", "AutocallableNote", (),
     {**PHOENIX, "memory": False, "reference_level": 95.0,
      "notional": 3.0}, 1e-12),
]


def grid():
    return TimeDiscretization(initial=0.0, num_steps=STEPS, step=T / STEPS)


@pytest.fixture(scope="module")
def jax_side():
    from finmath_tpu.models import black_scholes as jbs
    from finmath_tpu.models import brownian_motion as jbm
    from finmath_tpu.models import structured_products as jsp
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    td = JTD(initial=0.0, num_steps=STEPS, step=T / STEPS)
    sim = jbs.MonteCarloBlackScholesModel(
        td, PATHS, jbs.BlackScholesModel(S0, R, SIG),
        brownian=jbm.BrownianMotionFinmathMersenne(td, 1, PATHS, SEED))
    assets = np.asarray(sim.get_asset_values(list(td.as_array()[1:])))
    facade = jax_facade(td, assets, sim.model)
    products = {pid: getattr(jsp, name)(*args, **kw)
                for pid, name, args, kw, _ in PRODUCTS}
    return dict(assets=assets, products=products,
                on_matrix={pid: p.get_value_and_error(facade)
                           for pid, p in products.items()},
                end_to_end={pid: p.get_value_and_error(sim)
                            for pid, p in products.items()})


@pytest.fixture(scope="module")
def own_sim():
    return tbs.MonteCarloBlackScholesModel(
        grid(), OWN_PATHS, tbs.BlackScholesModel(S0, R, SIG), seed=21,
        device=CPU)


def test_closed_forms_match_jax():
    from finmath_tpu.models import structured_products as jsp

    calls = [
        ("forward_start_option_value", (S0, R, SIG, 0.4, T, 1.05)),
        ("forward_start_option_value", (S0, R, SIG, 0.5, T, 0.9, False)),
        ("cliquet_option_value", (R, SIG, CLIQUET_TIMES, -0.05, 0.08)),
        ("cliquet_option_value", (R, SIG, CLIQUET_TIMES, -0.05, np.inf, 2.0)),
        ("compound_option_value", (S0, R, SIG, 0.5, 5.0, T, 100.0)),
        ("compound_option_value", (S0, R, SIG, 0.25, 12.0, 2.0, 90.0)),
        ("chooser_option_value", (S0, R, SIG, 0.5, T, 100.0)),
        ("chooser_option_value", (S0, R, SIG, T - 1e-7, T, 110.0)),
        ("autocallable_value_single_observation",
         (S0, R, SIG, 0.5, T, 105.0, 0.05, 100.0, 0.08, 70.0)),
        ("autocallable_value_single_observation",
         (S0, R, SIG, 0.25, 2.0, 100.0, 0.04, 100.0, 0.1, 60.0, 90.0)),
    ]
    for name, args in calls:
        a = getattr(jsp, name)(*args)
        b = getattr(tsp, name)(*args)
        assert b == pytest.approx(a, rel=1e-12, abs=1e-15), name


VALIDATION = [
    ("ForwardStartOption", (0.0, T)), ("ForwardStartOption", (T, T)),
    ("forward_start_option_value", (S0, R, SIG, T, T, 1.0)),
    ("CliquetOption", ([0.5, 0.25], 0.0, 0.1)),
    ("CliquetOption", ([], 0.0, 0.1)),
    ("CliquetOption", ([0.5], 0.2, 0.1)),
    ("cliquet_option_value", (R, SIG, [0.5], 0.2, 0.1)),
    ("cliquet_option_value", (R, SIG, [0.5, 0.2], 0.0, 0.1)),
    ("CompoundOption", (T, 5.0, T, 100.0)),
    ("compound_option_value", (S0, R, SIG, T, 5.0, 0.5, 100.0)),
    ("ChooserOption", (T, T, 100.0)),
    ("chooser_option_value", (S0, R, SIG, 0.0, T, 100.0)),
    ("AutocallableNote", ([0.5], [100.0], [0.1], 70.0)),
    ("AutocallableNote", ([0.5, 0.25], [100.0] * 2, [0.1] * 2, 70.0)),
    ("AutocallableNote", ([0.5, T], [100.0], [0.1, 0.1], 70.0)),
    ("autocallable_value_single_observation",
     (S0, R, SIG, T, 0.5, 105.0, 0.05, 100.0, 0.08, 70.0)),
    ("autocallable_value_single_observation",
     (S0, R, SIG, 0.5, T, 105.0, 0.05, 100.0, 0.08, 110.0)),
]


@pytest.mark.parametrize("name,args", VALIDATION)
def test_validation_matches_jax(name, args):
    from finmath_tpu.models import structured_products as jsp

    with pytest.raises(Exception) as jerr:
        getattr(jsp, name)(*args)
    with pytest.raises(jerr.type):
        getattr(tsp, name)(*args)


@pytest.mark.parametrize("pid,name,args,kw,rel", PRODUCTS,
                         ids=[p[0] for p in PRODUCTS])
def test_product_on_the_same_asset_matrix(jax_side, pid, name, args, kw,
                                          rel):
    facade = torch_facade(grid(), jax_side["assets"],
                          tbs.BlackScholesModel(S0, R, SIG))
    product = convert.equity_product_from_jax(jax_side["products"][pid])
    assert type(product) is getattr(tsp, name)
    v, e = product.get_value_and_error(facade)
    jv, je = jax_side["on_matrix"][pid]
    assert v == pytest.approx(jv, rel=rel)
    assert e == pytest.approx(je, rel=max(rel, 1e-9))


def test_end_to_end_on_mersenne_paths(jax_side):
    td = grid()
    sim = tbs.MonteCarloBlackScholesModel(
        td, PATHS, tbs.BlackScholesModel(S0, R, SIG),
        brownian=tbm.BrownianMotionFinmathMersenne(td, 1, PATHS, SEED,
                                                   device=CPU))
    ja = jax_side["assets"]
    ta = sim.get_asset_values(list(td.as_array()[1:])).numpy()
    for pid, name, *_ in PRODUCTS:
        product = convert.equity_product_from_jax(jax_side["products"][pid])
        flips = 0
        if name == "AutocallableNote":
            rows = [td.get_time_index(t) - 1 for t in product.dates]
            for lv in (product.autocall_levels + product.coupon_levels
                       + [product.protection_level]):
                flips += int(np.sum(np.any(
                    (ja[rows] >= np.float32(lv)) != (ta[rows] >= np.float32(
                        lv)), axis=0)))
        v, e = product.get_value_and_error(sim)
        jv, je = jax_side["end_to_end"][pid]
        envelope = flips * 1.2 * product.notional / PATHS if flips else 0.0
        assert abs(v - jv) <= 1e-6 * abs(jv) + envelope, (pid, v, jv, flips)


def test_bounds_and_identities_on_the_port_stream(own_sim):
    sim = own_sim
    for m, call in ((1.0, True), (1.1, True), (0.9, False)):
        v, e = tsp.ForwardStartOption(0.4, T, m, call).get_value_and_error(
            sim)
        an = tsp.forward_start_option_value(S0, R, SIG, 0.4, T, m, call)
        assert abs(v - an) < 4 * e
    v, e = tsp.CliquetOption(CLIQUET_TIMES, -0.05, 0.08).get_value_and_error(
        sim)
    assert abs(v - tsp.cliquet_option_value(R, SIG, CLIQUET_TIMES, -0.05,
                                            0.08)) < 4 * e
    v, e = tsp.CliquetOption(CLIQUET_TIMES, -np.inf, np.inf) \
        .get_value_and_error(sim)
    an = math.exp(-R * T) * 5 * (math.exp(R * 0.2) - 1.0)
    assert abs(v - an) < 4 * e
    v, e = tsp.CliquetOption(CLIQUET_TIMES, 0.01, 0.01).get_value_and_error(
        sim)
    assert abs(v - math.exp(-R * T) * 0.05) < 1e-7 and e < 1e-9
    v, e = tsp.CompoundOption(0.5, 5.0, T, 100.0).get_value_and_error(sim)
    assert abs(v - tsp.compound_option_value(S0, R, SIG, 0.5, 5.0, T,
                                             100.0)) < 4 * e
    v, e = tsp.CompoundOption(0.5, 0.0, T, 100.0).get_value_and_error(sim)
    an = tanalytic.black_scholes_option_value(S0, R, SIG, T, 100.0)
    assert abs(v - an) < 4 * e + 2e-3 * an
    v, e = tsp.ChooserOption(0.5, T, 100.0).get_value_and_error(sim)
    an = tsp.chooser_option_value(S0, R, SIG, 0.5, T, 100.0)
    assert abs(v - an) < 4 * e + 1e-3 * an
    assert v > max(an - tanalytic.black_scholes_option_value(
        S0, R, SIG, 0.5, 100.0 * math.exp(-R * 0.5), is_call=False),
        tanalytic.black_scholes_option_value(S0, R, SIG, T, 100.0,
                                             is_call=False)) - 1e-6
    v, e = tsp.AutocallableNote(**EXPRESS).get_value_and_error(sim)
    an = tsp.autocallable_value_single_observation(
        S0, R, SIG, 0.5, T, 105.0, 0.05, 100.0, 0.08, 70.0)
    assert abs(v - an) < 4 * e + 1e-4
    v_mem = tsp.AutocallableNote(**PHOENIX).get_value(sim)
    v_no = tsp.AutocallableNote(**{**PHOENIX, "memory": False}).get_value(
        sim)
    assert v_mem >= v_no - 1e-9
    v = tsp.AutocallableNote([0.5, T], [1e18, 1e18], [0.0, 0.0], 0.0) \
        .get_value(sim)
    assert v >= math.exp(-R * T) - 1e-4
    v = tsp.AutocallableNote([0.2, T], [1e-6, 100.0], [0.04, 0.0], 50.0) \
        .get_value(sim)
    assert abs(v - 1.04 * math.exp(-R * 0.2)) < 1e-6


def test_bs_value_vec_is_float32_black_scholes():
    s = torch.linspace(60.0, 140.0, 81)
    for call in (True, False):
        got = tsp._bs_value_vec(s, R, SIG, 0.5, 100.0, call)
        assert got.dtype == torch.float32
        want = [tanalytic.black_scholes_option_value(float(x), R, SIG, 0.5,
                                                     100.0, call) for x in s]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_inner_closed_forms_need_black_scholes(own_sim):
    from types import SimpleNamespace

    facade = SimpleNamespace(model=SimpleNamespace(initial_value=S0),
                             get_asset_value=own_sim.get_asset_value,
                             get_numeraire=own_sim.get_numeraire)
    for product in (tsp.CompoundOption(0.5, 5.0, T, 100.0),
                    tsp.ChooserOption(0.5, T, 100.0)):
        with pytest.raises(NotImplementedError):
            product.get_value(facade)


# -- the Heston facade (tests/test_structured_products.py:96, 132) -----------------

HESTON = dict(initial_value=S0, risk_free_rate=R, v0=0.04, kappa=1.5,
              theta=0.05, xi=0.4, rho=-0.6)


def test_heston_facade_runs_cliquet_and_gates_compound():
    """The cliquet on the JAX Heston facade's asset matrix (its own stream,
    20 steps, 50,000 paths, seed 5) equal in both packages within 1e-9,
    and on the port's own Heston facade finite with a standard error below
    0.01; the compound option needs the Black-Scholes facade."""
    from finmath_tpu.models import heston as jh
    from finmath_tpu.models import structured_products as jsp
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)
    from finmath_tpu_torch.models import heston as th

    jtd = JTD(initial=0.0, num_steps=20, step=T / 20)
    td = TimeDiscretization(initial=0.0, num_steps=20, step=T / 20)
    jsim = jh.MonteCarloHestonModel(jtd, 50_000, jh.HestonParams(**HESTON),
                                    seed=5)
    assets = np.asarray(jsim.get_asset_values(list(jtd.as_array()[1:])))
    jcliq = jsp.CliquetOption([0.25, 0.5, 0.75, 1.0], -0.05, 0.08)
    jv, je = jcliq.get_value_and_error(jax_facade(jtd, assets, jsim.model))
    cliq = convert.equity_product_from_jax(jcliq)
    v, e = cliq.get_value_and_error(torch_facade(
        td, assets, th.HestonModel(th.HestonParams(**HESTON))))
    assert v == pytest.approx(jv, rel=1e-9)
    assert e == pytest.approx(je, rel=1e-9)
    sim = th.MonteCarloHestonModel(td, 50_000, th.HestonParams(**HESTON),
                                   seed=5, device=CPU)
    v, e = cliq.get_value_and_error(sim)
    assert np.isfinite(v) and e < 0.01
    small = th.MonteCarloHestonModel(
        TimeDiscretization(initial=0.0, num_steps=4, step=0.25), 1_000,
        th.HestonParams(**HESTON), device=CPU)
    with pytest.raises(NotImplementedError):
        tsp.CompoundOption(0.5, 5.0, T, 100.0).get_value(small)
