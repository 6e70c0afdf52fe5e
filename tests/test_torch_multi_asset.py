"""The port's multi-asset Black-Scholes model and rainbow products
(``finmath_tpu_torch/models/multi_asset.py``) against finmath_tpu's, on
``bench.py:1781-1806``'s three-asset market (S0 100, 95, 105; vols 25%,
35%, 20%; the 3x3 correlation; r 5%; T 1.5 over 30 steps).

* The host float64 closed forms (bivariate normal CDF, Margrabe, Stulz,
  Kirk, the geometric basket): within 1e-12 of the JAX ones (the same
  NumPy code; measured equal).
* Each product on the SAME ``[assets, paths]`` matrix (the JAX facade's,
  copied with NumPy, through a facade over given matrices): the float64
  reductions of float32 payoffs within 1e-9 relative (measured at most
  4.2e-16).
* The facades end to end on one ``BrownianMotionFinmathMersenne``
  realization with three factors (20,000 paths, seed 3141): the log-states
  within 8 float32 ulps (measured at most 5; XLA contracts the JAX
  step's three-factor contraction into FMAs, the port sums rounded
  products), the values within 1e-6 relative (measured at most 1.1e-8).
* The JAX tests' identities on the port's own torch stream: min + max =
  S1 + S2, the rainbow put parity, the zero-strike spread equal to the
  exchange, Margrabe and Stulz within 4 standard errors, the control
  variate's error cut; and every validation error of the JAX module."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import brownian_motion as tbm  # noqa: E402
from finmath_tpu_torch.models import multi_asset as tma  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

S0 = [100.0, 95.0, 105.0]
VOLS = [0.25, 0.35, 0.2]
CORR = [[1.0, 0.4, 0.2], [0.4, 1.0, 0.5], [0.2, 0.5, 1.0]]
R, T, STEPS = 0.05, 1.5, 30
PATHS, SEED, OWN_PATHS = 20_000, 3141, 50_000
CPU = "cpu"

PRODUCTS = [
    ("exchange", "ExchangeOption", (T, 0, 1), {}),
    ("exchange-2-0", "ExchangeOption", (T, 2, 0), {}),
    ("call-on-max", "RainbowOption", (T, 100.0, "call-on-max"), {}),
    ("call-on-min-01", "RainbowOption", (T, 100.0, "call-on-min"),
     {"asset_indices": [0, 1]}),
    ("put-on-max", "RainbowOption", (T, 110.0, "put-on-max"), {}),
    ("put-on-min", "RainbowOption", (T, 100.0, "put-on-min"), {}),
    ("basket", "BasketOption", (T, [0.4, 0.3, 0.3], 100.0), {}),
    ("basket-put-geometric", "BasketOption",
     (T, [0.4, 0.3, 0.3], 100.0, False), {"average": "geometric"}),
    ("basket-cv", "BasketOption", (T, [0.4, 0.3, 0.3], 100.0),
     {"control_variate": "geometric"}),
    ("spread", "SpreadOption", (T, 5.0, 0, 2), {}),
]


def grid():
    return TimeDiscretization(initial=0.0, num_steps=STEPS, step=T / STEPS)


class MultiMatrixFacade:
    """A facade over a given ``[dates, assets, paths]`` asset array on a
    grid (the t=0 row included), for either package."""

    def __init__(self, td, assets, model, to):
        self.model = model
        self._td = td
        self._assets = to(np.array(assets, dtype=np.float32))

    def get_all_asset_values(self, t):
        return self._assets[self._td.get_time_index(t)]

    def get_numeraire(self, t):
        return self.model.numeraire(t)


@pytest.fixture(scope="module")
def jax_side():
    import jax.numpy as jnp
    from finmath_tpu.models import brownian_motion as jbm
    from finmath_tpu.models import multi_asset as jma
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    td = JTD(initial=0.0, num_steps=STEPS, step=T / STEPS)
    model = jma.MultiAssetBlackScholesModel(S0, R, VOLS, CORR)
    sim = jma.MonteCarloMultiAssetBlackScholesModel(
        td, PATHS, model,
        brownian=jbm.BrownianMotionFinmathMersenne(td, 3, PATHS, SEED))
    states = np.asarray(sim.process._lazy_states())
    assets = np.stack([np.asarray(sim.get_all_asset_values(t))
                       for t in td.as_array()])
    facade = MultiMatrixFacade(td, assets, model, jnp.asarray)
    products = {pid: getattr(jma, name)(*args, **kw)
                for pid, name, args, kw in PRODUCTS}
    return dict(states=states, assets=assets, model=model, products=products,
                on_matrix={pid: p.get_value_and_error(facade)
                           for pid, p in products.items()},
                end_to_end={pid: p.get_value_and_error(sim)
                            for pid, p in products.items()})


@pytest.fixture(scope="module")
def mersenne_sim():
    td = grid()
    return tma.MonteCarloMultiAssetBlackScholesModel(
        td, PATHS, tma.MultiAssetBlackScholesModel(S0, R, VOLS, CORR),
        brownian=tbm.BrownianMotionFinmathMersenne(td, 3, PATHS, SEED,
                                                   device=CPU))


@pytest.fixture(scope="module")
def own_sim():
    """The JAX tests' two-asset market on the port's own torch stream."""
    td = TimeDiscretization(initial=0.0, num_steps=30, step=T / 30)
    return tma.MonteCarloMultiAssetBlackScholesModel(
        td, OWN_PATHS, tma.MultiAssetBlackScholesModel(
            [100.0, 95.0], 0.04, [0.25, 0.35], [[1.0, 0.4], [0.4, 1.0]]),
        seed=11, device=CPU)


def test_closed_forms_match_jax():
    from finmath_tpu.models import multi_asset as jma

    calls = [("bivariate_normal_cdf", (a, b, rho))
             for a in (-2.0, -0.3, 0.0, 1.1) for b in (-1.5, 0.4, 2.5)
             for rho in (-1.0, -0.999, -0.6, 0.0, 0.35, 0.9, 1.0)]
    calls += [("margrabe_exchange_value", (100.0, 95.0, 0.25, 0.35, 0.4, T)),
              ("margrabe_exchange_value", (100.0, 100.0, 0.3, 0.3, 1.0, T)),
              ("margrabe_exchange_value", (100.0, 90.0, 0.3, 0.2, 0.1, 0.0))]
    calls += [("stulz_rainbow_value",
               (100.0, 95.0, R, 0.25, 0.35, 0.4, T, k, kind))
              for kind in tma.RainbowOption._KINDS
              for k in (0.0, 80.0, 100.0, 120.0)]
    calls += [("kirk_spread_approximation",
               (100.0, 95.0, R, 0.25, 0.35, 0.4, T, k))
              for k in (0.0, 5.0, -3.0)]
    calls += [("geometric_basket_option_value",
               (S0, R, VOLS, CORR, [0.4, 0.3, 0.3], T, k, call))
              for k in (90.0, 100.0, 115.0) for call in (True, False)]
    calls.append(("geometric_basket_option_value",
                  (S0, R, [0.0, 0.0, 0.0], CORR, [0.4, 0.3, 0.3], T, 90.0)))
    for name, args in calls:
        a = getattr(jma, name)(*args)
        b = getattr(tma, name)(*args)
        assert b == pytest.approx(a, rel=1e-12, abs=1e-15), (name, args)


VALIDATION = [
    ("MultiAssetBlackScholesModel", ([1.0, 1.0], R, [0.2], np.eye(2)), {}),
    ("MultiAssetBlackScholesModel", ([1.0, 1.0], R, [0.2, 0.3], np.eye(3)),
     {}),
    ("MultiAssetBlackScholesModel",
     ([1.0, 1.0], R, [0.2, 0.3], [[1.0, 0.5], [0.4, 1.0]]), {}),
    ("MultiAssetBlackScholesModel",
     ([1.0, 1.0], R, [0.2, 0.3], [[1.0, 0.5], [0.5, 0.9]]), {}),
    ("MultiAssetBlackScholesModel",
     ([1.0, 1.0, 1.0], R, [0.2, 0.3, 0.1],
      [[1.0, 0.9, -0.9], [0.9, 1.0, 0.9], [-0.9, 0.9, 1.0]]), {}),
    ("RainbowOption", (T, 100.0, "call-on-median"), {}),
    ("BasketOption", (T, [0.5, 0.5], 100.0), {"average": "median"}),
    ("BasketOption", (T, [0.5, 0.5], 100.0), {"control_variate": "x"}),
    ("BasketOption", (T, [0.5, 0.5], 100.0),
     {"average": "geometric", "control_variate": "geometric"}),
    ("BasketOption", (T, [0.5, -0.5], 100.0), {}),
    ("bivariate_normal_cdf", (0.0, 0.0, 1.5), {}),
    ("stulz_rainbow_value", (100.0, 95.0, R, 0.2, 0.3, 0.4, T, 100.0,
                             "bad"), {}),
]


@pytest.mark.parametrize("name,args,kw", VALIDATION)
def test_validation_matches_jax(name, args, kw):
    from finmath_tpu.models import multi_asset as jma

    with pytest.raises(Exception) as jerr:
        getattr(jma, name)(*args, **kw)
    with pytest.raises(jerr.type):
        getattr(tma, name)(*args, **kw)


@pytest.mark.parametrize("pid,name,args,kw", PRODUCTS,
                         ids=[p[0] for p in PRODUCTS])
def test_product_on_the_same_asset_matrix(jax_side, pid, name, args, kw):
    model = convert.multi_asset_model_from_jax(jax_side["model"])
    facade = MultiMatrixFacade(grid(), jax_side["assets"], model,
                               torch.as_tensor)
    product = convert.equity_product_from_jax(jax_side["products"][pid])
    assert type(product) is getattr(tma, name)
    v, e = product.get_value_and_error(facade)
    jv, je = jax_side["on_matrix"][pid]
    assert v == pytest.approx(jv, rel=1e-9)
    assert e == pytest.approx(je, rel=1e-9)


def test_facade_end_to_end_on_mersenne_paths(jax_side, mersenne_sim):
    model = mersenne_sim.model
    assert model == convert.multi_asset_model_from_jax(jax_side["model"])
    lam = model.factor_loadings(0, torch.zeros(3, 4))
    assert lam.dtype == torch.float32 and tuple(lam.shape) == (3, 3, 4)
    np.testing.assert_array_equal(
        lam[:, :, 0].numpy(),
        np.asarray(jax_side["model"]._loadings, dtype=np.float32))
    js, ts = jax_side["states"], mersenne_sim.process._lazy_states().numpy()
    assert ts.shape == (STEPS + 1, 3, PATHS)
    ulps = np.abs(js.view(np.int32).astype(np.int64)
                  - ts.view(np.int32).astype(np.int64))
    assert ulps.max() <= 8
    all_t = mersenne_sim.get_all_asset_values(T)
    assert tuple(all_t.shape) == (3, PATHS) and all_t.dtype == torch.float32
    np.testing.assert_array_equal(
        mersenne_sim.get_asset_values([0.5, T], 2).numpy(),
        torch.exp(mersenne_sim.process._lazy_states()[[10, 30], 2]).numpy())
    for pid, *_ in PRODUCTS:
        product = convert.equity_product_from_jax(jax_side["products"][pid])
        v, e = product.get_value_and_error(mersenne_sim)
        jv, je = jax_side["end_to_end"][pid]
        assert v == pytest.approx(jv, rel=1e-6), pid
        assert e == pytest.approx(je, rel=1e-5), pid
    with pytest.raises(ValueError, match="not on the simulation grid"):
        mersenne_sim.get_all_asset_values(0.33)
    with pytest.raises(ValueError, match="weights for 3 assets"):
        tma.BasketOption(T, [0.5, 0.5], 100.0).get_value(mersenne_sim)
    with pytest.raises(NotImplementedError):
        tma.MonteCarloMultiAssetBlackScholesModel(
            grid(), 8, model, device=CPU, mesh=object())


def test_identities_on_the_port_stream(own_sim):
    """``tests/test_multi_asset.py``'s closed-form bounds and same-stream
    identities on the port's torch stream (two assets, 50,000 paths)."""
    sim = own_sim
    s0, r, vols, rho = [100.0, 95.0], 0.04, [0.25, 0.35], 0.4
    df = math.exp(-r * T)
    v, e = tma.ExchangeOption(T).get_value_and_error(sim)
    assert abs(v - tma.margrabe_exchange_value(
        s0[0], s0[1], vols[0], vols[1], rho, T)) < 4 * e
    vs, _ = tma.SpreadOption(T, 0.0).get_value_and_error(sim)
    assert abs(vs - v) < 1e-9 * max(v, 1.0)
    for kind, k in (("call-on-min", 100.0), ("call-on-max", 100.0),
                    ("put-on-min", 100.0), ("put-on-max", 100.0)):
        v, e = tma.RainbowOption(T, k, kind).get_value_and_error(sim)
        an = tma.stulz_rainbow_value(s0[0], s0[1], r, vols[0], vols[1], rho,
                                     T, k, kind)
        assert abs(v - an) < 4 * e, kind
    vmin, _ = tma.RainbowOption(T, 0.0, "call-on-min").get_value_and_error(
        sim)
    vmax, _ = tma.RainbowOption(T, 0.0, "call-on-max").get_value_and_error(
        sim)
    a1 = float(sim.get_asset_value(T, 0).get_average())
    a2 = float(sim.get_asset_value(T, 1).get_average())
    assert abs(vmin + vmax - df * (a1 + a2)) < 2e-5 * (a1 + a2)
    p, _ = tma.RainbowOption(T, 100.0, "put-on-min").get_value_and_error(sim)
    c, _ = tma.RainbowOption(T, 100.0, "call-on-min").get_value_and_error(
        sim)
    expect = c - vmin + 100.0 * df
    assert abs(p - expect) < 1e-6 * expect
    w = [0.5, 0.5]
    corr = [[1.0, rho], [rho, 1.0]]
    vg, eg = tma.BasketOption(T, w, 100.0, average="geometric") \
        .get_value_and_error(sim)
    assert abs(vg - tma.geometric_basket_option_value(
        s0, r, vols, corr, w, T, 100.0)) < 4 * eg
    va, ea = tma.BasketOption(T, w, 100.0).get_value_and_error(sim)
    vc, ec = tma.BasketOption(T, w, 100.0, control_variate="geometric") \
        .get_value_and_error(sim)
    assert va >= vg and abs(va - vc) < 4 * ea and ec < ea / 3
    n = sim.get_numeraire(T)
    assert n.is_deterministic()
    assert abs(float(n.get_average()) - math.exp(r * T)) < 1e-12


def test_rainbow_reads_one_gather():
    """A rainbow product reads ``get_all_asset_values`` once and nothing
    else of the facade but its numeraire."""
    calls = []
    values = torch.tensor([[1.0, 3.0], [2.0, 1.0]])

    def gather(t):
        calls.append(t)
        return values

    model = tma.MultiAssetBlackScholesModel([1.0, 1.0], 0.0, [0.2, 0.2],
                                            np.eye(2))
    facade = SimpleNamespace(get_all_asset_values=gather,
                             get_numeraire=model.numeraire)
    v, e = tma.RainbowOption(1.0, 1.5, "call-on-max").get_value_and_error(
        facade)
    assert calls == [1.0] and v == pytest.approx(1.0) and e > 0
