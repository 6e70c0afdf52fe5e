"""The port's equity exotics (``finmath_tpu_torch/models/equity_products.py``)
against finmath_tpu's, on ``tests/test_equity_products.py``'s market (S0 100,
r 5%, sigma 30%, T 1) over a 50-step grid.

Two comparisons with the JAX package, both on the same
``BrownianMotionFinmathMersenne`` realization (20,000 paths, seed 3141):
* each product on the SAME asset matrix: the JAX facade's matrix, copied
  with NumPy, drives both packages through a facade over a given matrix
  (``MatrixFacade``). The digital and the discrete barrier compare the same
  float32 numbers with the same levels, so their values agree within 1e-12
  relative (measured at most 4.2e-16); the float64 reductions of float32
  payoffs (Asian, lookback) within 1e-9 (measured at most 2.2e-15, the
  control variate's error 1.1e-14); the
  bridge barrier, whose crossing factors go through two float32 ``log`` and
  ``exp`` implementations and whose float32 survival product is taken in
  another order, within 1e-6 (measured at most 1.6e-9);
* the facades end to end. The float32 log-states sit within 8 ulps
  (measured at most 4): XLA contracts the JAX Euler step's diffusion into
  an FMA, ``fma(sigma, dW, X + mu dt)``, and the port's step rounds the
  product first. At log S ~ 4.6 an ulp is 4.8e-7, so the asset matrices
  are within 8 ulps of the largest log-state plus two float32 ``exp``
  ulps, 4.1e-6 relative (measured 1.5e-6: above the 1e-6 that holds at
  S0 = 1, ``tests/test_torch_black_scholes.py``). Every value within 1e-6
  relative plus the payoff of the paths whose comparison with a level
  flips, over N (measured: no path flips; values at most 1.7e-7 apart).
Then the JAX tests' identities on the port's own torch stream, the one
host transfer of ``price_portfolio`` (equal to the serial loop, also for
the Hull-White TARN and Bermudan), the validation errors and the device
rule. On the Merton facade (``tests/test_equity_products.py``'s
fixture): the products on the JAX facade's matrix equal within 1e-9, the
cash parity, the plain products and the Black-Scholes-only gates on the
port's own facade."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import analytic as tanalytic  # noqa: E402
from finmath_tpu_torch.models import black_scholes as tbs  # noqa: E402
from finmath_tpu_torch.models import brownian_motion as tbm  # noqa: E402
from finmath_tpu_torch.models import equity_products as tep  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

S0, R, SIG, T = 100.0, 0.05, 0.3, 1.0
STEPS, PATHS, SEED = 50, 20_000, 3141
DT = T / STEPS
OWN_PATHS = 50_000
CPU = "cpu"
ASIAN_DATES = [round((i + 1) * T / 12 / DT) * DT for i in range(12)]

# (id, JAX class name, args, kwargs, relative bound on the same matrix)
PRODUCTS = [
    ("digital-call", "DigitalOption", (T, 105.0), {}, 1e-12),
    ("digital-put", "DigitalOption", (T, 95.0, False), {}, 1e-12),
    ("asian", "AsianOption", (ASIAN_DATES, 100.0), {}, 1e-9),
    ("asian-put-geometric", "AsianOption", (ASIAN_DATES, 100.0, False),
     {"average": "geometric"}, 1e-9),
    ("asian-cv", "AsianOption", (ASIAN_DATES, 100.0),
     {"control_variate": "geometric"}, 1e-9),
    ("barrier-up-out", "BarrierOption", (T, 100.0, 130.0, "up-out"), {},
     1e-12),
    ("barrier-down-in-put-rebate", "BarrierOption",
     (T, 110.0, 85.0, "down-in", False), {"rebate": 2.0}, 1e-12),
    ("bridge-up-out", "BarrierOption", (T, 100.0, 130.0, "up-out"),
     {"monitoring": "bridge"}, 1e-6),
    ("bridge-down-in-put", "BarrierOption",
     (T, 110.0, 85.0, "down-in", False), {"monitoring": "bridge"}, 1e-6),
    ("bridge-down-out-rebate", "BarrierOption",
     (T, 100.0, 80.0, "down-out"),
     {"monitoring": "bridge", "rebate": 1.5}, 1e-6),
    ("lookback-floating-call", "LookbackOption", (T, "floating-call"), {},
     1e-9),
    ("lookback-floating-put", "LookbackOption", (T, "floating-put"), {},
     1e-9),
    ("lookback-fixed-call", "LookbackOption", (T, "fixed-call"),
     {"strike": 110.0}, 1e-9),
    ("lookback-fixed-put", "LookbackOption", (T, "fixed-put"),
     {"strike": 100.0}, 1e-9),
]


class MatrixFacade:
    """A facade over a given ``[steps, paths]`` float32 asset matrix on a
    grid (the t=0 row left out), for either package: ``to`` turns a NumPy
    array into the package's array, ``model`` is that package's model (its
    numeraire and, for Black-Scholes products, its parameters)."""

    def __init__(self, td, assets, model, to):
        self.model = model
        self.process = SimpleNamespace(time_discretization=td)
        self._td = td
        self._assets = to(np.array(assets, dtype=np.float32))
        self._to = to

    def _row(self, t):
        i = self._td.get_time_index(t)
        if i < 1:
            raise ValueError(f"time {t} not on the simulation grid")
        return i - 1

    def get_asset_value(self, t):
        return SimpleNamespace(values=self._assets[self._row(t)])

    def get_asset_values(self, times):
        rows = np.asarray([self._row(t) for t in times])
        return self._assets[self._to(rows)]

    def get_numeraire(self, t):
        return self.model.numeraire(t)


def torch_facade(td, assets, model):
    return MatrixFacade(td, assets, model, torch.as_tensor)


def jax_facade(td, assets, model):
    import jax.numpy as jnp

    return MatrixFacade(td, assets, model, jnp.asarray)


def grid():
    return TimeDiscretization(initial=0.0, num_steps=STEPS, step=DT)


def jax_grid():
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    return JTD(initial=0.0, num_steps=STEPS, step=DT)


def jax_product(name, args, kwargs):
    from finmath_tpu.models import equity_products as jep

    return getattr(jep, name)(*args, **kwargs)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX facade on the Mersenne paths, its asset matrix, and every
    product's (value, stderr) on that matrix and end to end."""
    from finmath_tpu.models import black_scholes as jbs
    from finmath_tpu.models import brownian_motion as jbm

    td = jax_grid()
    sim = jbs.MonteCarloBlackScholesModel(
        td, PATHS, jbs.BlackScholesModel(S0, R, SIG),
        brownian=jbm.BrownianMotionFinmathMersenne(td, 1, PATHS, SEED))
    assets = np.asarray(sim.get_asset_values(list(td.as_array()[1:])))
    states = np.asarray(sim.process._lazy_states())
    facade = jax_facade(td, assets, sim.model)
    products = {pid: jax_product(name, args, kw)
                for pid, name, args, kw, _ in PRODUCTS}
    return dict(
        assets=assets, states=states,
        on_matrix={pid: p.get_value_and_error(facade)
                   for pid, p in products.items()},
        end_to_end={pid: p.get_value_and_error(sim)
                    for pid, p in products.items()},
        products=products)


@pytest.fixture(scope="module")
def mersenne_sim():
    td = grid()
    return tbs.MonteCarloBlackScholesModel(
        td, PATHS, tbs.BlackScholesModel(S0, R, SIG),
        brownian=tbm.BrownianMotionFinmathMersenne(td, 1, PATHS, SEED,
                                                   device=CPU))


@pytest.fixture(scope="module")
def own_sim():
    """The port's own torch stream (not JAX's)."""
    return tbs.MonteCarloBlackScholesModel(
        grid(), OWN_PATHS, tbs.BlackScholesModel(S0, R, SIG), seed=42,
        device=CPU)


@pytest.mark.parametrize("pid,name,args,kw,rel", PRODUCTS,
                         ids=[p[0] for p in PRODUCTS])
def test_product_on_the_same_asset_matrix(jax_side, pid, name, args, kw,
                                          rel):
    facade = torch_facade(grid(), jax_side["assets"],
                          tbs.BlackScholesModel(S0, R, SIG))
    product = convert.equity_product_from_jax(jax_side["products"][pid])
    assert type(product) is getattr(tep, name)
    packed = product.packed_value_and_error(facade)
    assert packed.dtype == torch.float64 and tuple(packed.shape) == (2,)
    v, e = product.get_value_and_error(facade)
    jv, je = jax_side["on_matrix"][pid]
    assert v == pytest.approx(jv, rel=rel, abs=1e-300)
    assert e == pytest.approx(je, rel=max(rel, 1e-9))


def _flipped(a, b, level):
    """Paths on which a level comparison differs between two matrices."""
    return np.asarray((a >= level) != (b >= level)).reshape(a.shape[0], -1)


def test_facades_end_to_end_on_mersenne_paths(jax_side, mersenne_sim):
    td = grid()
    times = list(td.as_array()[1:])
    t_assets = mersenne_sim.get_asset_values(times)
    assert t_assets.dtype == torch.float32
    ja, ta = jax_side["assets"], t_assets.numpy()
    js, ts = jax_side["states"], mersenne_sim.process._lazy_states().numpy()
    ulps = np.abs(js.view(np.int32).astype(np.int64)
                  - ts.view(np.int32).astype(np.int64))
    assert ulps.max() <= 8
    log_ulp = float(np.spacing(np.float32(np.abs(js).max())))
    np.testing.assert_allclose(ta, ja, rtol=8 * log_ulp + 2 * 2.0 ** -23)
    for pid, name, args, kw, _ in PRODUCTS:
        product = convert.equity_product_from_jax(jax_side["products"][pid])
        v, e = product.get_value_and_error(mersenne_sim)
        jv, je = jax_side["end_to_end"][pid]
        # the paths whose comparison with a strike or barrier flips
        levels = [x for x in (getattr(product, "strike", None),
                              getattr(product, "barrier", None)) if x]
        flips = sum(int(np.any(_flipped(ja, ta, lv), axis=0).sum())
                    for lv in levels)
        envelope = flips * max(S0, 1.0) * 2.0 / PATHS
        assert abs(v - jv) <= 1e-6 * abs(jv) + envelope, (pid, v, jv, flips)
        assert e == pytest.approx(je, rel=1e-5), pid
    # the same on the port's EuropeanOption through price_portfolio
    book = [tbs.EuropeanOption(T, 100.0)] + [
        convert.equity_product_from_jax(p)
        for p in jax_side["products"].values()]
    book_values = tep.price_portfolio(mersenne_sim, book)
    for p, got in zip(book, book_values):
        assert got == pytest.approx(p.get_value_and_error(mersenne_sim),
                                    rel=1e-12, abs=1e-15)


def test_identities_on_the_port_stream(own_sim):
    """``tests/test_equity_products.py``'s same-stream identities and
    closed-form bounds, on the port's torch stream."""
    sim = own_sim
    df = math.exp(-R * T)
    k = 103.739                       # off the float32 grid
    c, _ = tep.DigitalOption(T, k).get_value_and_error(sim)
    p, _ = tep.DigitalOption(T, k, is_call=False).get_value_and_error(sim)
    assert abs(c + p - df) < 1e-9
    v, e = tep.DigitalOption(T, 105.0).get_value_and_error(sim)
    assert abs(v - tanalytic.digital_option_value(S0, R, SIG, T, 105.0)) \
        < 4 * e + 1e-4
    vi, _ = tep.BarrierOption(T, 100.0, 130.0, "up-in") \
        .get_value_and_error(sim)
    vo, _ = tep.BarrierOption(T, 100.0, 130.0, "up-out") \
        .get_value_and_error(sim)
    ve = tbs.EuropeanOption(T, 100.0).get_value(sim)
    assert abs(vi + vo - ve) < 1e-6 * ve
    far, _ = tep.BarrierOption(T, 100.0, 1e6, "up-out") \
        .get_value_and_error(sim)
    assert abs(far - ve) < 1e-6 * ve
    for bt, b, kk, call in (("up-out", 130.0, 100.0, True),
                            ("down-in", 90.0, 110.0, False)):
        v, e = tep.BarrierOption(T, kk, b, bt, is_call=call,
                                 monitoring="bridge").get_value_and_error(sim)
        an = tanalytic.barrier_option_value(S0, R, SIG, T, kk, b, bt, call)
        assert abs(v - an) < 4 * e + 1e-3, bt
    times = ASIAN_DATES
    va, ea = tep.AsianOption(times, 100.0).get_value_and_error(sim)
    vg, eg = tep.AsianOption(times, 100.0, average="geometric") \
        .get_value_and_error(sim)
    vc, ec = tep.AsianOption(times, 100.0, control_variate="geometric") \
        .get_value_and_error(sim)
    assert va >= vg
    assert abs(vg - tanalytic.geometric_asian_option_value(
        S0, R, SIG, times, 100.0)) < 4 * eg
    assert abs(va - vc) < 4 * ea and ec < ea / 5
    vf, _ = tep.LookbackOption(T, "fixed-call", strike=90.0) \
        .get_value_and_error(sim)
    vp, _ = tep.LookbackOption(T, "floating-put").get_value_and_error(sim)
    fwd = tbs.EuropeanOption(T, 0.0).get_value(sim)
    expect = vp + fwd - 90.0 * df
    assert abs(vf - expect) < 1e-6 * expect
    v, e = tep.LookbackOption(T, "floating-call").get_value_and_error(sim)
    an = tanalytic.lookback_floating_strike_value(S0, R, SIG, T, True)
    bgk = 0.5826 * SIG * math.sqrt(DT)
    assert an - 2.5 * bgk * S0 - 4 * e < v < an + 4 * e


def test_price_portfolio_is_one_transfer_of_the_serial_values(own_sim):
    """``bench.py:1754-1763``'s 20-product book, cut to this grid: one
    stacked transfer equal to the serial loop within 1e-12."""
    book = [tbs.EuropeanOption(T, 85.0 + 5.0 * i, is_call=i % 2 == 0)
            for i in range(8)]
    book += [tep.DigitalOption(T, 95.0 + 5.0 * i) for i in range(4)]
    book += [tep.AsianOption(ASIAN_DATES, 90.0 + 10.0 * i) for i in range(3)]
    book += [tep.BarrierOption(T, 100.0, 125.0 + 10.0 * i, "up-out")
             for i in range(3)]
    book += [tep.LookbackOption(T, "floating-call"),
             tep.LookbackOption(T, "fixed-put", strike=100.0)]
    assert len(book) == 20
    port = tep.price_portfolio(own_sim, book)
    serial = [p.get_value_and_error(own_sim) for p in book]
    for (a, ea), (b, eb) in zip(port, serial):
        assert abs(a - b) < 1e-12 and abs(ea - eb) < 1e-12
    assert tep.price_portfolio(own_sim, []) == []


def test_price_portfolio_takes_the_hull_white_book():
    from finmath_tpu_torch.models.curves import DiscountCurve
    from finmath_tpu_torch.models.hull_white import (HullWhiteModel,
                                                     HullWhiteSimulation)
    from finmath_tpu_torch.models.hw_bermudan import BermudanSwaption
    from finmath_tpu_torch.models.tarn import TargetRedemptionNote

    ts = np.arange(0.5, 10.1, 0.5)
    hw = HullWhiteModel(DiscountCurve(list(ts), list(np.exp(-0.022 * ts))),
                        0.1, 0.01)
    sim = HullWhiteSimulation(
        hw, TimeDiscretization(initial=0.0, num_steps=9, step=0.5),
        num_paths=4_000, seed=3, device=CPU)
    book = [BermudanSwaption([1.0, 1.5, 2.0], 4.0, 0.025),
            TargetRedemptionNote([0.5, 1.0, 1.5, 2.0],
                                 [1.0, 1.5, 2.0, 2.5], 0.045, target=0.04)]
    port = tep.price_portfolio(sim, book)
    for p, got in zip(book, port):
        assert got == pytest.approx(p.get_value_and_error(sim), rel=1e-12,
                                    abs=1e-15)


VALIDATION = [
    ("AsianOption", ([], 100.0), {}),
    ("AsianOption", ([0.5, 0.25], 100.0), {}),
    ("AsianOption", ([0.5], 100.0), {"average": "median"}),
    ("AsianOption", ([0.5], 100.0), {"control_variate": "arith"}),
    ("AsianOption", ([0.5], 100.0),
     {"average": "geometric", "control_variate": "geometric"}),
    ("BarrierOption", (T, 100.0, 130.0, "sideways-out"), {}),
    ("BarrierOption", (T, 100.0, 130.0, "up-out"), {"monitoring": "hourly"}),
    ("LookbackOption", (T, "floating-strangle"), {}),
    ("LookbackOption", (T, "fixed-call"), {}),
    ("LookbackOption", (T, "floating-call"), {"strike": 100.0}),
]


@pytest.mark.parametrize("name,args,kw", VALIDATION)
def test_validation_matches_jax(name, args, kw):
    from finmath_tpu.models import equity_products as jep

    with pytest.raises(Exception) as jerr:
        getattr(jep, name)(*args, **kw)
    with pytest.raises(jerr.type):
        getattr(tep, name)(*args, **kw)


def test_facade_checks_raise_as_jax(own_sim):
    with pytest.raises(ValueError, match="not on the simulation grid"):
        tep.LookbackOption(0.51, "floating-call").get_value(own_sim)
    merton_like = SimpleNamespace(
        model=SimpleNamespace(initial_value=S0),
        process=own_sim.process, get_asset_values=own_sim.get_asset_values,
        get_asset_value=own_sim.get_asset_value,
        get_numeraire=own_sim.get_numeraire)
    for product in (tep.BarrierOption(T, 100.0, 130.0, "up-out",
                                      monitoring="bridge"),
                    tep.AsianOption(ASIAN_DATES, 100.0,
                                    control_variate="geometric")):
        with pytest.raises(NotImplementedError):
            product.get_value(merton_like)
    with pytest.raises(NotImplementedError):
        tep._spot_of(SimpleNamespace(model=None, params=None))
    stochastic = SimpleNamespace(get_numeraire=lambda t: SimpleNamespace(
        is_deterministic=lambda: t == 0.0, get_average=lambda: 1.0))
    with pytest.raises(NotImplementedError):
        tep._deterministic_dfs(stochastic, [1.0])


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device=`` the facades compute on the current CUDA device,
    and raise where there is none: no quiet CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from finmath_tpu_torch.models import (
        MonteCarloMultiAssetBlackScholesModel, MultiAssetBlackScholesModel,
        mc_european_price_importance_sampled, mlmc_lookback_call)

    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    td = TimeDiscretization(initial=0.0, num_steps=2, step=0.5)
    for call in (lambda: tbs.MonteCarloBlackScholesModel(
                     td, 8, tbs.BlackScholesModel(S0, R, SIG)),
                 lambda: MonteCarloMultiAssetBlackScholesModel(
                     td, 8, MultiAssetBlackScholesModel(
                         [1.0, 1.0], R, [0.2, 0.3], np.eye(2))),
                 lambda: mc_european_price_importance_sampled(
                     1, 8, S0, R, SIG, T, 120.0),
                 lambda: mlmc_lookback_call(S0, R, SIG, T, n_pilot=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_convert_models_and_every_product_class():
    """``convert`` carries the JAX Black-Scholes and multi-asset models and
    one product of every class of the slice into the port: the same class
    name and terms, the same closed forms from the converted models."""
    from finmath_tpu.models import american as jam
    from finmath_tpu.models import analytic as janalytic
    from finmath_tpu.models import black_scholes as jbs
    from finmath_tpu.models import equity_products as jep
    from finmath_tpu.models import hedging as jhd
    from finmath_tpu.models import multi_asset as jma
    from finmath_tpu.models import structured_products as jsp
    from finmath_tpu_torch.models import multi_asset as tma

    jmodel = jbs.BlackScholesModel(S0, R, SIG)
    model = convert.black_scholes_model_from_jax(jmodel)
    assert model == tbs.BlackScholesModel(S0, R, SIG)
    corr = [[1.0, 0.3], [0.3, 1.0]]
    jmulti = jma.MultiAssetBlackScholesModel([100.0, 90.0], R, [0.2, 0.3],
                                             corr)
    multi = convert.multi_asset_model_from_jax(jmulti)
    np.testing.assert_array_equal(multi._loadings, jmulti._loadings)
    assert multi.correlation.tolist() == corr
    assert tma.geometric_basket_option_value(
        multi.initial_values, multi.risk_free_rate, multi.volatilities,
        multi.correlation, [0.5, 0.5], T, 95.0) == jma.\
        geometric_basket_option_value(
            jmulti.initial_values, jmulti.risk_free_rate,
            jmulti.volatilities, jmulti.correlation, [0.5, 0.5], T, 95.0)
    assert tanalytic.geometric_asian_option_value(
        model.initial_value, model.risk_free_rate, model.volatility,
        ASIAN_DATES, 100.0) == pytest.approx(
        janalytic.geometric_asian_option_value(
            jmodel.initial_value, jmodel.risk_free_rate, jmodel.volatility,
            ASIAN_DATES, 100.0), rel=1e-12)
    products = [
        jbs.EuropeanOption(T, 100.0, False),
        jep.DigitalOption(T, 105.0), jep.AsianOption(ASIAN_DATES, 100.0),
        jep.BarrierOption(T, 100.0, 130.0, "up-out", monitoring="bridge",
                          rebate=1.0),
        jep.LookbackOption(T, "fixed-put", strike=95.0),
        jma.ExchangeOption(T, 1, 0), jma.RainbowOption(
            T, 100.0, "put-on-min", asset_indices=[0, 1]),
        jma.BasketOption(T, [0.5, 0.5], 100.0, control_variate="geometric"),
        jma.SpreadOption(T, 3.0), jam.BermudanOption([0.5, T], 110.0),
        jsp.ForwardStartOption(0.4, T, 1.1), jsp.CliquetOption(
            [0.5, T], -0.05, 0.08), jsp.CompoundOption(0.5, 5.0, T, 100.0),
        jsp.ChooserOption(0.5, T, 100.0),
        jsp.AutocallableNote([0.5, T], [105.0, 100.0], [0.05, 0.08], 70.0,
                             memory=True),
        jhd.DeltaHedgedPortfolio(T, 105.0), jhd.VarianceSwap(T)]
    for p in products:
        q = convert.equity_product_from_jax(p)
        assert type(q).__name__ == type(p).__name__
        assert type(q).__module__.startswith("finmath_tpu_torch.")
        assert vars(q) == vars(p)
    with pytest.raises(ValueError, match="no equity product"):
        convert.equity_product_from_jax(jmodel)


# -- the Merton facade (tests/test_equity_products.py:79, 118, 123, 197, 263)

MERTON = dict(initial_value=S0, risk_free_rate=R, volatility=0.2,
              jump_intensity=0.5, jump_size_mean=-0.1, jump_size_std=0.2)
MERTON_PATHS, MERTON_STEPS = 50_000, 20


def merton_model(rv_class):
    """The facade-surface model a ``MatrixFacade`` needs for a Merton
    matrix: its numeraire (in ``rv_class``) and spot; no Black-Scholes
    parameters, so the Black-Scholes-only features raise."""
    return SimpleNamespace(
        numeraire=lambda t: rv_class(t, math.exp(R * t)), initial_value=S0)


def merton_grid():
    return TimeDiscretization(initial=0.0, num_steps=MERTON_STEPS,
                              step=T / MERTON_STEPS)


@pytest.fixture(scope="module")
def merton_matrices():
    """The JAX Merton facade's asset matrix (its own stream, seed 7) in a
    facade of each package, and the port's Merton facade (its own torch
    stream)."""
    from finmath_tpu.models import merton as jm
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)
    from finmath_tpu.ops.random_variable import RandomVariableTPU
    from finmath_tpu_torch.models import merton as tm
    from finmath_tpu_torch.ops.random_variable import RandomVariableTorch

    jtd = JTD(initial=0.0, num_steps=MERTON_STEPS, step=T / MERTON_STEPS)
    jsim = jm.MonteCarloMertonModel(jtd, MERTON_PATHS,
                                    jm.MertonParams(**MERTON), seed=7)
    assets = np.asarray(jsim.get_asset_values(list(jtd.as_array()[1:])))
    return dict(
        jax=jax_facade(jtd, assets, merton_model(RandomVariableTPU)),
        port=torch_facade(merton_grid(), assets,
                          merton_model(RandomVariableTorch)),
        own=tm.MonteCarloMertonModel(merton_grid(), MERTON_PATHS,
                                     tm.MertonParams(**MERTON), seed=7,
                                     device=CPU))


MERTON_PRODUCTS = [
    ("digital-call", "DigitalOption", (T, 100.0), {}),
    ("digital-put", "DigitalOption", (T, 100.0, False), {}),
    ("asian", "AsianOption", ([(i + 1) * T / 10 for i in range(10)], 100.0),
     {}),
    ("lookback-floating-call", "LookbackOption", (T, "floating-call"), {}),
]


@pytest.mark.parametrize("pid,name,args,kw", MERTON_PRODUCTS,
                         ids=[p[0] for p in MERTON_PRODUCTS])
def test_merton_products_on_the_same_asset_matrix(merton_matrices, pid,
                                                  name, args, kw):
    jp = jax_product(name, args, kw)
    v, e = convert.equity_product_from_jax(jp).get_value_and_error(
        merton_matrices["port"])
    jv, je = jp.get_value_and_error(merton_matrices["jax"])
    assert v == pytest.approx(jv, rel=1e-9)
    assert e == pytest.approx(je, rel=1e-9)


def test_merton_facade_cash_parity(merton_matrices):
    sim = merton_matrices["own"]
    c, _ = tep.DigitalOption(T, 100.0).get_value_and_error(sim)
    p, _ = tep.DigitalOption(T, 100.0, is_call=False) \
        .get_value_and_error(sim)
    assert abs(c + p - math.exp(-R * T)) < 1e-9


def test_merton_facade_plain_products_run(merton_matrices):
    sim = merton_matrices["own"]
    times = [(i + 1) * T / 10 for i in range(10)]
    v, e = tep.AsianOption(times, 100.0).get_value_and_error(sim)
    assert 0.0 < v < S0 and e < 0.2
    v, e = tep.LookbackOption(T, "floating-call").get_value_and_error(sim)
    assert v > 0 and e < 0.3


@pytest.mark.parametrize("facade", ["own", "port"])
def test_black_scholes_features_need_black_scholes(merton_matrices, facade):
    sim = merton_matrices[facade]
    times = [(i + 1) * T / 10 for i in range(10)]
    with pytest.raises(NotImplementedError):
        tep.AsianOption(times, 100.0, control_variate="geometric") \
            .get_value(sim)
    with pytest.raises(NotImplementedError):
        tep.BarrierOption(T, 100.0, 130.0, "up-out",
                          monitoring="bridge").get_value(sim)
