"""The port's delta hedge and variance swap (``finmath_tpu_torch/models/
hedging.py``) against finmath_tpu's, on ``tests/test_hedging.py``'s market
(S0 100, r 5%, sigma 30%, T 1).

* On the SAME asset matrix (the JAX facade's on 20,000
  ``BrownianMotionFinmathMersenne`` paths over 100 steps, copied with
  NumPy): the hedge's value, hedge-error mean and standard deviation
  within 1e-6 of the value (the delta is float32 ``log`` and ``erf`` in
  both packages, two implementations; measured at most 1.4e-9), the
  premium within 1e-12; the variance swap's float64 reduction of float32
  log returns within 1e-9 relative (measured at most 3.2e-16).
* End to end on the Mersenne paths: within 1e-6 of the value (measured at
  most 1.1e-8).
* ``tests/test_hedging.py``'s bounds on the port's own torch stream, and
  the Black-Scholes gate.
* On the Merton facade: the variance swap on the JAX facade's matrix,
  the jump contribution and ordering of ``tests/test_hedging.py:97, 108``
  and the hedge's gate (``:73``) on the port's own."""

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
from finmath_tpu_torch.models import hedging as thd  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

from test_torch_equity_products import (jax_facade,  # noqa: E402
                                        torch_facade)

S0, R, SIG, T = 100.0, 0.05, 0.3, 1.0
STEPS, PATHS, SEED, OWN_PATHS = 100, 20_000, 3141, 50_000
CPU = "cpu"
HEDGES = [("call-105", 105.0, True), ("put-95", 95.0, False),
          ("call-atm", 100.0, True)]


def grid(steps=STEPS):
    return TimeDiscretization(initial=0.0, num_steps=steps, step=T / steps)


def own_sim(steps, seed=42, paths=OWN_PATHS):
    return tbs.MonteCarloBlackScholesModel(
        grid(steps), paths, tbs.BlackScholesModel(S0, R, SIG), seed=seed,
        device=CPU)


@pytest.fixture(scope="module")
def jax_side():
    from finmath_tpu.models import black_scholes as jbs
    from finmath_tpu.models import brownian_motion as jbm
    from finmath_tpu.models import hedging as jhd
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    td = JTD(initial=0.0, num_steps=STEPS, step=T / STEPS)
    sim = jbs.MonteCarloBlackScholesModel(
        td, PATHS, jbs.BlackScholesModel(S0, R, SIG),
        brownian=jbm.BrownianMotionFinmathMersenne(td, 1, PATHS, SEED))
    assets = np.asarray(sim.get_asset_values(list(td.as_array()[1:])))
    facade = jax_facade(td, assets, sim.model)
    hedges = {hid: jhd.DeltaHedgedPortfolio(T, k, call)
              for hid, k, call in HEDGES}
    swap = jhd.VarianceSwap(T)
    return dict(
        assets=assets, hedges=hedges, swap=swap,
        on_matrix={hid: h.simulate(facade) for hid, h in hedges.items()},
        end_to_end={hid: h.simulate(sim) for hid, h in hedges.items()},
        swap_on_matrix=(swap.get_value_and_error(facade),
                        swap.fair_strike(facade)),
        swap_end_to_end=(swap.get_value_and_error(sim),
                         swap.fair_strike(sim)))


def _close(got, want):
    value = abs(want["value"])
    assert got["premium"] == pytest.approx(want["premium"], rel=1e-12)
    for key in ("value", "hedge_error_mean", "hedge_error_std"):
        assert abs(got[key] - want[key]) <= 1e-6 * value, key


@pytest.mark.parametrize("hid", [h[0] for h in HEDGES])
def test_hedge_on_the_same_asset_matrix(jax_side, hid):
    facade = torch_facade(grid(), jax_side["assets"],
                          tbs.BlackScholesModel(S0, R, SIG))
    hedge = convert.equity_product_from_jax(jax_side["hedges"][hid])
    assert type(hedge) is thd.DeltaHedgedPortfolio
    got = hedge.simulate(facade)
    _close(got, jax_side["on_matrix"][hid])
    assert hedge.get_value(facade) == got["value"]


def test_variance_swap_on_the_same_asset_matrix(jax_side):
    facade = torch_facade(grid(), jax_side["assets"],
                          tbs.BlackScholesModel(S0, R, SIG))
    swap = convert.equity_product_from_jax(jax_side["swap"])
    (jv, je), jk = jax_side["swap_on_matrix"]
    v, e = swap.get_value_and_error(facade)
    assert v == pytest.approx(jv, rel=1e-9)
    assert e == pytest.approx(je, rel=1e-9)
    assert swap.fair_strike(facade) == pytest.approx(jk, rel=1e-9)
    assert swap.get_value(facade) == v


def test_end_to_end_on_mersenne_paths(jax_side):
    td = grid()
    sim = tbs.MonteCarloBlackScholesModel(
        td, PATHS, tbs.BlackScholesModel(S0, R, SIG),
        brownian=tbm.BrownianMotionFinmathMersenne(td, 1, PATHS, SEED,
                                                   device=CPU))
    for hid, *_ in HEDGES:
        hedge = convert.equity_product_from_jax(jax_side["hedges"][hid])
        _close(hedge.simulate(sim), jax_side["end_to_end"][hid])
    swap = convert.equity_product_from_jax(jax_side["swap"])
    (jv, _), jk = jax_side["swap_end_to_end"]
    assert swap.get_value(sim) == pytest.approx(jv, rel=1e-6)
    assert swap.fair_strike(sim) == pytest.approx(jk, rel=1e-6)


def test_bounds_on_the_port_stream():
    sim = own_sim(100)
    res = thd.DeltaHedgedPortfolio(T, 105.0).simulate(sim)
    mc_euro = tbs.EuropeanOption(T, 105.0).get_value(sim)
    tol = 4 * res["hedge_error_std"] / math.sqrt(OWN_PATHS) + 1e-4
    assert abs(res["value"] - mc_euro) < tol
    assert abs(res["value"] - res["premium"]) < 0.25
    assert abs(res["hedge_error_mean"]) < tol
    res = thd.DeltaHedgedPortfolio(T, 95.0, is_call=False).simulate(sim)
    an = tanalytic.black_scholes_option_value(S0, R, SIG, T, 95.0,
                                              is_call=False)
    assert abs(res["premium"] - an) < 1e-12
    mc_euro = tbs.EuropeanOption(T, 95.0, is_call=False).get_value(sim)
    assert abs(res["value"] - mc_euro) \
        < 4 * res["hedge_error_std"] / math.sqrt(OWN_PATHS) + 1e-4
    swap = thd.VarianceSwap(T)
    v, _ = swap.get_value_and_error(sim)
    assert abs(v - math.exp(-R * T) * swap.fair_strike(sim)) < 1e-12
    coarse = thd.DeltaHedgedPortfolio(T, 105.0).simulate(
        own_sim(25, paths=20_000))["hedge_error_std"]
    fine = thd.DeltaHedgedPortfolio(T, 105.0).simulate(
        own_sim(400, paths=20_000))["hedge_error_std"]
    assert 2.5 < coarse / fine < 6.0


def test_variance_swap_fair_strike_on_the_port_stream():
    sim = own_sim(250, paths=20_000)
    k = thd.VarianceSwap(T).fair_strike(sim)
    dt = T / 250
    expect = SIG ** 2 + (R - 0.5 * SIG ** 2) ** 2 * dt
    assert abs(k - expect) < 4 * SIG ** 2 * math.sqrt(2 * dt)


def test_needs_black_scholes_facade():
    sim = own_sim(4, paths=16)
    facade = SimpleNamespace(model=SimpleNamespace(initial_value=S0),
                             process=sim.process,
                             get_asset_values=sim.get_asset_values,
                             get_numeraire=sim.get_numeraire)
    with pytest.raises(NotImplementedError):
        thd.DeltaHedgedPortfolio(T, 100.0).get_value(facade)
    # the variance swap runs on any facade with a spot
    assert math.isfinite(thd.VarianceSwap(T).fair_strike(facade))


# -- the Merton facade (tests/test_hedging.py:73, 97, 108) -------------------------

def _merton(lam=0.8, mu_j=-0.12, sig_j=0.18, sigma=0.2):
    return dict(initial_value=S0, risk_free_rate=R, volatility=sigma,
                jump_intensity=lam, jump_size_mean=mu_j, jump_size_std=sig_j)


def test_merton_variance_swap_and_hedge_gate():
    """On the JAX Merton facade's asset matrix (its own stream, 50 steps,
    20,000 paths, seed 9) the variance swap's fair strike equal in both
    packages within 1e-9 relative; on the port's own Merton facade the
    jump contribution sigma^2 + lam (mu_J^2 + sigma_J^2) within 15% (200,000
    paths), the jump facade's strike above Black-Scholes' at the same
    diffusion vol (100,000 paths), and the delta hedge gated to
    Black-Scholes."""
    from finmath_tpu.models import hedging as jhd
    from finmath_tpu.models import merton as jm
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)
    from finmath_tpu.ops.random_variable import RandomVariableTPU
    from finmath_tpu_torch.models import merton as tm
    from finmath_tpu_torch.ops.random_variable import RandomVariableTorch

    def model(rv):
        return SimpleNamespace(numeraire=lambda t: rv(t, math.exp(R * t)),
                               initial_value=S0)

    jtd = JTD(initial=0.0, num_steps=50, step=T / 50)
    jsim = jm.MonteCarloMertonModel(jtd, PATHS, jm.MertonParams(**_merton()),
                                    seed=9)
    assets = np.asarray(jsim.get_asset_values(list(jtd.as_array()[1:])))
    jk = jhd.VarianceSwap(T).fair_strike(jax_facade(jtd, assets,
                                                    model(RandomVariableTPU)))
    k = thd.VarianceSwap(T).fair_strike(torch_facade(
        grid(50), assets, model(RandomVariableTorch)))
    assert k == pytest.approx(jk, rel=1e-9)
    sim = tm.MonteCarloMertonModel(grid(50), 200_000,
                                   tm.MertonParams(**_merton()), seed=9,
                                   device=CPU)
    k = thd.VarianceSwap(T).fair_strike(sim)
    expect = 0.2 ** 2 + 0.8 * (0.12 ** 2 + 0.18 ** 2)
    assert abs(k - expect) < 0.15 * expect
    sim = tm.MonteCarloMertonModel(grid(50), 100_000,
                                   tm.MertonParams(**_merton(sigma=SIG)),
                                   seed=9, device=CPU)
    k_m = thd.VarianceSwap(T).fair_strike(sim)
    k_b = thd.VarianceSwap(T).fair_strike(own_sim(50, seed=9,
                                                  paths=100_000))
    assert k_m > k_b
    gate = tm.MonteCarloMertonModel(
        grid(20), 10_000, tm.MertonParams(S0, R, 0.2, 0.5, -0.1, 0.2),
        device=CPU)
    with pytest.raises(NotImplementedError):
        thd.DeltaHedgedPortfolio(T, 100.0).get_value(gate)
