"""The port's Longstaff-Schwartz Bermudan (``finmath_tpu_torch/models/
american.py``) against finmath_tpu's, on ``tests/test_american.py``'s
market (S0 100, K 110, r 5%, sigma 30%, T 1, 50 exercise dates).

* ``crr_american_price``: within 1e-12 of the JAX one (the same NumPy
  code; measured equal).
* On the SAME asset matrix (the JAX facade's on 20,000
  ``BrownianMotionFinmathMersenne`` paths, copied with NumPy), for the put
  and the call, split and in-sample, degrees 3 and 2. The decision
  compares a path's exercise value with a float32 continuation from betas
  fitted on a Gram that the JAX package sums in float32 and the port in
  float64 (the JAX Gram's entries carry its float32 rounding, about 1e-6
  relative), so a few paths near the boundary decide differently. Date by
  date on the JAX kernel's own cash (``jax_cashflows``: the JAX arithmetic
  with the cash returned, first checked against ``_ls_kernel``'s value and
  error to 1e-14), at most 25 decisions differ over the 49 regressions
  (measured 2, 5, 3 and 0; 3, 11, 3 and 0 when the port's Gram was float32
  too). Run free, each such path changes the next regressions' right-hand
  side, and the differences cascade: 11-473 of 20,000 paths end with
  another cashflow (none for the call, which is never exercised), and the
  values sit up to 0.104 standard errors apart (0.104 end to end on the
  Mersenne paths). The bound is 0.25 standard errors: 0.05 does not hold
  for a regression whose decisions cascade.
* On the port's own torch stream: ``tests/test_american.py``'s CRR bounds,
  the call equal to the European, one in-sample date equal to the
  European; and the validation errors of the JAX module.
* On the Merton facade: the early-exercise premium of
  ``tests/test_american.py:103``, on the JAX facade's matrix and the
  port's own."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models import american as tam  # noqa: E402
from finmath_tpu_torch.models import black_scholes as tbs  # noqa: E402
from finmath_tpu_torch.models import brownian_motion as tbm  # noqa: E402
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

from test_torch_equity_products import (jax_facade,  # noqa: E402
                                        torch_facade)

S0, R, SIG, T, K = 100.0, 0.05, 0.3, 1.0, 110.0
N_EX, PATHS, SEED, OWN_PATHS = 50, 20_000, 3141, 50_000
EX_TIMES = [i * T / N_EX for i in range(1, N_EX + 1)]
CPU = "cpu"
# (id, is_call, basis_degree, foresight_bias)
CASES = [("put-split", False, 3, "split"), ("put-insample", False, 3,
                                             "insample"),
         ("put-degree-2", False, 2, "split"), ("call-split", True, 3,
                                               "split")]


def grid():
    return TimeDiscretization(initial=0.0, num_steps=N_EX, step=T / N_EX)


def jax_cashflows(asset, dfs, strike, is_call, degree, split):
    """``finmath_tpu/models/american.py:49 _ls_kernel``'s arithmetic with
    the per-path cash returned: (cash, [value, stderr], history), history
    ``[E, paths]`` the cash after each exercise date (row E - 1 the last
    date's discounted intrinsic)."""
    import jax
    import jax.numpy as jnp
    from finmath_tpu.ops.conditional_expectation import _cholesky_solve_small

    f64 = jnp.float64

    @jax.jit
    def run(asset, dfs, strike):
        e_n, paths = asset.shape
        sign = 1.0 if is_call else -1.0
        intrinsic = jnp.maximum(sign * (asset - strike), 0.0)
        disc = intrinsic.astype(f64) * dfs.astype(f64)
        fit_mask = (jnp.arange(paths) % 2 == 0) if split else jnp.ones(
            (paths,), dtype=bool)

        def step(cash, i):
            s = asset[i].astype(jnp.float32)
            ex = disc[i]
            itm = intrinsic[i] > 0.0
            w = (itm & fit_mask).astype(jnp.float32)
            nw = jnp.maximum(jnp.sum(w.astype(f64)), 1.0)
            mu = jnp.sum((s * w).astype(f64)) / nw
            sd = jnp.sqrt(jnp.maximum(
                jnp.sum(((s - mu.astype(jnp.float32)) ** 2 * w
                         ).astype(f64)) / nw, 1e-12))
            xn = (s - mu.astype(jnp.float32)) / sd.astype(jnp.float32)
            basis = jnp.stack([xn ** k for k in range(degree + 1)])
            bw = basis * w[None, :]
            gram = jnp.matmul(bw, basis.T,
                              precision=jax.lax.Precision.HIGHEST
                              ).astype(f64)
            gram = gram + 1e-10 * jnp.eye(degree + 1, dtype=f64)
            rhs = jnp.sum(bw.astype(f64) * cash[None, :], axis=1)
            beta = _cholesky_solve_small(gram, rhs)
            cont = beta.astype(jnp.float32) @ basis
            exercise = itm & (ex > cont.astype(f64))
            new = jnp.where(exercise, ex, cash)
            return new, new

        cash, hist = jax.lax.scan(step, disc[e_n - 1],
                                  jnp.arange(e_n - 2, -1, -1))
        hist = jnp.concatenate([hist[::-1], disc[e_n - 1][None]])
        mask = (~fit_mask).astype(f64) if split else jnp.ones((paths,), f64)
        n = jnp.sum(mask)
        mean = jnp.sum(cash * mask) / n
        var = jnp.sum((cash - mean) ** 2 * mask) / n
        return cash, jnp.stack([mean, jnp.sqrt(var / n)]), hist

    cash, out, hist = run(asset, dfs, strike)
    return np.array(cash), np.array(out), np.array(hist)


@pytest.fixture(scope="module")
def jax_side():
    import jax.numpy as jnp
    from finmath_tpu.models import american as jam
    from finmath_tpu.models import black_scholes as jbs
    from finmath_tpu.models import brownian_motion as jbm
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    td = JTD(initial=0.0, num_steps=N_EX, step=T / N_EX)
    sim = jbs.MonteCarloBlackScholesModel(
        td, PATHS, jbs.BlackScholesModel(S0, R, SIG),
        brownian=jbm.BrownianMotionFinmathMersenne(td, 1, PATHS, SEED))
    assets = np.array(sim.get_asset_values(EX_TIMES))
    facade = jax_facade(td, assets, sim.model)
    dfs = np.exp(-R * np.asarray(EX_TIMES))[:, None]
    out = {}
    for cid, call, degree, bias in CASES:
        opt = jam.BermudanOption(EX_TIMES, K, is_call=call,
                                 basis_degree=degree, foresight_bias=bias)
        cash, packed, hist = jax_cashflows(
            jnp.asarray(assets), jnp.asarray(dfs),
            jnp.asarray(K, jnp.float32), call, degree, bias == "split")
        kernel = np.asarray(jam._ls_kernel(
            jnp.asarray(assets), jnp.asarray(dfs),
            jnp.asarray(K, jnp.float32), call, degree, bias == "split"))
        out[cid] = dict(product=opt, cash=cash, packed=packed, kernel=kernel,
                        history=hist,
                        on_matrix=opt.get_value_and_error(facade),
                        end_to_end=opt.get_value_and_error(sim))
    return dict(assets=assets, cases=out)


@pytest.mark.parametrize("cid,call,degree,bias", CASES,
                         ids=[c[0] for c in CASES])
def test_on_the_same_asset_matrix(jax_side, cid, call, degree, bias):
    case = jax_side["cases"][cid]
    # the replica is the JAX kernel's arithmetic
    np.testing.assert_allclose(case["packed"], case["kernel"], rtol=1e-14)
    np.testing.assert_allclose(case["kernel"], case["on_matrix"], rtol=1e-14)
    product = convert.equity_product_from_jax(case["product"])
    assert type(product) is tam.BermudanOption
    facade = torch_facade(grid(), jax_side["assets"],
                          tbs.BlackScholesModel(S0, R, SIG))
    v, e = product.get_value_and_error(facade)
    jv, je = case["on_matrix"]
    assert abs(v - jv) < 0.25 * je, (v, jv, je)
    assert e == pytest.approx(je, rel=0.01)
    # date by date on the JAX cash: the decisions differ on a few paths
    assets = torch.as_tensor(jax_side["assets"])
    dfs = torch.as_tensor(np.exp(-R * np.asarray(EX_TIMES))[:, None])
    intrinsic = torch.clamp_min((1.0 if call else -1.0) * (
        assets - torch.tensor(K, dtype=torch.float32)), 0.0)
    disc = intrinsic.to(torch.float64) * dfs
    fit = (torch.arange(PATHS) % 2 == 0) if bias == "split" else \
        torch.ones(PATHS, dtype=torch.bool)
    hist = case["history"]
    seeds = 0
    for i in range(N_EX - 2, -1, -1):
        new = tam._ls_step(assets[i], intrinsic[i], disc[i],
                           torch.as_tensor(hist[i + 1]), fit, degree)
        seeds += int(np.sum(new.numpy() != hist[i]))
    assert seeds <= 25, seeds


def test_end_to_end_on_mersenne_paths(jax_side):
    td = grid()
    sim = tbs.MonteCarloBlackScholesModel(
        td, PATHS, tbs.BlackScholesModel(S0, R, SIG),
        brownian=tbm.BrownianMotionFinmathMersenne(td, 1, PATHS, SEED,
                                                   device=CPU))
    for cid, *_ in CASES:
        case = jax_side["cases"][cid]
        v, e = convert.equity_product_from_jax(
            case["product"]).get_value_and_error(sim)
        jv, je = case["end_to_end"]
        assert abs(v - jv) < 0.25 * je, (cid, v, jv, je)


def test_crr_matches_jax():
    from finmath_tpu.models import american as jam

    for args, kw in (((S0, R, SIG, T, K), {}),
                     ((S0, R, SIG, T, K), {"is_call": True}),
                     ((S0, R, SIG, T, 95.0), {"num_steps": 500,
                                              "dividend_yield": 0.03}),
                     ((S0, R, SIG, T, K, False, 4000), {})):
        assert tam.crr_american_price(*args, **kw) == pytest.approx(
            jam.crr_american_price(*args, **kw), rel=1e-12)
    with pytest.raises(ValueError, match="unstable"):
        tam.crr_american_price(S0, 5.0, 0.01, T, K, num_steps=2)


def test_port_stream_against_crr_and_european():
    sim = tbs.MonteCarloBlackScholesModel(
        grid(), OWN_PATHS, tbs.BlackScholesModel(S0, R, SIG), seed=123,
        device=CPU)
    crr = tam.crr_american_price(S0, R, SIG, T, K, is_call=False)
    v, err = tam.BermudanOption(EX_TIMES, K).get_value_and_error(sim)
    assert v < crr + 3 * err and v > crr - max(5 * err, 0.015 * crr)
    v, err = tam.BermudanOption(EX_TIMES, K, is_call=True) \
        .get_value_and_error(sim)
    eur = tbs.EuropeanOption(T, K, is_call=True).get_value(sim)
    assert abs(v - eur) < max(4 * err, 0.01 * eur)
    v = tam.BermudanOption([T], K, foresight_bias="insample").get_value(sim)
    eur = tbs.EuropeanOption(T, K, is_call=False).get_value(sim)
    np.testing.assert_allclose(v, eur, rtol=1e-6)


@pytest.mark.parametrize("args,kw", [
    (([1.0, 0.5], K), {}), (([], K), {}),
    (([1.0], K), {"basis_degree": 0}),
    (([1.0], K), {"foresight_bias": "none"})])
def test_validation_matches_jax(args, kw):
    from finmath_tpu.models import american as jam

    with pytest.raises(Exception) as jerr:
        jam.BermudanOption(*args, **kw)
    with pytest.raises(jerr.type, match=str(jerr.value).split()[0]):
        tam.BermudanOption(*args, **kw)


def test_stochastic_numeraire_raises():
    from types import SimpleNamespace

    facade = SimpleNamespace(
        get_asset_value=lambda t: SimpleNamespace(values=torch.ones(4)),
        get_numeraire=lambda t: SimpleNamespace(
            is_deterministic=lambda: t == 0.0, get_average=lambda: 1.0))
    with pytest.raises(NotImplementedError, match="deterministic numeraire"):
        tam.BermudanOption([0.5, 1.0], K).get_value(facade)


# -- the Merton facade (tests/test_american.py:103) --------------------------------

MERTON = dict(initial_value=100.0, risk_free_rate=0.05, volatility=0.25,
              jump_intensity=0.5, jump_size_mean=-0.2, jump_size_std=0.2)
MERTON_EX = [i * 0.05 for i in range(1, 21)]


def test_merton_early_exercise_premium():
    """On the JAX Merton facade's asset matrix (its own stream, 20,000
    paths, seed 21) the two packages' Longstaff-Schwartz values within the
    file's 0.25 standard errors, and on the port's own Merton facade
    (50,000 paths) the premium over the European beyond 2 standard
    errors."""
    from types import SimpleNamespace

    from finmath_tpu.models import american as jam
    from finmath_tpu.models import merton as jm
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)
    from finmath_tpu.ops.random_variable import RandomVariableTPU
    from finmath_tpu_torch.models import merton as tm
    from finmath_tpu_torch.ops.random_variable import RandomVariableTorch

    def model(rv):
        return SimpleNamespace(numeraire=lambda t: rv(t, math.exp(0.05 * t)),
                               initial_value=100.0)

    jtd = JTD(initial=0.0, num_steps=20, step=0.05)
    td = TimeDiscretization(initial=0.0, num_steps=20, step=0.05)
    jsim = jm.MonteCarloMertonModel(jtd, PATHS, jm.MertonParams(**MERTON),
                                    seed=21)
    assets = np.asarray(jsim.get_asset_values(list(jtd.as_array()[1:])))
    jopt = jam.BermudanOption(MERTON_EX, 110.0, is_call=False)
    jv, je = jopt.get_value_and_error(
        jax_facade(jtd, assets, model(RandomVariableTPU)))
    v, _ = convert.equity_product_from_jax(jopt).get_value_and_error(
        torch_facade(td, assets, model(RandomVariableTorch)))
    assert abs(v - jv) < 0.25 * je, (v, jv, je)
    sim = tm.MonteCarloMertonModel(td, 50_000, tm.MertonParams(**MERTON),
                                   seed=21, device=CPU)
    amer, err = tam.BermudanOption(MERTON_EX, 110.0, is_call=False) \
        .get_value_and_error(sim)
    eur = tbs.EuropeanOption(1.0, 110.0, is_call=False).get_value(sim)
    assert amer > eur + 2 * err          # jumps deepen the premium
