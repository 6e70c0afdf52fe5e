"""The port's finite-difference layer (``finmath_tpu_torch/models/pde.py``)
against closed forms, the CRR binomial American oracle, the port's
local-vol Monte Carlo, and finmath_tpu's theta scheme.

Tolerances against the JAX package (same grids, same payoffs, float64):
every model's and product's value grid, the strike strip, the vol ladder,
the American projection and the time-dependent local-vol coefficients
within 1e-11 of the grid's largest |value| (the prefix scans of the two
packages combine in different orders, and XLA's float64 ``exp`` and
``erf`` are not torch's; measured 2.3e-15 on these grids); vega by
autograd against ``jax.grad`` within 1e-9 relative (measured 5.5e-15).
The oracle checks are ``tests/test_pde.py``'s, with its grids and bounds. The factored induction (one elimination per theta) equals a
fresh solve each step bit for bit.
"""

import math
from statistics import NormalDist

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch import convert  # noqa: E402
from finmath_tpu_torch.models.american import crr_american_price  # noqa: E402
from finmath_tpu_torch.models.analytic import (  # noqa: E402
    black_scholes_option_value)
from finmath_tpu_torch.models.pde import (  # noqa: E402
    FDMAmericanCallOption,
    FDMAmericanPutOption,
    FDMBlackScholesModel,
    FDMConstantElasticityOfVarianceModel,
    FDMDigitalOption,
    FDMEuropeanCallOption,
    FDMEuropeanPutOption,
    FDMLocalVolatilityModel,
    _assemble_rows,
    fdm_black_scholes_prices,
    theta_scheme_solve,
)
from finmath_tpu_torch.ops.tridiagonal import (  # noqa: E402
    tridiagonal_matvec, tridiagonal_solve)

CPU = "cpu"
S0, R, SIGMA, T, K = 100.0, 0.05, 0.30, 1.0, 110.0
#: the parity grids (time steps, space steps)
SMALL = (40, 80)
LV_SMALL = (30, 60)
SKEW = dict(sigma0=0.22, sigma_inf=0.32, tau=1.2, rho=-0.55, eta=0.8,
            gamma=0.45)
FLAT = dict(sigma0=SIGMA, sigma_inf=SIGMA, tau=1.0, rho=0.0, eta=0.0,
            gamma=0.5)
STRIKES = [70.0, 85.0, 100.0, 115.0, 130.0]
VOLS = [[0.15], [0.30], [0.45]]
VEGA_GRID = (30, 101)


def _bs_model(nt=200, nx=400, theta=0.5):
    return FDMBlackScholesModel(
        num_timesteps=nt, num_spacesteps=nx, num_standard_deviations=8.0,
        center=S0, theta=theta, initial_value=S0, risk_free_rate=R,
        volatility=SIGMA)


def _cev_kw(beta, sigma, nt=200, nx=600):
    return dict(num_timesteps=nt, num_spacesteps=nx,
                num_standard_deviations=8.0, center=S0, theta=0.5,
                initial_value=S0, risk_free_rate=R, volatility=sigma,
                exponent=beta)


def _lv_kw(nt, nx, nsd, ref):
    return dict(num_timesteps=nt, num_spacesteps=nx,
                num_standard_deviations=nsd, theta=0.5, initial_value=S0,
                risk_free_rate=R, reference_vol=ref)


def _vega_inputs(nt, nx):
    x = np.linspace(math.log(S0) - 3.0, math.log(S0) + 3.0, nx)
    return x, np.maximum(np.exp(x) - K, 0.0), nt


def _interp_at_spot(x, v):
    xq = math.log(S0)
    idx = int(np.searchsorted(np.asarray(x), xq)) - 1
    w = (xq - x[idx]) / (x[idx + 1] - x[idx])
    return v[idx] * (1 - w) + v[idx + 1] * w


#: the JAX products and models of the parity cases, by name
PRODUCTS = {"call": ("FDMEuropeanCallOption", K),
            "put": ("FDMEuropeanPutOption", K),
            "american_put": ("FDMAmericanPutOption", K),
            "american_call": ("FDMAmericanCallOption", K),
            "digital": ("FDMDigitalOption", K)}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's value grids on the parity cases, once: each
    product on the small Black-Scholes grid, the CEV call, the flat and
    skewed local-vol calls, the strip, the ladder, and vega by
    ``jax.grad`` through the ``coeffs=`` solve (the JAX package compiles
    its time-dependent gradient for 20 s here; the port's ``coeff_fn``
    vega is held to the closed form and its ``coeffs=`` one to JAX)."""
    import jax
    import jax.numpy as jnp

    from finmath_tpu.models import pde as jp
    from finmath_tpu.models.local_vol import SSVISurface

    out = {"models": {}}
    bs = jp.FDMBlackScholesModel(*SMALL, 8.0, S0, 0.5, S0, R, SIGMA)
    out["models"]["bs"] = bs
    for name, (cls, strike) in PRODUCTS.items():
        out[name] = getattr(jp, cls)(T, strike).get_value(0.0, bs)
    cev = jp.FDMConstantElasticityOfVarianceModel(
        **_cev_kw(0.5, SIGMA * S0 ** 0.5, *SMALL))
    out["models"]["cev"] = cev
    out["cev"] = jp.FDMEuropeanPutOption(T, 80.0).get_value(0.0, cev)
    for name, kw, nsd, ref in (("flat", FLAT, 8.0, SIGMA),
                               ("skew", SKEW, 9.0, 0.35)):
        m = jp.FDMLocalVolatilityModel(surface=SSVISurface(**kw),
                                       **_lv_kw(*LV_SMALL, nsd, ref))
        out["models"][name] = m
        out[name] = jp.FDMEuropeanCallOption(T, K).get_value(0.0, m)
    kw = dict(num_timesteps=SMALL[0], num_spacesteps=SMALL[1])
    out["strip"] = jp.fdm_black_scholes_prices(S0, R, SIGMA, T, STRIKES,
                                               **kw)
    out["ladder"] = jp.fdm_black_scholes_prices(
        S0, R, jnp.asarray(VOLS), T, jnp.asarray([90.0, 100.0, 110.0]), **kw)
    x, terminal, nt = _vega_inputs(*VEGA_GRID)
    xj, tj = jnp.asarray(x), jnp.asarray(terminal)

    def price(sigma):
        coeffs = (jnp.full_like(xj, R) - 0.5 * sigma ** 2,
                  jnp.full_like(xj, 1.0) * sigma ** 2, jnp.full_like(xj, R))
        v = jp.theta_scheme_solve(xj, tj, None, T, nt, coeffs=coeffs)
        return _interp_at_spot(x, v)

    value, vega = jax.jit(jax.value_and_grad(price))(jnp.asarray(SIGMA))
    out["vega"] = (float(value), float(vega))
    return out


def _close(got, want, rel=1e-11):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rel * np.max(np.abs(want))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("product", sorted(PRODUCTS))
def test_products_match_jax(jax_side, product):
    model = convert.fdm_model_from_jax(jax_side["models"]["bs"])
    cls, strike = PRODUCTS[product]
    from finmath_tpu_torch.models import pde

    spots, values = getattr(pde, cls)(T, strike).get_value(0.0, model,
                                                           device=CPU)
    np.testing.assert_array_equal(spots, jax_side[product][0])
    _close(values, jax_side[product][1])


@pytest.mark.parametrize("name", ["cev", "flat", "skew"])
def test_models_match_jax(jax_side, name):
    model = convert.fdm_model_from_jax(jax_side["models"][name])
    product = (FDMEuropeanPutOption(T, 80.0) if name == "cev"
               else FDMEuropeanCallOption(T, K))
    spots, values = product.get_value(0.0, model, device=CPU)
    np.testing.assert_array_equal(spots, jax_side[name][0])
    _close(values, jax_side[name][1])


def test_strip_and_ladder_match_jax(jax_side):
    kw = dict(num_timesteps=SMALL[0], num_spacesteps=SMALL[1], device=CPU)
    _close(fdm_black_scholes_prices(S0, R, SIGMA, T, STRIKES, **kw),
           jax_side["strip"])
    _close(fdm_black_scholes_prices(S0, R, np.asarray(VOLS), T,
                                    [90.0, 100.0, 110.0], **kw),
           jax_side["ladder"])


def _port_price(sigma, nt, nx, time_dependent=True):
    """The call at S0 through a solve whose coefficients depend on
    ``sigma``: through ``coeff_fn`` or, when not ``time_dependent``,
    ``coeffs=``."""
    x, terminal, nt = _vega_inputs(nt, nx)
    ones = torch.ones(x.shape, dtype=torch.float64)
    coeffs = (ones * R - 0.5 * sigma ** 2, ones * sigma ** 2, ones * R)
    if time_dependent:
        v = theta_scheme_solve(x, terminal, lambda t: coeffs, T, nt,
                               device=CPU)
    else:
        v = theta_scheme_solve(x, terminal, None, T, nt, coeffs=coeffs,
                               device=CPU)
    return _interp_at_spot(x, v)


def test_vega_by_autograd_matches_jax(jax_side):
    sigma = torch.tensor(SIGMA, dtype=torch.float64, requires_grad=True)
    value = _port_price(sigma, *VEGA_GRID, time_dependent=False)
    value.backward()
    want_value, want_vega = jax_side["vega"]
    assert abs(value.item() - want_value) <= 1e-11 * abs(want_value)
    assert abs(float(sigma.grad) - want_vega) <= 1e-9 * abs(want_vega)


# ---------------------------------------------------------------------------
# tests/test_pde.py's checks on the port
# ---------------------------------------------------------------------------

def test_call_and_put_match_closed_form():
    model = _bs_model()
    for cls, is_call in ((FDMEuropeanCallOption, True),
                         (FDMEuropeanPutOption, False)):
        value = cls(T, K).value(model, device=CPU)
        expected = black_scholes_option_value(S0, R, SIGMA, T, K, is_call)
        assert abs(value - expected) < 2e-3 * expected


def test_grid_convergence_second_order():
    expected = black_scholes_option_value(S0, R, SIGMA, T, K, True)
    errs = []
    for nt, nx in [(50, 100), (100, 200), (200, 400)]:
        v = FDMEuropeanCallOption(T, K).value(_bs_model(nt, nx), device=CPU)
        errs.append(abs(v - expected))
    assert errs[1] < 0.5 * errs[0]
    assert errs[2] < 0.5 * errs[1]
    assert errs[2] < 5e-3


def test_get_value_returns_grids():
    spots, values = FDMEuropeanCallOption(T, K).getValue(0.0, _bs_model(),
                                                         device=CPU)
    assert spots.shape == values.shape == (401,)
    assert np.all(np.diff(spots) > 0)
    assert values[-1] == pytest.approx(spots[-1] - K * math.exp(-R * T),
                                       rel=2e-3)
    assert values[0] < 1e-6
    with pytest.raises(NotImplementedError):
        FDMEuropeanCallOption(T, K).get_value(0.5, _bs_model(), device=CPU)


def test_digital_with_rannacher_smoothing():
    value = FDMDigitalOption(T, K).value(_bs_model(400, 800), device=CPU)
    d2 = ((math.log(S0 / K) + (R - 0.5 * SIGMA ** 2) * T)
          / (SIGMA * math.sqrt(T)))
    assert abs(value - math.exp(-R * T) * NormalDist().cdf(d2)) < 2e-3


def test_american_put_matches_binomial():
    value = FDMAmericanPutOption(T, K).value(_bs_model(400, 800), device=CPU)
    oracle = crr_american_price(S0, R, SIGMA, T, K, is_call=False,
                                num_steps=4000)
    assert abs(value - oracle) < 2e-3 * oracle


def test_american_against_european():
    model = _bs_model()
    am = FDMAmericanPutOption(T, K).value(model, device=CPU)
    eu = FDMEuropeanPutOption(T, K).value(model, device=CPU)
    assert am > eu
    # no dividends: the American call is the European one
    am = FDMAmericanCallOption(T, K).value(model, device=CPU)
    eu = FDMEuropeanCallOption(T, K).value(model, device=CPU)
    assert abs(am - eu) < 2e-3 * eu


def test_cev():
    # beta = 1 reduces to Black-Scholes
    model = FDMConstantElasticityOfVarianceModel(**_cev_kw(1.0, SIGMA))
    value = FDMEuropeanCallOption(T, K).value(model, device=CPU)
    expected = black_scholes_option_value(S0, R, SIGMA, T, K, True)
    assert abs(value - expected) < 4e-3 * expected
    # beta < 1: fatter left tail at the matched ATM vol, OTM puts richer
    beta = 0.5
    model = FDMConstantElasticityOfVarianceModel(
        **_cev_kw(beta, SIGMA * S0 ** (1.0 - beta)))
    put_cev = FDMEuropeanPutOption(T, 80.0).value(model, device=CPU)
    assert put_cev > black_scholes_option_value(S0, R, SIGMA, T, 80.0, False)


def test_strike_strip_and_vol_ladder():
    got = fdm_black_scholes_prices(S0, R, SIGMA, T, STRIKES, device=CPU)
    expected = [black_scholes_option_value(S0, R, SIGMA, T, k, True)
                for k in STRIKES]
    np.testing.assert_allclose(got, expected, rtol=4e-3, atol=2e-3)
    got = fdm_black_scholes_prices(S0, R, np.asarray(VOLS), T,
                                   [90.0, 100.0, 110.0], device=CPU)
    assert got.shape == (3, 3)
    for i, v in enumerate([0.15, 0.30, 0.45]):
        for j, k in enumerate([90.0, 100.0, 110.0]):
            expected = black_scholes_option_value(S0, R, v, T, k, True)
            assert abs(got[i, j] - expected) < 6e-3 * max(expected, 1.0)


def test_american_strip():
    got = fdm_black_scholes_prices(S0, R, SIGMA, T, [100.0, 120.0],
                                   is_call=False, american=True,
                                   num_timesteps=400, num_spacesteps=800,
                                   device=CPU)
    for k, v in zip([100.0, 120.0], got):
        oracle = crr_american_price(S0, R, SIGMA, T, k, is_call=False,
                                    num_steps=2000)
        assert abs(v - oracle) < 3e-3 * oracle


def test_vega_by_autograd_matches_closed_form():
    sigma = torch.tensor(SIGMA, dtype=torch.float64, requires_grad=True)
    _port_price(sigma, 100, 401).backward()
    sqrt_t = math.sqrt(T)
    d1 = ((math.log(S0 / K) + (R + 0.5 * SIGMA ** 2) * T)
          / (SIGMA * sqrt_t))
    expected = S0 * math.exp(-0.5 * d1 ** 2) / math.sqrt(2 * math.pi) \
        * sqrt_t
    assert abs(float(sigma.grad) - expected) < 2e-2 * expected


def _execution_inputs():
    x = np.linspace(math.log(S0) - 2.4, math.log(S0) + 2.4, 201)
    spots = np.exp(x)
    terminal = np.maximum(spots - K, 0.0)
    coeffs = (np.full_like(x, R - 0.5 * SIGMA ** 2),
              np.full_like(x, SIGMA ** 2), np.full_like(x, R))
    return x, spots, terminal, coeffs


def test_coeffs_path_matches_coeff_fn_path():
    x, spots, terminal, coeffs = _execution_inputs()

    def coeff_fn(t):
        del t
        return tuple(torch.as_tensor(c) for c in coeffs)

    via_fn = theta_scheme_solve(x, terminal, coeff_fn, T, 60,
                                underlying=spots, device=CPU)
    via_arrays = theta_scheme_solve(x, terminal, None, T, 60,
                                    underlying=spots, coeffs=coeffs,
                                    device=CPU)
    np.testing.assert_allclose(via_fn.numpy(), via_arrays.numpy(),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="coeff_fn"):
        theta_scheme_solve(x, terminal, None, T, 60, device=CPU)


@pytest.mark.parametrize("american", [False, True])
def test_factored_induction_equals_fresh_solves(american):
    """The induction factors each theta's matrix once; a loop that
    assembles and solves afresh every step gives the same bits."""
    x, spots, terminal, coeffs = _execution_inputs()
    terminal = np.stack([terminal, np.maximum(spots - 90.0, 0.0)])
    nt, rannacher = 60, 2
    got = theta_scheme_solve(x, terminal, None, T, nt, underlying=spots,
                             coeffs=coeffs, rannacher=rannacher,
                             obstacle=terminal if american else None,
                             device=CPU)
    dx = float(x[1] - x[0])
    g_top = float((spots[-3] - 3.0 * spots[-2] + 2.0 * spots[-1])
                  / (spots[-1] - spots[-2]))
    g_bot = float((2.0 * spots[0] - 3.0 * spots[1] + spots[2])
                  / (spots[0] - spots[1]))
    LO, DI, UP = _assemble_rows(*(torch.as_tensor(c) for c in coeffs), dx,
                                g_top, g_bot)
    dt = T / nt
    v = torch.as_tensor(terminal)
    for step in range(nt):
        th = 1.0 if step < rannacher else 0.5
        rhs = v + ((1.0 - th) * dt) * tridiagonal_matvec(LO, DI, UP, v)
        im = th * dt
        v = tridiagonal_solve(-im * LO, 1.0 - im * DI, -im * UP, rhs)
        if american:
            v = torch.maximum(v, torch.as_tensor(terminal))
    assert torch.equal(got, v)


def test_flat_ssvi_surface_reduces_to_black_scholes():
    from finmath_tpu_torch.models.local_vol import SSVISurface

    model = FDMLocalVolatilityModel(surface=SSVISurface(**FLAT),
                                    **_lv_kw(200, 400, 8.0, SIGMA))
    value = FDMEuropeanCallOption(T, K).value(model, device=CPU)
    expected = black_scholes_option_value(S0, R, SIGMA, T, K, True)
    assert abs(value - expected) < 4e-3 * expected


def test_skewed_surface_matches_mc_engine():
    from finmath_tpu_torch.models.local_vol import (
        LocalVolatilityModel, MonteCarloLocalVolModel, SSVISurface,
        european_call_values)
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    surface = SSVISurface(**SKEW)
    surface.validate(2.0)
    pde_model = FDMLocalVolatilityModel(surface=surface,
                                        **_lv_kw(200, 400, 9.0, 0.35))
    strikes = [90.0, 100.0, 110.0]
    pde = [FDMEuropeanCallOption(T, k).value(pde_model, device=CPU)
           for k in strikes]
    td = TimeDiscretization(initial=0.0, num_steps=100, step=T / 100)
    lv = LocalVolatilityModel(S0, R, surface, td)
    mc_model = MonteCarloLocalVolModel(td, num_paths=200_000, model=lv,
                                       seed=4242, device=CPU)
    mc = np.asarray(european_call_values(mc_model, strikes, [T]))
    values, stderr = mc[0, :, 0], mc[0, :, 1]
    np.testing.assert_array_less(np.abs(np.asarray(pde) - values),
                                 4.0 * stderr + 0.02)


@pytest.mark.gpu
def test_solves_on_card_match_cpu():
    """The strip, the American strip and the skewed local-vol call on the
    card against the same solves on the CPU, within 1e-12 of the largest
    value (the card's float64 ``exp``, ``erf`` and a contracted
    multiply-add may round otherwise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from finmath_tpu_torch.models.local_vol import SSVISurface

    for kw in (dict(), dict(is_call=False, american=True)):
        cpu = fdm_black_scholes_prices(S0, R, SIGMA, T, STRIKES, device=CPU,
                                       **kw)
        card = fdm_black_scholes_prices(S0, R, SIGMA, T, STRIKES,
                                        device="cuda", **kw)
        _close(card, cpu, 1e-12)
    model = FDMLocalVolatilityModel(surface=SSVISurface(**SKEW),
                                    **_lv_kw(200, 400, 9.0, 0.35))
    cpu = FDMEuropeanCallOption(T, K).get_value(0.0, model, device=CPU)[1]
    card = FDMEuropeanCallOption(T, K).get_value(0.0, model,
                                                 device="cuda")[1]
    _close(card, cpu, 1e-12)
