"""The port's equity facades under path-axis sharding (``mesh=``), on one
spawned gloo world of four CPU ranks: ``tests/test_equity_mesh.py``'s cases
at 64,000 paths. Every rank draws the facade's global Brownian stream and
simulates its block of it, so a meshed facade prices the unsharded
facade's paths, and its products' means and standard errors are global
(float64 all-reduces): within 1e-9 relative of the unsharded port facade
on the same stream, the JAX test's bound.

Also: the Black-Scholes facade on the finmath Mersenne stream, meshed in
the port and meshed in the JAX package (eight virtual devices), at the
facade parity bound of ``tests/test_torch_black_scholes.py`` (rel 1e-6);
a meshed ``RandomVariableTorch``'s reductions against NumPy on the whole
vector; and the products whose path reductions were local before they
were routed through the mesh (the Longstaff-Schwartz option, a structured
product, the variance swap, the local-vol call grid), which now return
global statistics, equal on every rank and within 1e-9 of the unsharded
facade's (``tests/test_torch_slv_products_mesh.py`` covers every such
product); a foreign mesh object still raises.

The ranks import only torch, numpy and the port (``rank_scenarios``); the
parent computes the unsharded and the JAX references while they run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.parallel.launch import start_world  # noqa: E402

W = 4
S0, R, SIG, T = 100.0, 0.05, 0.3, 1.0
N_PATHS = 64_000
MERSENNE_PATHS, MERSENNE_STEPS, MERSENNE_SEED = 16_384, 20, 3141
LV_R = 0.03
SURF = dict(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65, eta=0.6,
            gamma=0.4)
RV_SIZE = 10_000
HESTON = dict(initial_value=S0, risk_free_rate=R, v0=0.04, kappa=1.5,
              theta=0.05, xi=0.4, rho=-0.6)
CORR = [[1.0, 0.4], [0.4, 1.0]]


def td(n):
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    return TimeDiscretization(initial=0.0, num_steps=n, step=T / n)


def bs_products():
    from finmath_tpu_torch.models.black_scholes import EuropeanOption
    from finmath_tpu_torch.models.equity_products import (AsianOption,
                                                          BarrierOption,
                                                          LookbackOption)

    return {"european": EuropeanOption(T, 105.0),
            "asian": AsianOption([0.2, 0.6, T], 100.0),
            "asian_cv": AsianOption([0.2, 0.6, T], 100.0,
                                    control_variate="geometric"),
            "barrier": BarrierOption(T, 100.0, 130.0, "up-out"),
            "lookback": LookbackOption(T, "floating-call")}


def rv_values() -> np.ndarray:
    return np.random.default_rng(17).standard_normal(RV_SIZE).astype(
        np.float32)


def facades(mesh, device="cpu"):
    """name -> facade, each as the JAX test builds it."""
    from finmath_tpu_torch.models import black_scholes as tbs
    from finmath_tpu_torch.models import brownian_motion as tbm
    from finmath_tpu_torch.models import heston as th
    from finmath_tpu_torch.models import local_vol as tlv
    from finmath_tpu_torch.models import multi_asset as tma

    bs = tbs.BlackScholesModel(S0, R, SIG)
    mersenne_td = td(MERSENNE_STEPS)
    return {
        "bs": tbs.MonteCarloBlackScholesModel(td(50), N_PATHS, bs, seed=5,
                                              mesh=mesh, device=device),
        "heston": th.MonteCarloHestonModel(
            td(20), N_PATHS, th.HestonParams(**HESTON), seed=7, mesh=mesh,
            device=device),
        "rainbow": tma.MonteCarloMultiAssetBlackScholesModel(
            td(10), N_PATHS, tma.MultiAssetBlackScholesModel(
                [100.0, 95.0], R, [0.25, 0.35], CORR), seed=11, mesh=mesh,
            device=device),
        "local_vol": tlv.MonteCarloLocalVolModel(
            td(20), N_PATHS, tlv.LocalVolatilityModel(
                S0, LV_R, tlv.SSVISurface(**SURF), td(20)), seed=3,
            mesh=mesh, device=device),
        "mersenne": tbs.MonteCarloBlackScholesModel(
            mersenne_td, MERSENNE_PATHS, bs,
            brownian=tbm.BrownianMotionFinmathMersenne(
                mersenne_td, 1, MERSENNE_PATHS, MERSENNE_SEED, device=device),
            mesh=mesh, device=device),
    }


def prices(sims) -> dict:
    """(value, stderr) of every case of the file on its facade."""
    from finmath_tpu_torch.models.black_scholes import EuropeanOption
    from finmath_tpu_torch.models.multi_asset import (BasketOption,
                                                      ExchangeOption,
                                                      RainbowOption)

    out = {name: p.get_value_and_error(sims["bs"])
           for name, p in bs_products().items()}
    out["bs_european_rv"] = (EuropeanOption(T, 105.0).get_value(sims["bs"]),
                             0.0)
    out["heston"] = EuropeanOption(T, 100.0).get_value_and_error(
        sims["heston"])
    out["rainbow"] = RainbowOption(T, 100.0, "call-on-min"
                                   ).get_value_and_error(sims["rainbow"])
    out["exchange"] = ExchangeOption(T).get_value_and_error(sims["rainbow"])
    out["basket"] = BasketOption(T, [0.5, 0.5], 100.0).get_value_and_error(
        sims["rainbow"])
    out["local_vol"] = EuropeanOption(T, 100.0).get_value_and_error(
        sims["local_vol"])
    out["mersenne"] = EuropeanOption(T, 1.05 * S0).get_value_and_error(
        sims["mersenne"])
    return out


def _error(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - recorded for the parent
        return f"{type(exc).__name__}: {exc}"
    return None


def local_products(sims) -> dict:
    """(value, stderr) of the products whose path reductions were local
    before they were routed through the mesh; the call grid flattened."""
    from finmath_tpu_torch.models.american import BermudanOption
    from finmath_tpu_torch.models.hedging import VarianceSwap
    from finmath_tpu_torch.models.local_vol import european_call_values
    from finmath_tpu_torch.models.structured_products import CliquetOption

    sim = sims["bs"]
    return {
        "BermudanOption": BermudanOption(
            [0.5, T], 100.0, is_call=False).get_value_and_error(sim),
        "CliquetOption": CliquetOption(
            [0.5, T], -0.05, 0.1).get_value_and_error(sim),
        "VarianceSwap": VarianceSwap(T).get_value_and_error(sim),
        "european_call_values": tuple(european_call_values(
            sims["local_vol"], [100.0], [T]).ravel()),
    }


def rank_scenarios(mesh):
    from finmath_tpu_torch.models import black_scholes as tbs
    from finmath_tpu_torch.ops.random_variable import RandomVariableTorch

    sims = facades(mesh)
    out = {"prices": prices(sims)}
    states = sims["bs"].process._lazy_states()
    out["local_paths"] = int(states.shape[-1])
    out["asset_realizations"] = sims["bs"].get_asset_value(T) \
        .get_realizations()

    bad = tbs.MonteCarloBlackScholesModel(
        td(10), N_PATHS + 1, tbs.BlackScholesModel(S0, R, SIG), seed=5,
        mesh=mesh, device="cpu")
    out["indivisible"] = _error(lambda: bad.get_asset_value(T))

    x = rv_values()
    rv = RandomVariableTorch(0.0, x[mesh.local_slice(RV_SIZE)], device="cpu",
                             mesh=mesh)
    w = RandomVariableTorch(0.0, np.full(RV_SIZE // W, 1.0 / RV_SIZE,
                                         np.float32), device="cpu", mesh=mesh)
    scaled = rv.mult(2.0).add(rv)
    out["rv"] = dict(
        average=rv.get_average(), variance=rv.get_variance(),
        sample_variance=rv.get_sample_variance(),
        standard_error=rv.get_standard_error(), size=rv.size(),
        quantile=rv.get_quantile(0.9), minimum=rv.get_min(),
        maximum=rv.get_max(), weighted_average=rv.get_average(w),
        scaled_average=scaled.get_average(),
        scaled_meshed=scaled.mesh is mesh,
        realizations=rv.get_realizations())

    out["local_products"] = local_products(sims)
    out["foreign_mesh"] = _error(lambda: tbs.MonteCarloBlackScholesModel(
        td(10), N_PATHS, tbs.BlackScholesModel(S0, R, SIG), seed=5,
        mesh=object(), device="cpu"))
    out["collectives"] = mesh.calls
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    with start_world(f"{__name__}:rank_scenarios", W, backend="gloo",
                     device="cpu", threads=1,
                     directory=tmp_path_factory.mktemp("world")) as world:
        refs = _references()
        ranks = world.join(timeout=600)
    return ranks, refs


def _references() -> dict:
    from jax.sharding import Mesh
    import jax

    from finmath_tpu.models import black_scholes as jbs
    from finmath_tpu.models import brownian_motion as jbm
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    unsharded = facades(None)
    ref = {"prices": prices(unsharded),
           "local_products": local_products(unsharded)}
    jtd = JTD(initial=0.0, num_steps=MERSENNE_STEPS, step=T / MERSENNE_STEPS)
    jsim = jbs.MonteCarloBlackScholesModel(
        jtd, MERSENNE_PATHS, jbs.BlackScholesModel(S0, R, SIG),
        brownian=jbm.BrownianMotionFinmathMersenne(jtd, 1, MERSENNE_PATHS,
                                                   MERSENNE_SEED),
        mesh=Mesh(np.asarray(jax.devices()), ("paths",)))
    ref["jax_mersenne"] = jbs.EuropeanOption(T, 1.05 * S0
                                             ).get_value_and_error(jsim)
    return ref


@pytest.mark.parametrize("name", ["european", "asian", "asian_cv",
                                  "barrier", "lookback", "bs_european_rv"])
def test_bs_products_match_unsharded(run, name):
    ranks, refs = run
    a = refs["prices"][name]
    for r in ranks:
        b = r["prices"][name]
        assert abs(a[0] - b[0]) < 1e-9 * max(abs(a[0]), 1.0), name
        assert abs(a[1] - b[1]) <= 1e-9 * max(abs(a[1]), 1e-12), name


@pytest.mark.parametrize("name", ["heston", "rainbow", "exchange", "basket",
                                  "local_vol"])
def test_other_facades_match_unsharded(run, name):
    ranks, refs = run
    a = refs["prices"][name]
    for r in ranks:
        b = r["prices"][name]
        assert abs(a[0] - b[0]) < 1e-9 * a[0], name
        assert abs(a[1] - b[1]) < 1e-9 * a[1], name


def test_states_are_sharded_and_results_replicated(run):
    ranks, refs = run
    assert all(r["local_paths"] == N_PATHS // W for r in ranks)
    for r in ranks[1:]:
        assert r["prices"] == ranks[0]["prices"]
        np.testing.assert_array_equal(r["asset_realizations"],
                                      ranks[0]["asset_realizations"])
    assert ranks[0]["asset_realizations"].shape == (N_PATHS,)
    assert all(r["collectives"] == ranks[0]["collectives"] for r in ranks)


def test_indivisible_paths_raise(run):
    ranks, _ = run
    for r in ranks:
        assert r["indivisible"].startswith("ValueError"), r["indivisible"]


def test_mersenne_facade_matches_meshed_jax(run):
    ranks, refs = run
    for r in ranks:
        np.testing.assert_allclose(r["prices"]["mersenne"],
                                   refs["jax_mersenne"], rtol=1e-6)
        np.testing.assert_allclose(r["prices"]["mersenne"],
                                   refs["prices"]["mersenne"], rtol=1e-9)


def test_meshed_random_variable_reductions_match_numpy(run):
    from finmath_tpu_torch.ops._api import quantile_index

    ranks, _ = run
    x = rv_values()
    x64 = x.astype(np.float64)
    n = x.size
    for r in ranks:
        rv = r["rv"]
        assert rv["size"] == n
        assert rv["scaled_meshed"]
        np.testing.assert_array_equal(rv["realizations"], x)
        assert rv["average"] == pytest.approx(x64.mean(), rel=1e-12)
        assert rv["variance"] == pytest.approx(x64.var(), rel=1e-12)
        assert rv["sample_variance"] == pytest.approx(x64.var(ddof=1),
                                                      rel=1e-12)
        assert rv["standard_error"] == pytest.approx(
            np.sqrt(x64.var() / n), rel=1e-12)
        assert rv["quantile"] == float(np.sort(x)[quantile_index(n, 0.9)])
        assert rv["minimum"] == float(x.min())
        assert rv["maximum"] == float(x.max())
        assert rv["weighted_average"] == pytest.approx(
            np.sum(x64 * np.float32(1.0 / n)), rel=1e-9)
        assert rv["scaled_average"] == pytest.approx(3.0 * x64.mean(),
                                                     rel=1e-6)


def test_local_reductions_raise_under_a_mesh(run):
    """The products whose path reductions were local (they raised under a
    mesh before) now reduce over the ranks: the same statistics on every
    rank, within 1e-9 of the unsharded facade's; a foreign mesh object
    still raises."""
    ranks, refs = run
    for r in ranks:
        assert r["foreign_mesh"].startswith("NotImplementedError"), \
            r["foreign_mesh"]
        assert r["local_products"] == ranks[0]["local_products"]
        for name, got in r["local_products"].items():
            want = refs["local_products"][name]
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=0.0,
                                       err_msg=name)
