"""Path-axis sharding of Heston-SLV and of the equity products whose path
reductions were local before (the Longstaff-Schwartz Bermudan, the delta
hedge, the variance swap, the five structured products and the local-vol
call grid), on one spawned gloo world of four CPU ranks (a ``file://``
store, one thread a rank).

The ranks import only torch, numpy and the port: every scenario runs in
``rank_scenarios`` at module level (no JAX import) and returns its
results. Each rank's block is a multiple of 16 paths (torch's vectorised
CPU loops compute a ragged tail with the scalar ``exp`` / ``log``, so
other blocks move the float32 paths in their last bit). The parent
computes the references while the world runs: the unsharded port on the
same global streams, and the meshed JAX Black-Scholes facade on the
finmath Mersenne stream (conftest's eight virtual devices).

Bounds against the unsharded port on the same stream:

* every product on the meshed Black-Scholes facade and the call grid on
  the meshed local-vol facade: within 1e-9 relative, the bound of
  ``tests/test_equity_mesh.py`` (the meshed sums are float64 sums of
  per-rank float64 sums); the Bermudan in both ``split`` and
  ``insample`` modes, its per-path cashflows (the exercise decisions of
  every date) equal to the unsharded ones on every path;
* Heston-SLV at 4 x 1,024 paths x 20 steps: the meshed fit on the
  ranks' blocks of one cloud against the unsharded fit on all of it,
  ``(beta, m, s)`` within 1e-6 relative (beta of its largest entry) at
  the second and the last step; at the first step, whose cloud is one
  point, m and s within 1e-6 and both fits' E[V | k] on the cloud within
  1e-5 of v0 (``test_slv_fits_of_the_first_steps``); the meshed run's
  states within rtol 1e-5 and ``leverage_at`` within 1e-4 of the
  unsharded run's, the envelope ``tests/test_torch_slv.py`` holds
  between the port and JAX; the call grid within 1e-3 of its standard
  error.

Against the meshed JAX facade on the Mersenne stream, the unsharded
parity bounds: the Bermudan within 0.25 standard errors
(``tests/test_torch_american.py``: the float32 Gram sums of the two
packages decide a few boundary paths differently) and the cliquet within
1e-6 relative (``tests/test_torch_structured_products.py``).

Every rank returns the same results, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.parallel.launch import start_world  # noqa: E402

W = 4
S0, R, SIG, T = 100.0, 0.05, 0.3, 1.0
N_PATHS = 64_000                     # 16,000 = 1,000 x 16 paths a rank
BS_STEPS = 50
LV_R, LV_STEPS = 0.03, 20
SURF = dict(sigma0=0.22, sigma_inf=0.20, tau=2.0, rho=-0.65, eta=0.6,
            gamma=0.4)
SLV_HESTON = dict(initial_value=S0, risk_free_rate=LV_R, v0=0.04,
                  kappa=1.5, theta=0.06, xi=0.8, rho=-0.7)
SLV_PATHS, SLV_STEPS, SLV_SEED = 4 * 1_024, 20, 8
FIT_STEPS = (0, 1, SLV_STEPS - 1)
STRIKES = [85.0, 100.0, 120.0]
EXPIRIES = [0.5, 1.0]
EX_TIMES = [0.2, 0.4, 0.6, 0.8, 1.0]
MERSENNE_PATHS, MERSENNE_STEPS, MERSENNE_SEED = 16_384, 20, 3141


def td(n, horizon=T):
    from finmath_tpu_torch.models.time_discretization import (
        TimeDiscretization)

    return TimeDiscretization(initial=0.0, num_steps=n, step=horizon / n)


def bermudans():
    from finmath_tpu_torch.models.american import BermudanOption

    return {bias: BermudanOption(EX_TIMES, 110.0, is_call=False,
                                 foresight_bias=bias)
            for bias in ("split", "insample")}


def structured():
    from finmath_tpu_torch.models import structured_products as sp

    return {
        "forward_start": sp.ForwardStartOption(0.4, T, 1.05),
        "cliquet": sp.CliquetOption([0.2, 0.4, 0.6, 0.8, T], -0.05, 0.1),
        "compound": sp.CompoundOption(0.4, 8.0, T, 100.0),
        "autocallable": sp.AutocallableNote(
            [0.4, 0.8, T], [105.0, 100.0, 100.0], [0.04, 0.08, 0.12], 70.0,
            coupon_levels=[90.0, 90.0, 90.0], memory=True),
        "chooser": sp.ChooserOption(0.4, T, 100.0),
    }


def slv_model():
    from finmath_tpu_torch.models import heston as th
    from finmath_tpu_torch.models import local_vol as tlv
    from finmath_tpu_torch.models import slv as tslv

    return tslv.HestonSLVModel(th.HestonParams(**SLV_HESTON),
                               tlv.SSVISurface(**SURF), td(SLV_STEPS))


def facades(mesh):
    """name -> facade on the CPU; ``mesh`` None gives the unsharded ones."""
    from finmath_tpu_torch.models import black_scholes as tbs
    from finmath_tpu_torch.models import brownian_motion as tbm
    from finmath_tpu_torch.models import local_vol as tlv
    from finmath_tpu_torch.models import slv as tslv

    bs = tbs.BlackScholesModel(S0, R, SIG)
    mtd = td(MERSENNE_STEPS)
    return {
        "bs": tbs.MonteCarloBlackScholesModel(
            td(BS_STEPS), N_PATHS, bs, seed=5, mesh=mesh, device="cpu"),
        "local_vol": tlv.MonteCarloLocalVolModel(
            td(LV_STEPS), N_PATHS, tlv.LocalVolatilityModel(
                S0, LV_R, tlv.SSVISurface(**SURF), td(LV_STEPS)), seed=3,
            mesh=mesh, device="cpu"),
        # under a mesh the facade takes the mesh's device
        "slv": tslv.MonteCarloHestonSLVModel(
            td(SLV_STEPS), SLV_PATHS, slv_model(), seed=SLV_SEED, mesh=mesh,
            device="cpu" if mesh is None else None),
        "mersenne": tbs.MonteCarloBlackScholesModel(
            mtd, MERSENNE_PATHS, bs,
            brownian=tbm.BrownianMotionFinmathMersenne(
                mtd, 1, MERSENNE_PATHS, MERSENNE_SEED, device="cpu"),
            mesh=mesh, device="cpu"),
    }


def _gather(x, mesh):
    return x if mesh is None else mesh.all_gather(x)


def scenarios(mesh) -> dict:
    """Every result of the file, on one rank (``mesh``) or unsharded."""
    from finmath_tpu_torch.models import american as tam
    from finmath_tpu_torch.models.equity_products import _f32
    from finmath_tpu_torch.models.hedging import (DeltaHedgedPortfolio,
                                                  VarianceSwap)
    from finmath_tpu_torch.models.local_vol import european_call_values
    from finmath_tpu_torch.models.slv import (_fit_conditional_variance,
                                              hat_basis)

    sims = facades(mesh)
    bs = sims["bs"]
    out = {"products": {}, "cash": {}}
    assets = bs.get_asset_values(EX_TIMES)
    dfs = torch.as_tensor(np.exp(-R * np.asarray(EX_TIMES))[:, None])
    for bias, opt in bermudans().items():
        out["products"][f"bermudan_{bias}"] = opt.get_value_and_error(bs)
        out["cash"][bias] = _gather(tam._ls_cashflows(
            assets, dfs, _f32(110.0, assets), False, 3, bias == "split",
            mesh), mesh).numpy()
    for name, product in structured().items():
        out["products"][name] = product.get_value_and_error(bs)
    hedge = DeltaHedgedPortfolio(T, 100.0).simulate(bs)
    for key in ("value", "hedge_error_mean", "hedge_error_std"):
        out["products"][f"hedge_{key}"] = (hedge[key], 0.0)
    swap = VarianceSwap(T)
    out["products"]["variance_swap"] = swap.get_value_and_error(bs)
    out["products"]["variance_swap_strike"] = (swap.fair_strike(bs), 0.0)
    out["call_grid"] = european_call_values(sims["local_vol"], STRIKES,
                                            EXPIRIES)

    slv = sims["slv"]
    model = slv.model
    states = slv.process._lazy_states()
    # the fits on one cloud: this rank's block of the unsharded run's
    cloud = facades(None)["slv"].process._lazy_states()
    if mesh is not None:
        cloud = cloud[..., mesh.local_slice(SLV_PATHS)]
    nodes = model._nodes_on(cloud.device)
    fits = {}
    for i in FIT_STEPS:
        k = model._moneyness(i, cloud[i, 0])
        beta, m, s = _fit_conditional_variance(
            k, torch.clamp_min(cloud[i, 1], 0.0), nodes, axis_name=mesh)
        cond = beta.to(torch.float32) @ hat_basis((k - m) / s, nodes)
        fits[i] = (beta.numpy(), float(m), float(s), cond.numpy())
    out["slv"] = dict(
        fits=fits, states=_gather(states, mesh).numpy(),
        leverage=slv.leverage_at(0.5, STRIKES),
        calls=european_call_values(slv, STRIKES, EXPIRIES),
        bound=None if mesh is None else model.mesh is mesh)

    mersenne = sims["mersenne"]
    out["mersenne"] = {
        "bermudan": bermudans()["split"].get_value_and_error(mersenne),
        "cliquet": structured()["cliquet"].get_value_and_error(mersenne)}
    return out


def rank_scenarios(mesh):
    out = scenarios(mesh)
    out["local_paths"] = int(facades(mesh)["bs"].process._lazy_states()
                             .shape[-1])
    out["collectives"] = mesh.calls
    return out


def _jax_references() -> dict:
    import jax
    from jax.sharding import Mesh

    from finmath_tpu.models import american as jam
    from finmath_tpu.models import black_scholes as jbs
    from finmath_tpu.models import brownian_motion as jbm
    from finmath_tpu.models import structured_products as jsp
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    jtd = JTD(initial=0.0, num_steps=MERSENNE_STEPS, step=T / MERSENNE_STEPS)
    sim = jbs.MonteCarloBlackScholesModel(
        jtd, MERSENNE_PATHS, jbs.BlackScholesModel(S0, R, SIG),
        brownian=jbm.BrownianMotionFinmathMersenne(jtd, 1, MERSENNE_PATHS,
                                                   MERSENNE_SEED),
        mesh=Mesh(np.asarray(jax.devices()), ("paths",)))
    return {
        "bermudan": jam.BermudanOption(EX_TIMES, 110.0, is_call=False,
                                       foresight_bias="split"
                                       ).get_value_and_error(sim),
        "cliquet": jsp.CliquetOption([0.2, 0.4, 0.6, 0.8, T], -0.05, 0.1
                                     ).get_value_and_error(sim)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    with start_world(f"{__name__}:rank_scenarios", W, backend="gloo",
                     device="cpu", threads=1,
                     directory=tmp_path_factory.mktemp("world")) as world:
        refs = scenarios(None)
        refs["jax"] = _jax_references()
        ranks = world.join(timeout=600)
    return ranks, refs


PRODUCTS = ["bermudan_split", "bermudan_insample", "forward_start",
            "cliquet", "compound", "autocallable", "chooser", "hedge_value",
            "hedge_hedge_error_mean", "hedge_hedge_error_std",
            "variance_swap", "variance_swap_strike"]


@pytest.mark.parametrize("name", PRODUCTS)
def test_products_match_unsharded(run, name):
    ranks, refs = run
    a = refs["products"][name]
    for r in ranks:
        b = r["products"][name]
        assert abs(a[0] - b[0]) < 1e-9 * max(abs(a[0]), 1.0), (name, a, b)
        assert abs(a[1] - b[1]) <= 1e-9 * max(abs(a[1]), 1e-12), (name, a, b)


@pytest.mark.parametrize("bias", ["split", "insample"])
def test_bermudan_decisions_equal_unsharded(run, bias):
    ranks, refs = run
    want = refs["cash"][bias]
    assert want.shape == (N_PATHS,)
    for r in ranks:
        np.testing.assert_array_equal(r["cash"][bias], want)


def test_call_grid_matches_unsharded(run):
    ranks, refs = run
    a = refs["call_grid"]
    assert a.shape == (len(EXPIRIES), len(STRIKES), 2)
    for r in ranks:
        np.testing.assert_allclose(r["call_grid"], a, rtol=1e-9, atol=0.0)


def test_slv_fits_of_the_first_steps(run):
    """The meshed fit on each rank's block of one cloud against the
    unsharded fit on the whole cloud. The first step's cloud is a single
    point (every path at log S0, V0): its standardized position is
    (k - m) / 1e-6 (the floored deviation), and the float32 mean of 4,096
    equal values is an ulp away from them, that of four sums of 1,024 is
    not, so the point sits on another mix of two hats and beta spreads
    differently; there m, s and the fitted E[V | k] on the cloud (v0) are
    compared. From the second step on, (beta, m, s)."""
    ranks, refs = run
    v0 = SLV_HESTON["v0"]
    for r in ranks:
        assert r["slv"]["bound"]
        for i in FIT_STEPS:
            beta, m, s, cond = r["slv"]["fits"][i]
            jb, jm, js, jcond = refs["slv"]["fits"][i]
            assert m == pytest.approx(jm, rel=1e-6), i
            assert s == pytest.approx(js, rel=1e-6), i
            if i == 0:
                np.testing.assert_allclose(cond, v0, rtol=1e-5)
                np.testing.assert_allclose(jcond, v0, rtol=1e-5)
            else:
                np.testing.assert_allclose(beta, jb, rtol=0.0,
                                           atol=1e-6 * np.abs(jb).max())


def test_slv_states_leverage_and_calls(run):
    ranks, refs = run
    want = refs["slv"]
    assert want["states"].shape == (SLV_STEPS + 1, 2, SLV_PATHS)
    scale = np.abs(want["states"]).max(axis=(0, 2))[None, :, None]
    for r in ranks:
        got = r["slv"]
        np.testing.assert_allclose(got["states"] / scale,
                                   want["states"] / scale, rtol=0.0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["leverage"], want["leverage"],
                                   rtol=1e-4)
        assert np.all(np.abs(got["calls"][..., 0] - want["calls"][..., 0])
                      <= 1e-3 * want["calls"][..., 1])


def test_meshed_jax_facade_on_the_mersenne_stream(run):
    ranks, refs = run
    jv, je = refs["jax"]["bermudan"]
    cv = refs["jax"]["cliquet"]
    for r in ranks:
        v, e = r["mersenne"]["bermudan"]
        assert abs(v - jv) < 0.25 * je, (v, jv, je)
        assert e == pytest.approx(je, rel=0.01)
        np.testing.assert_allclose(r["mersenne"]["cliquet"], cv, rtol=1e-6)
        # and the meshed port against the unsharded port on that stream
        np.testing.assert_allclose(r["mersenne"]["bermudan"],
                                   refs["mersenne"]["bermudan"], rtol=1e-9)


def test_every_rank_returns_the_same_results(run):
    ranks, _ = run
    assert all(r["local_paths"] == N_PATHS // W for r in ranks)
    for r in ranks[1:]:
        assert r["products"] == ranks[0]["products"]
        np.testing.assert_array_equal(r["call_grid"], ranks[0]["call_grid"])
        np.testing.assert_array_equal(r["slv"]["states"],
                                      ranks[0]["slv"]["states"])
        np.testing.assert_array_equal(r["slv"]["calls"],
                                      ranks[0]["slv"]["calls"])
        assert r["mersenne"] == ranks[0]["mersenne"]
        assert r["collectives"] == ranks[0]["collectives"]
