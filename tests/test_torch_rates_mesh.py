"""Path-axis sharding of the rates, credit, FX, inflation, commodity,
copula and market-risk simulations over torch.distributed: the
Hull-White simulation with its TARN and Bermudan, the wrong-way-risk CVA
engine, the cross-currency simulation and its exposure engine, the
Jarrow-Yildirim simulation, the Gaussian copula, Schwartz-Smith and the
market-risk engine, on one spawned gloo world of four CPU ranks (a
``file://`` store, one thread a rank).

Every one of them promises the unmeshed stream: each rank draws the
global block (or takes the caller's global ``normals=`` / ``latent=``),
mirrors it when antithetic, and keeps its block of the paths (the
scenarios, for the market-risk engine). The ranks import only torch,
numpy and the port (``rank_scenarios`` at module level); the unsharded
port runs the same scenarios in a second child process
(``unsharded_references``); the parent rebuilds the JAX engines' draws
before the world starts (``jax_draws``: they are the injected
``normals=``, the Schwartz-Smith histories and the copula's latent
matrix), runs the meshed JAX engines on conftest's eight virtual devices
while the world runs (``jax_references``), and asserts.

Bounds, the meshed port against the unsharded port on the same draw: the
JAX package's own mesh tests' (``tests/test_mesh_round3.py``,
``tests/test_mesh_round5.py``), each named at its test; besides, the
state histories bit for bit, the copula's ETL and k-th-default
probabilities 1e-12 relative, and the market-risk report's VaR, ES,
component ES and the quantile's error bit for bit (the tail statistics
run on the gathered P&L, which is the unsharded array), as is the
cross-currency exposure engine's PFE. An indivisible path or scenario
count raises ``ValueError`` naming "divisible" on every rank.

Bounds, the meshed port on the JAX draws against the meshed JAX engine:
the unsharded parity tests' (``tests/test_torch_hull_white.py``,
``test_torch_tarn.py``, ``test_torch_hw_bermudan.py``,
``test_torch_credit.py``, ``test_torch_cross_currency.py``,
``test_torch_inflation.py``, ``test_torch_commodity.py``,
``test_torch_portfolio_credit.py``, ``test_torch_risk_regulatory.py``),
each named at its test. Measured on this file's data: the Hull-White
histories 3-4 float32 ulps, its prices at most 4.9e-10 relative, the TARN
1.1e-11, the Bermudans 5.9e-10; the WWR CVA parts at most 1.2e-9; the
cross-currency histories 5 ulps, its prices 3.9e-10, its exposure rows
4.0e-10 of the largest EE; the CPI 1 ulp, the ZCIS 1.2e-7, the YoY
caplet 2.4e-8; the Schwartz-Smith histories 2.5 ulps and the prices on
the JAX histories 6.8e-16; the copula 4.1e-16; the risk reports
1.4e-13."""

from importlib import import_module

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.parallel.launch import start_world  # noqa: E402

W = 4
HW_PATHS, WWR_PATHS, XCCY_PATHS = 16_000, 8_000, 16_000
SS_PATHS, JY_PATHS, COPULA_PATHS, RISK_SCENARIOS = 16_000, 16_000, 40_000, \
    16_000
T_GRID = np.arange(0.0, 21.0)
PAY = np.arange(1, 11) * 0.5
RISK_COV = np.array([[0.04, 0.012], [0.012, 0.09]])
COPULA_TIMES = (1.0, 3.0, 5.0)
#: the engines' seeds, the JAX mesh tests' own
HW_SEED, WWR_SEED, XCCY_SEED, JY_SEED, SS_SEED, COPULA_SEED, RISK_SEED = \
    11, 99, 5, 3, 7, 3, 42
PORT, JAX = "finmath_tpu_torch", "finmath_tpu"


def _mod(pkg, name):
    """``models.<name>`` of the port (``PORT``) or of the JAX package
    (``JAX``, imported in the parent only)."""
    return import_module(f"{pkg}.models.{name}")


def _port_kw(pkg, **kw):
    """The port's own keywords (its device and the injected draws); the
    JAX engines take none of them."""
    return dict(device="cpu", **kw) if pkg == PORT else {}


def _error(fn):
    """The exception's type name and message, or None (the check runs
    before any collective, so a rank records it instead of failing)."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - recorded for the parent
        return f"{type(exc).__name__}: {exc}"
    return None


def _curve(rate, pkg=PORT):
    return _mod(pkg, "curves").DiscountCurve(T_GRID, np.exp(-rate * T_GRID))


def _td(steps, step, pkg=PORT):
    return _mod(pkg, "time_discretization").TimeDiscretization(
        initial=0.0, num_steps=steps, step=step)


def hull_white(mesh, paths=HW_PATHS, normals=None, pkg=PORT):
    m = _mod(pkg, "hull_white")
    hw = m.HullWhiteModel(_curve(0.03, pkg), mean_reversion=0.1,
                          volatility=0.01)
    return m.HullWhiteSimulation(hw, _td(20, 0.5, pkg), num_paths=paths,
                                 seed=HW_SEED, antithetic=normals is None,
                                 mesh=mesh, **_port_kw(pkg, normals=normals))


def hw_results(sim, pkg=PORT) -> dict:
    tarn = _mod(pkg, "tarn").TargetRedemptionNote(
        fixing_times=np.arange(1, 9) * 1.0,
        payment_times=np.arange(1, 9) * 1.0 + 0.5,
        strike=0.06, target=0.06, multiplier=2.0)
    berm = _mod(pkg, "hw_bermudan").BermudanSwaption
    return dict(
        xs=np.asarray(sim._xs), ys=np.asarray(sim._ys),
        bonds=[sim.mc_bond_price(t) for t in (2.0, 5.0)],
        caplet=sim.mc_caplet_price(2.0, 2.5, 0.03),
        swaption=sim.mc_swaption_price(2.0, [3.0, 4.0, 5.0], 0.03),
        numeraire_average=sim.numeraire(5.0).get_average(),
        tarn=tarn.get_value_and_error(sim),
        bermudan=berm([1.0, 2.0, 3.0], 6.0, 0.03).get_value_and_error(sim),
        bermudan_insample=berm(
            [1.0, 2.0, 3.0], 6.0, 0.03,
            foresight_bias="insample").get_value_and_error(sim))


def wwr(mesh, paths=WWR_PATHS, normals=None, pkg=PORT):
    credit = _mod(pkg, "credit")
    dc = _curve(0.03, pkg)
    hw = _mod(pkg, "hull_white").HullWhiteModel(dc, mean_reversion=0.1,
                                                volatility=0.01)
    intensity = credit.CIRPPIntensityModel(
        credit.SurvivalCurve([0.0], [0.015]), kappa=0.5, theta=0.02,
        sigma=0.10, y0=0.02)
    return credit.WrongWayRiskCVAEngine(
        hw, intensity, PAY, credit.par_swap_rate(dc, PAY), num_paths=paths,
        correlation=0.6, recovery=0.4, seed=WWR_SEED,
        antithetic=normals is None, substeps=2, mesh=mesh,
        **_port_kw(pkg, normals=normals))


def wwr_results(engine) -> dict:
    res = engine.compute()
    return dict(cva=res.cva, cva_independent=res.cva_independent,
                wwr_ratio=res.wwr_ratio,
                contributions=np.asarray(res.contributions),
                expected_survival=np.asarray(res.expected_survival))


def xccy(mesh, paths=XCCY_PATHS, normals=None, pkg=PORT):
    hw = _mod(pkg, "hull_white").HullWhiteModel
    m = _mod(pkg, "cross_currency")
    model = m.CrossCurrencyModel(hw(_curve(0.03, pkg), 0.1, 0.01),
                                 hw(_curve(0.01, pkg), 0.05, 0.008),
                                 fx_spot=1.25, fx_vol=0.10, rho_df=0.3,
                                 rho_dx=-0.2, rho_fx=0.25)
    return m.CrossCurrencySimulation(model, _td(16, 0.5, pkg),
                                     num_paths=paths, seed=XCCY_SEED,
                                     antithetic=normals is None, mesh=mesh,
                                     **_port_kw(pkg, normals=normals))


def xccy_results(sim, pkg=PORT) -> dict:
    m = _mod(pkg, "cross_currency")
    fwd, prices, stderr = sim.mc_fx_option_prices(5.0, [1.0, 1.25, 1.5])
    prof = m.CrossCurrencyExposureEngine(
        sim, [m.CCSTrade(tuple(np.arange(1, 7) * 1.0)),
              m.FXForwardTrade(4.0, 1.3, notional=-0.5)],
        quantiles=(0.95, 0.99)).profile()
    return dict(hist=np.asarray(sim._hist), fx_forward=fwd,
                fx_prices=np.asarray(prices), fx_stderr=np.asarray(stderr),
                ccs=sim.mc_ccs_legs(np.arange(1, 9) * 1.0),
                diagnostics=sim.martingale_diagnostics(5.0, 8.0),
                fx_average=sim.fx(3.0).get_average(),
                exposure=dict(ee=prof.ee, ene=prof.ene,
                              forward_value=prof.forward_value,
                              ee_standalone=prof.ee_standalone,
                              pfe=prof.pfe))


def jarrow_yildirim(mesh, normals=None, pkg=PORT):
    hw = _mod(pkg, "hull_white").HullWhiteModel
    m = _mod(pkg, "inflation")
    jy = m.JarrowYildirimModel(hw(_curve(0.03, pkg), 0.1, 0.01),
                               hw(_curve(0.01, pkg), 0.05, 0.006),
                               cpi_initial=100.0, cpi_vol=0.012, rho_nr=0.3,
                               rho_ni=-0.1, rho_ri=0.2)
    return jy, m.JarrowYildirimSimulation(jy, _td(10, 0.5, pkg),
                                          num_paths=JY_PATHS, seed=JY_SEED,
                                          antithetic=normals is None,
                                          mesh=mesh,
                                          **_port_kw(pkg, normals=normals))


def jy_results(jy, sim) -> dict:
    return dict(zcis=sim.mc_zcis_value(5.0, jy.zcis_par_rate(5.0)),
                zcis_02=sim.mc_zcis_value(5.0, 0.02),
                yoy=sim.mc_yoy_forward(3.0, 4.0),
                yoy_23=sim.mc_yoy_forward(2.0, 3.0),
                yoy_analytic_23=jy.yoy_forward(2.0, 3.0),
                caplet=sim.mc_yoy_caplet(3.0, 4.0, 0.02),
                cpi=np.asarray(sim.cpi(5.0).get_realizations()))


def commodity(mesh, paths=SS_PATHS, normals=None, histories=None,
              pkg=PORT):
    """The Schwartz-Smith simulation; ``histories`` (the port only): the
    global ``(chi, xi)`` histories put in place of its own, each rank
    keeping its block, as ``tests/test_torch_commodity.py`` prices the
    JAX histories."""
    m = _mod(pkg, "commodity")
    model = m.SchwartzSmithModel(chi0=0.1, xi0=3.0, kappa=1.5,
                                 sigma_chi=0.25, sigma_xi=0.15, rho=0.3,
                                 mu_star=0.02, lambda_chi=0.05)
    sim = m.SchwartzSmithSimulation(model, _td(12, 0.25, pkg),
                                    num_paths=paths, seed=SS_SEED,
                                    antithetic=True, mesh=mesh,
                                    **_port_kw(pkg, normals=normals))
    if histories is not None:
        from finmath_tpu_torch.parallel.mesh import path_block

        sim._chis, sim._xis = (path_block(torch.as_tensor(h), mesh)
                               for h in histories)
    return sim


def ss_results(sim) -> dict:
    return dict(chis=np.asarray(sim._chis), xis=np.asarray(sim._xis),
                futures=sim.mc_futures_prices(2.0, [2.5, 3.0]),
                options=sim.mc_option_on_future(1.0, 2.0, [20.0, 25.0]),
                spread=sim.mc_calendar_spread(1.0, 2.0, 3.0),
                spot_average=sim.spot(2.0).get_average())


def copula_portfolio(pkg=PORT):
    rng = np.random.default_rng(1)
    hazards = rng.uniform(0.005, 0.06, 50)
    betas = rng.uniform(0.3, 0.7, 50)
    curve = _mod(pkg, "credit").SurvivalCurve
    return _mod(pkg, "portfolio_credit").GaussianCopulaPortfolio(
        [curve([0.0], [h]) for h in hazards], betas=betas,
        recoveries=0.4, notionals=np.full(50, 1 / 50))


def copula(mesh, paths=COPULA_PATHS, pkg=PORT, **kw):
    return _mod(pkg, "portfolio_credit").GaussianCopulaSimulation(
        copula_portfolio(pkg), num_paths=paths, seed=COPULA_SEED,
        antithetic=True, mesh=mesh, **_port_kw(pkg, **kw))


def copula_results(sim) -> dict:
    st = sim.tranche_statistics(COPULA_TIMES, 0.03, 0.07, ks=(1, 5))
    five = sim.tranche_statistics([5.0], 0.03, 0.07)
    return dict(etl=np.asarray(st["etl"]),
                etl_stderr=np.asarray(st["etl_stderr"]),
                kth_prob=np.asarray(st["kth_prob"]),
                etl_5=float(five["etl"][0]),
                etl_5_stderr=float(five["etl_stderr"][0]))


def risk_engine(mesh, pkg=PORT):
    m = _mod(pkg, "risk")
    book = m.OptionBook(
        spots=[100.0, 50.0], rate=0.02, underlying_index=[0, 0, 1, 1],
        strikes=[100.0, 110.0, 50.0, 45.0], expiries=[0.5, 1.0, 0.25, 0.75],
        vols=[0.2, 0.22, 0.3, 0.28], notionals=[1.0, -0.5, 2.0, 1.0],
        is_call=[True, True, False, True])
    return m.MarketRiskEngine(book, mesh=mesh, **_port_kw(pkg))


REPORT_FIELDS = ("var", "es", "quantile", "horizon", "mean_pnl",
                 "stderr_var")


def _report(rep) -> dict:
    return dict(var=rep.var, es=rep.expected_shortfall,
                quantile=rep.quantile, horizon=rep.horizon,
                component_es=np.asarray(rep.component_es),
                mean_pnl=rep.mean_pnl, stderr_var=rep.stderr_var)


def risk_results(engine, normals, pkg=PORT) -> dict:
    """The reports on the JAX engine's draws (``normals``: its ``(z,
    zv)``; the JAX engine draws them itself from ``RISK_SEED``), on a
    history, and (the port only) on the port's own stream."""
    z, zv = normals
    draw = ((lambda _: dict(seed=RISK_SEED)) if pkg == JAX
            else (lambda zs: dict(normals=zs)))
    hist = np.random.default_rng(10).standard_normal((RISK_SCENARIOS, 2))
    out = dict(
        jax_draws=_report(engine.parametric_mc(
            RISK_COV, num_scenarios=RISK_SCENARIOS, **draw((z, None)))),
        with_vols=_report(engine.parametric_mc(
            RISK_COV, num_scenarios=RISK_SCENARIOS,
            vol_covariance=0.5 * RISK_COV, **draw((z, zv)))),
        historical=_report(engine.historical(
            0.01 * hist, vol_returns=0.02 * hist[::-1].copy(),
            quantile=0.975)))
    if pkg == PORT:
        out["parametric"] = _report(engine.parametric_mc(
            RISK_COV, num_scenarios=RISK_SCENARIOS, seed=RISK_SEED))
    return out


def scenarios(mesh, draws) -> dict:
    """Every scenario's numbers, with ``mesh`` or without (``mesh=None``,
    the unsharded port on the same draws). ``draws``: the JAX engines'
    own draws (``jax_draws``), injected as global arrays."""
    out = dict(
        hw=hw_results(hull_white(mesh)),
        hw_injected=hw_results(hull_white(mesh, normals=draws["hw"])),
        wwr=wwr_results(wwr(mesh)),
        wwr_injected=wwr_results(wwr(mesh, normals=draws["wwr"])),
        xccy=xccy_results(xccy(mesh)),
        xccy_injected=xccy_results(xccy(mesh, normals=draws["xccy"])),
        jy=jy_results(*jarrow_yildirim(mesh)),
        jy_injected=jy_results(*jarrow_yildirim(mesh, normals=draws["jy"])),
        ss=ss_results(commodity(mesh)),
        ss_injected=ss_results(commodity(mesh, normals=draws["ss"])),
        ss_jax_histories=ss_results(commodity(
            mesh, histories=draws["ss_histories"])),
        copula=copula_results(copula(mesh)),
        copula_latent=copula_results(copula(mesh, latent=draws["copula"])),
        risk=risk_results(risk_engine(mesh), draws["risk"]))
    out["wwr_histories"] = [h.numpy() for h in wwr(mesh).simulate()]
    return out


def rank_scenarios(mesh, draws):
    """Every scenario of this file on one rank of the world, and the
    rejections of indivisible path and scenario counts."""
    out = scenarios(mesh, draws)
    out["rank"] = mesh.rank
    out["indivisible"] = {
        "hull_white": _error(lambda: hull_white(mesh, paths=16_002)),
        "wwr": _error(lambda: wwr(mesh, paths=8_002)),
        "commodity": _error(lambda: commodity(mesh, paths=16_002)),
        "xccy": _error(lambda: xccy(mesh, paths=16_002)),
        "copula": _error(lambda: copula(mesh, paths=40_002)),
        "risk": _error(lambda: risk_engine(mesh).parametric_mc(
            RISK_COV, num_scenarios=16_001, antithetic=False)),
    }
    out["collectives"] = mesh.calls
    return out


def unsharded_references(mesh, draws):
    """The unsharded port on the same draws, in a process of its own
    beside the world (a world of one; its mesh is not used)."""
    return scenarios(None, draws)


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), ("paths",))


def jax_draws(jmesh):
    """The JAX engines' draws, rebuilt from their key paths (as the
    unsharded parity tests rebuild them), and the two meshed JAX
    simulations whose state the port takes as it is: Schwartz-Smith's
    histories and the copula's latent matrix. Returns (draws for the
    ranks, the two JAX simulations)."""
    import jax

    from test_torch_commodity import ss_stream
    from test_torch_credit import wwr_stream
    from test_torch_cross_currency import xccy_stream
    from test_torch_hull_white import jax_normals

    ss = commodity(jmesh, pkg=JAX)
    cop = copula(jmesh, pkg=JAX)
    k1, k2 = jax.random.split(jax.random.PRNGKey(RISK_SEED))
    half = RISK_SCENARIOS // 2
    draws = dict(
        hw=jax_normals(HW_SEED, 20, HW_PATHS),
        wwr=wwr_stream(WWR_SEED, PAY.size, 2, WWR_PATHS),
        xccy=xccy_stream(XCCY_SEED, 16, XCCY_PATHS),
        jy=xccy_stream(JY_SEED, 10, JY_PATHS),
        ss=ss_stream(SS_SEED, 12, SS_PATHS),
        ss_histories=(np.array(ss._chis), np.array(ss._xis)),
        copula=np.array(cop._lat),
        risk=(np.asarray(jax.random.normal(k1, (half, 2))),
              np.asarray(jax.random.normal(k2, (half, 2)))))
    return draws, dict(ss=ss, copula=cop)


def jax_references(jmesh, jax_sims) -> dict:
    """The meshed JAX engines on conftest's eight virtual devices: the
    JAX mesh tests' configurations, on their own streams."""
    jy, jy_sim = jarrow_yildirim(jmesh, pkg=JAX)
    return dict(
        hw=hw_results(hull_white(jmesh, pkg=JAX), JAX),
        wwr=wwr_results(wwr(jmesh, pkg=JAX)),
        xccy=xccy_results(xccy(jmesh, pkg=JAX), JAX),
        jy=jy_results(jy, jy_sim),
        ss=ss_results(jax_sims["ss"]),
        copula=copula_results(jax_sims["copula"]),
        risk=risk_results(risk_engine(jmesh, JAX), (None, None), JAX))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(per-rank results, unsharded port, meshed JAX): the JAX draws are
    rebuilt first, then the world and the unsharded port run in child
    processes while the parent computes the meshed JAX references."""
    jmesh = _jax_mesh()
    draws, jax_sims = jax_draws(jmesh)
    kw = dict(backend="gloo", device="cpu", kwargs=dict(draws=draws),
              directory=tmp_path_factory.mktemp("world"))
    with start_world(f"{__name__}:rank_scenarios", W, threads=1, **kw) \
            as world, start_world(f"{__name__}:unsharded_references", 1,
                                  threads=2, **kw) as unsharded:
        jref = jax_references(jmesh, jax_sims)
        ranks = world.join(timeout=600)
        ref = unsharded.join(timeout=600)[0]
    return ranks, ref, jref


def _blocks(ranks, *keys):
    """Every rank's block of a per-path array, concatenated in rank
    order."""
    def get(r):
        for k in keys:
            r = r[k]
        return r
    return np.concatenate([get(r) for r in ranks], axis=-1)


# ---------------------------------------------------------------------------
# Hull-White, the TARN and the Bermudan (tests/test_mesh_round5.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["hw", "hw_injected"])
def test_hull_white_histories_are_the_unsharded_ones(run, case):
    """The same stream (or the same injected normals) split over the
    ranks: each rank's block of the state histories is the unsharded
    block bit for bit (the JAX bound is 2e-7)."""
    ranks, ref, _ = run
    for name in ("xs", "ys"):
        np.testing.assert_array_equal(_blocks(ranks, case, name),
                                      ref[case][name])


@pytest.mark.parametrize("case", ["hw", "hw_injected"])
def test_hull_white_prices_match_unsharded(run, case):
    ranks, ref, _ = run
    want = ref[case]
    for r in ranks:
        got = r[case]
        for a, b in zip(got["bonds"], want["bonds"]):
            assert abs(a - b) < 1e-9 + 1e-6 * abs(b)
        for key in ("caplet", "swaption", "numeraire_average"):
            assert got[key] == pytest.approx(want[key], rel=1e-12)


@pytest.mark.parametrize("case", ["hw", "hw_injected"])
def test_tarn_on_the_meshed_simulation(run, case):
    ranks, ref, _ = run
    va, ea = ref[case]["tarn"]
    for r in ranks:
        vb, eb = r[case]["tarn"]
        assert abs(vb - va) < 1e-6 + 1e-5 * abs(va)
        assert abs(eb - ea) < 1e-6


@pytest.mark.parametrize("case", ["hw", "hw_injected"])
@pytest.mark.parametrize("which", ["bermudan", "bermudan_insample"])
def test_bermudan_ls_on_the_meshed_simulation(run, case, which):
    """The exercise regression's moments and Gram reduce over the ranks,
    and the split estimator keeps the global paths' parity."""
    ranks, ref, _ = run
    va, _ = ref[case][which]
    for r in ranks:
        vb, _ = r[case][which]
        assert abs(vb - va) < 1e-6 + 1e-4 * abs(va)


# ---------------------------------------------------------------------------
# wrong-way-risk CVA, cross-currency, the copula (tests/test_mesh_round3.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["wwr", "wwr_injected"])
def test_wwr_matches_unsharded(run, case):
    ranks, ref, _ = run
    plain = ref[case]
    for r in ranks:
        shard = r[case]
        assert abs(shard["cva"] - plain["cva"]) < 1e-5 * plain["cva"]
        assert abs(shard["cva_independent"] - plain["cva_independent"]) \
            < 1e-5 * plain["cva_independent"]
        np.testing.assert_allclose(shard["contributions"],
                                   plain["contributions"], rtol=1e-4,
                                   atol=1e-10)
        np.testing.assert_allclose(shard["expected_survival"],
                                   plain["expected_survival"], rtol=1e-6)


def test_wwr_invariants_on_the_mesh(run):
    ranks, _, _ = run
    res = ranks[0]["wwr"]
    assert res["cva"] > 0 and res["wwr_ratio"] > 1.0
    assert np.all(res["contributions"] > -1e-12)
    assert np.isclose(np.sum(res["contributions"]), res["cva"])
    assert abs(res["contributions"][-1]) < 1e-15


def test_wwr_simulate_gathers_the_unsharded_histories(run):
    ranks, ref, _ = run
    for r in ranks:
        for got, want in zip(r["wwr_histories"], ref["wwr_histories"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["xccy", "xccy_injected"])
def test_xccy_matches_unsharded(run, case):
    ranks, ref, _ = run
    a = ref[case]
    for r in ranks:
        b = r[case]
        assert abs(b["fx_forward"] - a["fx_forward"]) < 1e-5 * a["fx_forward"]
        np.testing.assert_allclose(b["fx_prices"], a["fx_prices"], rtol=1e-4)
        np.testing.assert_allclose(b["fx_stderr"], a["fx_stderr"],
                                   rtol=1e-9)
        assert abs(b["ccs"][0] - a["ccs"][0]) < 1e-5
        assert abs(b["ccs"][1] - a["ccs"][1]) < 1e-5
        assert b["fx_average"] == pytest.approx(a["fx_average"], rel=1e-12)
        for key, (mc, _) in a["diagnostics"].items():
            assert b["diagnostics"][key][0] == pytest.approx(mc, rel=1e-12)


@pytest.mark.parametrize("case", ["xccy", "xccy_injected"])
def test_xccy_exposure_matches_unsharded(run, case):
    """The cross-currency exposure engine on a meshed simulation: the
    means all-reduced (1e-12), the PFE of the gathered values bit for
    bit."""
    ranks, ref, _ = run
    want = ref[case]["exposure"]
    for r in ranks:
        got = r[case]["exposure"]
        for row in ("ee", "ene", "forward_value", "ee_standalone"):
            np.testing.assert_allclose(got[row], want[row], rtol=0,
                                       atol=1e-12)
        for q in want["pfe"]:
            np.testing.assert_array_equal(got["pfe"][q], want["pfe"][q])


@pytest.mark.parametrize("case", ["xccy", "xccy_injected"])
def test_xccy_histories_are_the_unsharded_ones(run, case):
    """Each rank's block of the ``[steps, 5, paths]`` state history is the
    unsharded block bit for bit."""
    ranks, ref, _ = run
    np.testing.assert_array_equal(_blocks(ranks, case, "hist"),
                                  ref[case]["hist"])


def test_xccy_martingales_on_the_mesh(run):
    ranks, _, _ = run
    for key, (mc, an) in ranks[0]["xccy"]["diagnostics"].items():
        assert abs(mc / an - 1.0) < 5e-3, (key, mc, an)


@pytest.mark.parametrize("case", ["copula", "copula_latent"])
def test_copula_is_the_same_draw(run, case):
    """The latent matrix is the unsharded one split over the ranks: the
    statistics agree to the order of the float64 sums."""
    ranks, ref, _ = run
    a = ref[case]
    for r in ranks:
        b = r[case]
        np.testing.assert_allclose(b["etl"], a["etl"], rtol=1e-12)
        np.testing.assert_allclose(b["kth_prob"], a["kth_prob"], rtol=1e-12)
        np.testing.assert_allclose(b["etl_stderr"], a["etl_stderr"],
                                   rtol=1e-9)


def test_copula_matches_the_exact_recursion(run):
    ranks, _, _ = run
    exact = copula_portfolio().expected_tranche_loss(5.0, 0.03, 0.07)
    r = ranks[0]["copula"]
    assert abs(r["etl_5"] - exact) < 4 * r["etl_5_stderr"] + 1e-6


# ---------------------------------------------------------------------------
# Schwartz-Smith, Jarrow-Yildirim, market risk (tests/test_mesh_round5.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ss", "ss_injected", "ss_jax_histories"])
def test_commodity_matches_unsharded(run, case):
    ranks, ref, _ = run
    fa, sa = ref[case]["futures"]
    oa, _ = ref[case]["options"]
    for r in ranks:
        fb, sb = r[case]["futures"]
        ob, _ = r[case]["options"]
        np.testing.assert_allclose(fb, fa, rtol=1e-5)
        np.testing.assert_allclose(ob, oa, rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(sb, sa, rtol=1e-9)
        np.testing.assert_allclose(r[case]["spread"], ref[case]["spread"],
                                   rtol=1e-9)
        assert r[case]["spot_average"] == pytest.approx(
            ref[case]["spot_average"], rel=1e-12)


@pytest.mark.parametrize("case", ["ss", "ss_injected", "ss_jax_histories"])
@pytest.mark.parametrize("name", ["chis", "xis"])
def test_commodity_histories_are_the_unsharded_ones(run, case, name):
    """Each rank's block of the factor histories is the unsharded block
    bit for bit (drawn, injected, or put in place)."""
    ranks, ref, _ = run
    np.testing.assert_array_equal(_blocks(ranks, case, name), ref[case][name])


@pytest.mark.parametrize("case", ["jy", "jy_injected"])
def test_inflation_cpi_is_the_unsharded_cpi(run, case):
    """The meshed CPI's realizations gather to the unsharded ones bit for
    bit on every rank."""
    ranks, ref, _ = run
    for r in ranks:
        np.testing.assert_array_equal(r[case]["cpi"], ref[case]["cpi"])


@pytest.mark.parametrize("case", ["jy", "jy_injected"])
def test_inflation_matches_unsharded(run, case):
    ranks, ref, _ = run
    a = ref[case]
    for r in ranks:
        b = r[case]
        assert abs(b["zcis"] - a["zcis"]) < 1e-8
        assert abs(b["yoy"][0] - a["yoy"][0]) < 1e-6
        np.testing.assert_allclose(b["caplet"], a["caplet"], rtol=1e-9)


def test_inflation_tracks_the_analytic_yoy_forward(run):
    ranks, _, _ = run
    f_mc, se = ranks[0]["jy"]["yoy_23"]
    f_an = ranks[0]["jy"]["yoy_analytic_23"]
    assert abs(f_mc - f_an) < 4 * se + 1e-6


@pytest.mark.parametrize("case", ["parametric", "jax_draws", "with_vols",
                                  "historical"])
def test_risk_report_matches_unsharded(run, case):
    """The JAX bounds (VaR and ES 1e-9 + 1e-6 relative, component ES
    rtol 1e-5) and, since the tail statistics sort the gathered P&L,
    VaR, ES, the component ES and the quantile's error bit for bit."""
    ranks, ref, _ = run
    a = ref["risk"][case]
    for r in ranks:
        b = r["risk"][case]
        assert abs(b["var"] - a["var"]) < 1e-9 + 1e-6 * abs(a["var"])
        assert abs(b["es"] - a["es"]) < 1e-9 + 1e-6 * abs(a["es"])
        np.testing.assert_allclose(b["component_es"], a["component_es"],
                                   rtol=1e-5, atol=1e-10)
        for key in ("var", "es", "stderr_var", "mean_pnl"):
            assert b[key] == a[key], key
        np.testing.assert_array_equal(b["component_es"], a["component_es"])


# ---------------------------------------------------------------------------
# the SPMD contract
# ---------------------------------------------------------------------------

def test_indivisible_counts_rejected(run):
    ranks, _, _ = run
    for r in ranks:
        for name, err in r["indivisible"].items():
            assert err is not None and err.startswith("ValueError"), \
                (name, err)
            assert "divisible" in err, (name, err)


def test_every_rank_returns_the_same_results(run):
    ranks, _, _ = run
    scalars = [("hw", "tarn"), ("hw", "bermudan"), ("wwr", "cva"),
               ("xccy", "ccs"), ("jy", "yoy"), ("ss", "spread"),
               ("risk", "parametric", "var")]
    for r in ranks[1:]:
        for path in scalars:
            a, b = r, ranks[0]
            for k in path:
                a, b = a[k], b[k]
            assert a == b, path
        np.testing.assert_array_equal(r["copula"]["etl"],
                                      ranks[0]["copula"]["etl"])
        np.testing.assert_array_equal(r["xccy"]["exposure"]["ee"],
                                      ranks[0]["xccy"]["exposure"]["ee"])
        assert r["collectives"] == ranks[0]["collectives"]


# ---------------------------------------------------------------------------
# the meshed port against the meshed JAX engines (conftest's eight virtual
# devices), at the unsharded parity tests' cross-package bounds
# ---------------------------------------------------------------------------

def _f64(x):
    return np.asarray(x, dtype=np.float64)


def _rel(got, want):
    got, want = _f64(got), _f64(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize("name", ["xs", "ys"])
def test_hull_white_histories_match_jax_meshed(run, name):
    """The ranks' blocks on the JAX draws within 32 float32 ulps of each
    step's largest value (``tests/test_torch_hull_white.py``)."""
    from test_torch_hull_white import within_ulps

    ranks, _, jref = run
    assert within_ulps(jref["hw"][name], _blocks(ranks, "hw_injected", name))


def test_hull_white_prices_match_jax_meshed(run):
    """Bonds, caplet, swaption and the numeraire's mean within 1e-6
    (``tests/test_torch_hull_white.py``)."""
    ranks, _, jref = run
    want = jref["hw"]
    for r in ranks:
        got = r["hw_injected"]
        for key in ("bonds", "caplet", "swaption", "numeraire_average"):
            np.testing.assert_allclose(_f64(got[key]), _f64(want[key]),
                                       rtol=1e-6, err_msg=key)


def test_tarn_matches_jax_meshed(run):
    """Value 1e-9, error 1e-6 (``tests/test_torch_tarn.py``)."""
    ranks, _, jref = run
    want = _f64(jref["hw"]["tarn"])
    for r in ranks:
        got = _f64(r["hw_injected"]["tarn"])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


@pytest.mark.parametrize("which", ["bermudan", "bermudan_insample"])
def test_bermudan_matches_jax_meshed(run, which):
    """Value and error 5e-5 (``tests/test_torch_hw_bermudan.py``)."""
    ranks, _, jref = run
    for r in ranks:
        np.testing.assert_allclose(_f64(r["hw_injected"][which]),
                                   _f64(jref["hw"][which]), rtol=5e-5)


def test_wwr_matches_jax_meshed(run):
    """``tests/test_torch_credit.py``'s CVA decomposition bounds: CVA, its
    independent part, the survival and the ratio 1e-6, the contributions
    within 1e-6 of the CVA."""
    ranks, _, jref = run
    a = jref["wwr"]
    for r in ranks:
        b = r["wwr_injected"]
        for key in ("cva", "cva_independent", "expected_survival",
                    "wwr_ratio"):
            np.testing.assert_allclose(_f64(b[key]), _f64(a[key]),
                                       rtol=1e-6, err_msg=key)
        np.testing.assert_allclose(b["contributions"], a["contributions"],
                                   rtol=0, atol=1e-6 * abs(float(a["cva"])))


@pytest.mark.parametrize("component", range(5))
def test_xccy_histories_match_jax_meshed(run, component):
    """Each state component within 32 float32 ulps of each step's largest
    value (``tests/test_torch_cross_currency.py``)."""
    from test_torch_hull_white import within_ulps

    ranks, _, jref = run
    got = _blocks(ranks, "xccy_injected", "hist")
    assert within_ulps(jref["xccy"]["hist"][:, component],
                       got[:, component])


def test_xccy_prices_match_jax_meshed(run):
    """The FX options with their errors, the CCS legs, the martingale
    diagnostics and the FX mean within 1e-6, the diagnostics' analytic
    sides within 1e-12 (``tests/test_torch_cross_currency.py``)."""
    ranks, _, jref = run
    a = jref["xccy"]
    for r in ranks:
        b = r["xccy_injected"]
        for key in ("fx_forward", "fx_prices", "fx_stderr", "ccs",
                    "fx_average"):
            np.testing.assert_allclose(_f64(b[key]), _f64(a[key]),
                                       rtol=1e-6, err_msg=key)
        assert b["diagnostics"].keys() == a["diagnostics"].keys()
        for key, (mc, an) in a["diagnostics"].items():
            np.testing.assert_allclose(b["diagnostics"][key][0], mc,
                                       rtol=1e-6)
            np.testing.assert_allclose(b["diagnostics"][key][1], an,
                                       rtol=1e-12)


def test_xccy_exposure_matches_jax_meshed(run):
    """EE, ENE and forward value within 1e-6 of the largest EE, the
    standalone EE 1e-6, the PFE 1e-5 (``tests/test_torch_cross_currency.py``)."""
    ranks, _, jref = run
    a = jref["xccy"]["exposure"]
    scale = np.max(np.abs(_f64(a["ee"])))
    for r in ranks:
        b = r["xccy_injected"]["exposure"]
        for row in ("ee", "ene", "forward_value"):
            np.testing.assert_allclose(_f64(b[row]), _f64(a[row]), rtol=0,
                                       atol=1e-6 * scale, err_msg=row)
        np.testing.assert_allclose(_f64(b["ee_standalone"]),
                                   _f64(a["ee_standalone"]), rtol=1e-6)
        assert b["pfe"].keys() == a["pfe"].keys()
        for q in a["pfe"]:
            np.testing.assert_allclose(_f64(b["pfe"][q]), _f64(a["pfe"][q]),
                                       rtol=1e-5)


def test_inflation_matches_jax_meshed(run):
    """The CPI within 32 float32 ulps, the ZCIS, the YoY forward and the
    YoY caplet within 1e-6 (``tests/test_torch_inflation.py``)."""
    from test_torch_hull_white import within_ulps

    ranks, _, jref = run
    a = jref["jy"]
    for r in ranks:
        b = r["jy_injected"]
        assert within_ulps(a["cpi"][None], b["cpi"][None])
        for key in ("zcis_02", "yoy", "yoy_23", "caplet"):
            np.testing.assert_allclose(_f64(b[key]), _f64(a[key]),
                                       rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", ["chis", "xis"])
def test_commodity_histories_match_jax_meshed(run, name):
    """Within 4 float32 ulps of each step's largest value
    (``tests/test_torch_commodity.py``)."""
    ranks, _, jref = run
    want = _f64(jref["ss"][name])
    ulp = np.spacing(np.max(np.abs(want), axis=1).astype(np.float32))
    got = _blocks(ranks, "ss_injected", name)
    assert np.all(np.abs(_f64(got) - want)
                  <= 4 * ulp.astype(np.float64)[:, None])


def test_commodity_prices_on_the_jax_histories(run):
    """The pricers on the JAX histories, each rank holding its block:
    1e-12 relative (``tests/test_torch_commodity.py``), the spot's mean
    within one float32 ulp."""
    ranks, _, jref = run
    a = jref["ss"]
    for r in ranks:
        b = r["ss_jax_histories"]
        for key in ("futures", "options", "spread"):
            for g, w in zip(b[key], a[key]):
                assert _rel(g, w) <= 1e-12, key
        assert abs(b["spot_average"] - float(a["spot_average"])) <= \
            np.spacing(np.float32(abs(float(a["spot_average"]))))


def test_copula_matches_jax_meshed(run):
    """The statistics on the JAX latent matrix, each rank holding its
    block: 1e-13 relative (``tests/test_torch_portfolio_credit.py``)."""
    ranks, _, jref = run
    a = jref["copula"]
    for r in ranks:
        b = r["copula_latent"]
        for key in ("etl", "etl_stderr", "kth_prob", "etl_5",
                    "etl_5_stderr"):
            assert _rel(b[key], a[key]) <= 1e-13, key


@pytest.mark.parametrize("case", ["jax_draws", "with_vols", "historical"])
def test_risk_report_matches_jax_meshed(run, case):
    """Every field within 1e-12 relative, the mean P&L on the expected
    shortfall's scale, the component ES on its largest
    (``tests/test_torch_risk_regulatory.py``)."""
    ranks, _, jref = run
    a = jref["risk"][case]
    for r in ranks:
        b = r["risk"][case]
        for f in REPORT_FIELDS:
            scale = a["es"] if f == "mean_pnl" else a[f]
            assert abs(float(b[f]) - float(a[f])) <= 1e-12 * abs(
                float(scale)), f
        assert np.all(np.abs(b["component_es"] - _f64(a["component_es"]))
                      <= 1e-12 * np.max(np.abs(_f64(a["component_es"]))))
