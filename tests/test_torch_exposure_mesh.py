"""Path-axis sharding of the exposure engines and the hybrid over
torch.distributed: ``NettingSetExposureEngine`` / ``SwapExposureEngine``
(profile, CVA delta ladder, IM; swaption and Bermudan close-outs; the
CSA) and ``HybridAssetLMM`` with its exposure engine and autocallable, on
one spawned gloo world of four CPU ranks (a ``file://`` store, one thread
a rank).

The ranks import only torch, numpy and the port: every scenario runs in
``rank_scenarios`` at module level (no JAX import) and returns its
results; the unsharded port runs in a second child process beside the
world (``unsharded_references``) and the meshed JAX engines on conftest's
eight virtual devices in the parent, which asserts.

Bounds, the meshed port against the unsharded port on the same
``sobol_brownian_increments`` block (``tests/test_parallel.py``'s
``TestMeshedExposure`` and ``tests/test_xva_extensions.py``'s CSA case):
EE, ENE and forward value 1e-12; the PFE bit for bit (every rank sorts
the gathered ensemble, which is the unsharded array); CVA 1e-10
relative; the delta ladder rtol 1e-6 / atol 1e-10; the swaption and
Bermudan netting set 1e-8, its PFE 1e-7 (the Bermudan Gram's condition
number is about 1.5e11, so the order of the float64 sums moves the
fit); IM 1e-9. The meshed port against the meshed JAX engine on that
block: ``tests/test_torch_exposure.py``'s and ``tests/test_torch_xva.py``'s
cross-package bounds (rows within 32 float32 ulps of the date's largest
|V/N|, the PFE within 32 ulps of the date's largest |V|, the option set
1e-6 of its largest row value, the ladder 1e-4 of its largest bucket,
the IM 1e-6 of its largest value).

The hybrid (``tests/test_hybrid.py``'s ``TestHybridMesh``) runs on the
ranks' own streams (``rank_seed``): its martingale, option, profile and
autocallable checks at the JAX bounds, and against the unsharded hybrid
fed the ranks' concatenated draws as ``increments`` and
``equity_normals``: the same paths, so values within 1e-12 relative, the
profile rows within the regressions' 1e-9 and its PFE within 1e-10
relative (the option trade's regressed close-out moves the netted values
in their last bits)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.parallel.launch import start_world  # noqa: E402

W = 4
PATHS, CSA_PATHS = 4_096, 2_048
SWAP = dict(first_index=2, last_index=8, strike=0.005)
HAZARD = 0.01
TRADES_FWD_SPEC = (10, 20, 0.00715)       # tests/test_xva_extensions.py
OBS_FWD = tuple(range(1, 10))
HYB_OPTION_PATHS, HYB_PATHS = 64_000, 32_000


def _error(fn):
    """The exception's type name and message, or None: a rank records what
    raised (before any collective) instead of failing."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - recorded for the parent
        return f"{type(exc).__name__}: {exc}"
    return None


def sobol_block(model, paths, seed):
    from finmath_tpu_torch.models.qmc import sobol_brownian_increments

    sim = np.asarray(model.sim_times)
    return sobol_brownian_increments(sim[1:] - sim[:-1], 1, paths, seed=seed)


def _profile_dict(p):
    out = dict(ee=p.ee, ene=p.ene, forward_value=p.forward_value,
               ee_standalone=p.ee_standalone,
               pfe={q: v for q, v in p.pfe.items()})
    if p.ee_gross is not None:
        out.update(ee_gross=p.ee_gross, ene_gross=p.ene_gross)
    return out


def _csa_terms():
    from finmath_tpu_torch.models.lmm.exposure import CSA

    return {"lag1": CSA(margin_lag=1),
            "mta": CSA(threshold=0.001, threshold_own=0.002, mta=0.0005,
                       independent_amount=0.0002, margin_lag=1)}


def exposure_results(mesh, setup):
    """The swap profile, CVA ladder and IM, the option netting set, the
    CSA profiles and the own-stream profile, with ``mesh`` or without."""
    from finmath_tpu_torch.models.lmm.exposure import (
        BermudanSwaptionTrade, NettingSetExposureEngine, SwapExposureEngine,
        SwaptionTrade, SwapTrade)

    model = setup.model
    p0 = np.asarray(setup.covariance.initial_parameters)
    out = {}
    swap = SwapExposureEngine(model, num_paths=PATHS, num_factors=1,
                              increments=sobol_block(model, PATHS, 11),
                              mesh=mesh, device="cpu", **SWAP)
    out["swap"] = _profile_dict(swap.profile(p0))
    out["cva"], out["cva_deltas"] = swap.cva_forward_deltas(
        p0, hazard_rate=HAZARD)
    im = swap.im_profile(p0)
    out["im"] = dict(expected_im=im.expected_im,
                     expected_im_tmoney=im.expected_im_tmoney)
    trades = [SwaptionTrade(4, 4, 0.01),
              BermudanSwaptionTrade((4, 6), 10, 0.01)]
    out["options"] = _profile_dict(NettingSetExposureEngine(
        model, trades, num_paths=PATHS, num_factors=1, mesh=mesh,
        increments=sobol_block(model, PATHS, 23), device="cpu").profile(p0))
    inc13 = sobol_block(model, CSA_PATHS, 13)
    out["csa"] = {
        name: _profile_dict(NettingSetExposureEngine(
            model, [SwapTrade(*TRADES_FWD_SPEC)], num_paths=CSA_PATHS,
            increments=inc13, csa=csa, observation_indices=OBS_FWD,
            mesh=mesh, device="cpu").profile(p0))
        for name, csa in _csa_terms().items()}
    own = SwapExposureEngine(model, num_paths=PATHS, num_factors=1, seed=5,
                             mesh=mesh, device="cpu", **SWAP)
    out["own"] = [_profile_dict(own.profile(p0)) for _ in range(2)]
    out["analytic_forward"] = own.analytic_forward_values()
    return out


def _hybrids(mesh, **kw):
    """The three hybrids of ``TestHybridMesh``: the option and martingale
    one, the exposure one and the autocallable one."""
    from finmath_tpu_torch.models.lmm.hybrid import HybridAssetLMM

    from test_torch_hybrid import PORT, build_model

    def make(sigma, rho, paths, seed, **extra):
        return HybridAssetLMM(build_model(PORT), [100.0], [sigma],
                              rate_correlations=[rho], num_paths=paths,
                              num_factors=1, seed=seed, mesh=mesh,
                              device="cpu", **extra, **kw)

    return make, {"option": (0.20, 0.4, HYB_OPTION_PATHS, 11),
                  "exposure": (0.20, 0.3, HYB_PATHS, 41),
                  "note": (0.25, 0.3, HYB_PATHS, 53)}


def hybrid_results(hybrids) -> dict:
    """Every hybrid check's numbers on ``{"option": h, "exposure": h,
    "note": h}``."""
    from finmath_tpu_torch.models.lmm.hybrid import (
        EquityForwardTrade, EquityOptionTrade, HybridAutocallableNote,
        HybridExposureEngine)

    p0 = np.zeros(0)
    h = hybrids["option"]
    out = {"martingale_errors": h.martingale_errors(p0),
           "option": h.european_option_value(p0, 6, 105.0),
           "forward": h.forward_value(p0, 8)}
    prof = HybridExposureEngine(
        hybrids["exposure"], [EquityForwardTrade(0, 8, 100.0),
                              EquityOptionTrade(0, 6, 110.0)],
        quantiles=(0.95, 0.99)).profile(p0)
    out["profile"] = _profile_dict(prof)
    out["profile_times"] = prof.times
    note = HybridAutocallableNote(hybrids["note"], [1, 2], [105.0, 100.0],
                                  [0.05, 0.08], 70.0)
    out["note"] = note.get_value_and_error(p0)
    return out


def rank_scenarios(mesh):
    """Every scenario of this file on one rank of the world."""
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm.exposure import SwapExposureEngine

    setup = build_atm_calibration(num_paths=PATHS, num_factors=1,
                                  device="cpu")
    out = exposure_results(mesh, setup)
    out["indivisible"] = _error(lambda: SwapExposureEngine(
        setup.model, num_paths=PATHS + 2, num_factors=1, mesh=mesh,
        device="cpu", **SWAP))

    make, specs = _hybrids(mesh, antithetic=True)
    hybrids = {k: make(*v) for k, v in specs.items()}
    out["hybrid"] = hybrid_results(hybrids)
    # this rank's own draws, for the unsharded hybrid on the same paths
    out["hybrid_draws"] = {
        k: (h.engine.increments.numpy(), h.equity_normals.numpy())
        for k, h in hybrids.items()}
    out["hybrid_simulated"] = [a.shape for a in
                               hybrids["note"].simulate(np.zeros(0))]
    sigma, rho, paths, seed = specs["note"]
    zeros = np.zeros((10, 1, paths), dtype=np.float32)
    out["hybrid_increments"] = _error(
        lambda: make(sigma, rho, paths, seed, increments=zeros))
    out["hybrid_equity_normals"] = _error(
        lambda: make(sigma, rho, paths, seed,
                     equity_normals=zeros.reshape(10, 1, paths)))
    out["collectives"] = mesh.calls
    return out


def unsharded_references(mesh):
    """The unsharded port on the same inputs, in a process of its own
    beside the world (a world of one; its mesh is not used): the exposure
    results, each date's largest |V/N| and |V| over the swap's paths (the
    cross-package bounds' scale) and the hybrids on their own stream."""
    from finmath_tpu_torch.models.lmm import build_atm_calibration
    from finmath_tpu_torch.models.lmm.exposure import SwapExposureEngine

    setup = build_atm_calibration(num_paths=PATHS, num_factors=1,
                                  device="cpu")
    ref = exposure_results(None, setup)
    model = setup.model
    swap = SwapExposureEngine(model, num_paths=PATHS, num_factors=1,
                              increments=sobol_block(model, PATHS, 11),
                              device="cpu", **SWAP)
    p0 = np.asarray(setup.covariance.initial_parameters)
    outs = swap.engine._simulate_collect(swap.engine._params(p0),
                                         swap._collect)
    v = torch.stack([o[0] for o in outs]).numpy()
    inv_n = torch.stack([o[-1] for o in outs]).numpy()
    ref["swap_vn_max"] = np.max(np.abs(v * inv_n), axis=-1)
    ref["swap_v_max"] = np.max(np.abs(v), axis=-1)
    make, specs = _hybrids(None, antithetic=True)
    h = make(*specs["option"])
    ref["hybrid_own_option"] = h.european_option_value(np.zeros(0), 6, 105.0)
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(per-rank results, references): the world and the unsharded port
    run in child processes while the parent computes the JAX references;
    the unsharded hybrid on the ranks' draws runs last, in the parent."""
    kw = dict(backend="gloo", device="cpu",
              directory=tmp_path_factory.mktemp("world"))
    with start_world(f"{__name__}:rank_scenarios", W, threads=1, **kw) \
            as world, start_world(f"{__name__}:unsharded_references", 1,
                                  threads=2, **kw) as unsharded:
        refs = _jax_references()
        ranks = world.join(timeout=600)
        refs.update(unsharded.join(timeout=600)[0])
    refs["hybrid_on_rank_draws"] = _hybrid_on_rank_draws(ranks)
    return ranks, refs


def _hybrid_on_rank_draws(ranks) -> dict:
    """The unsharded hybrids fed every rank's draws in rank order as
    ``increments`` and ``equity_normals``: the meshed hybrids' paths."""
    make, specs = _hybrids(None)
    hybrids = {}
    for k, spec in specs.items():
        inc = np.concatenate([r["hybrid_draws"][k][0] for r in ranks], -1)
        eq = np.concatenate([r["hybrid_draws"][k][1] for r in ranks], -1)
        hybrids[k] = make(*spec, increments=inc, equity_normals=eq)
    return hybrid_results(hybrids)


def _jax_references() -> dict:
    from finmath_tpu.models.lmm import exposure as jx
    from finmath_tpu.models.lmm.atm_calibration import build_atm_calibration
    from finmath_tpu.parallel import make_path_mesh

    jmesh = make_path_mesh(8)
    sj = build_atm_calibration(num_paths=PATHS, num_factors=1)
    p0 = sj.covariance.initial_parameters
    swap = jx.SwapExposureEngine(sj.model, num_paths=PATHS, num_factors=1,
                                 increments=sobol_block(sj.model, PATHS, 11),
                                 mesh=jmesh, **SWAP)
    ref = {"jax_swap": _profile_dict(swap.profile(p0))}
    ref["jax_cva"], ref["jax_cva_deltas"] = swap.cva_forward_deltas(
        p0, hazard_rate=HAZARD)
    trades = [jx.SwaptionTrade(4, 4, 0.01),
              jx.BermudanSwaptionTrade((4, 6), 10, 0.01)]
    ref["jax_options"] = _profile_dict(jx.NettingSetExposureEngine(
        sj.model, trades, num_paths=PATHS, num_factors=1, mesh=jmesh,
        increments=sobol_block(sj.model, PATHS, 23)).profile(p0))
    return ref


def _ulps32(x):
    """32 float32 ulps of ``x``."""
    return 32.0 * np.spacing(np.abs(np.asarray(x)).astype(np.float32)
                             ).astype(np.float64)


ROWS = ("ee", "ene", "forward_value")


# ---------------------------------------------------------------------------
# the meshed port against the unsharded port on the same block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row", ROWS + ("ee_standalone",))
def test_swap_profile_matches_unsharded(run, row):
    ranks, refs = run
    for r in ranks:
        np.testing.assert_allclose(r["swap"][row], refs["swap"][row],
                                   rtol=0, atol=1e-12)


def test_swap_pfe_is_the_unsharded_pfe_bit_for_bit(run):
    ranks, refs = run
    for r in ranks:
        for q, want in refs["swap"]["pfe"].items():
            np.testing.assert_array_equal(r["swap"]["pfe"][q], want)


def test_cva_and_its_ladder_match_unsharded(run):
    """The ladder differentiates through the numeraire mean, a global mean
    inside the per-path function: without ``replicated`` on it each rank
    would keep its own partial of that term and the ladder would move."""
    ranks, refs = run
    for r in ranks:
        assert r["cva"] == pytest.approx(refs["cva"], rel=1e-10)
        np.testing.assert_allclose(r["cva_deltas"], refs["cva_deltas"],
                                   rtol=1e-6, atol=1e-10)
        assert np.all(r["cva_deltas"][SWAP["last_index"]:] == 0.0)


@pytest.mark.parametrize("row", ["expected_im", "expected_im_tmoney"])
def test_im_profile_matches_unsharded(run, row):
    ranks, refs = run
    for r in ranks:
        np.testing.assert_allclose(r["im"][row], refs["im"][row], rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("row", ROWS + ("pfe",))
def test_option_netting_set_matches_unsharded(run, row):
    """The swaption and Bermudan close-out regressions fit on all-reduced
    normal equations: every rank fits the global policy."""
    ranks, refs = run
    for r in ranks:
        if row == "pfe":
            np.testing.assert_allclose(r["options"]["pfe"][0.99],
                                       refs["options"]["pfe"][0.99],
                                       rtol=0, atol=1e-7)
        else:
            np.testing.assert_allclose(r["options"][row],
                                       refs["options"][row], rtol=0,
                                       atol=1e-8)


@pytest.mark.parametrize("terms", ["lag1", "mta"])
@pytest.mark.parametrize("row", ROWS + ("ee_gross", "ene_gross", "pfe"))
def test_csa_profile_matches_unsharded(run, terms, row):
    """The margin balance is path-local: the meshed CSA profile is the
    unsharded one (``tests/test_xva_extensions.py:174``), the PFE of the
    residual exposure bit for bit; ``mta`` adds the transfer scan,
    thresholds and an independent amount."""
    ranks, refs = run
    want = refs["csa"][terms]
    for r in ranks:
        got = r["csa"][terms]
        if row == "pfe":
            for q in want["pfe"]:
                np.testing.assert_array_equal(got["pfe"][q], want["pfe"][q])
        else:
            np.testing.assert_allclose(got[row], want[row], rtol=0,
                                       atol=1e-12)


def test_own_stream_is_deterministic_and_near_unsharded(run):
    """The meshed engine's own stream is the ranks' ``rank_seed`` draws:
    not the unsharded paths, but the same profile within the noise, and
    the forward value a martingale."""
    ranks, refs = run
    for r in ranks:
        for name in ROWS:
            np.testing.assert_array_equal(r["own"][0][name],
                                          r["own"][1][name])
    got, want = ranks[0]["own"][0], refs["own"][0]
    assert not np.array_equal(got["ee"], want["ee"])
    assert np.max(np.abs(got["ee"] - want["ee"])) < 2e-3
    np.testing.assert_allclose(got["forward_value"],
                               ranks[0]["analytic_forward"], atol=2e-3)


def test_every_rank_returns_the_same_results(run):
    ranks, _ = run
    for r in ranks[1:]:
        for key in ("swap", "options"):
            for row in ROWS:
                np.testing.assert_array_equal(r[key][row], ranks[0][key][row])
        np.testing.assert_array_equal(r["cva_deltas"], ranks[0]["cva_deltas"])
        np.testing.assert_array_equal(r["im"]["expected_im"],
                                      ranks[0]["im"]["expected_im"])
        for row in ROWS:
            np.testing.assert_array_equal(r["hybrid"]["profile"][row],
                                          ranks[0]["hybrid"]["profile"][row])
        assert r["hybrid"]["note"] == ranks[0]["hybrid"]["note"]
        assert r["hybrid"]["option"] == ranks[0]["hybrid"]["option"]
        assert r["collectives"] == ranks[0]["collectives"]


def test_indivisible_paths_rejected(run):
    ranks, _ = run
    for r in ranks:
        assert r["indivisible"].startswith("ValueError")
        assert "divisible" in r["indivisible"]


# ---------------------------------------------------------------------------
# the meshed port against the meshed JAX engine on the same block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row", ROWS + ("ee_standalone",))
def test_swap_profile_matches_jax_meshed(run, row):
    ranks, refs = run
    got, want = ranks[0]["swap"][row], refs["jax_swap"][row]
    assert got.shape == want.shape == (SWAP["last_index"] - 1,)
    assert np.all(np.abs(got - want) <= _ulps32(refs["swap_vn_max"]))


def test_swap_pfe_matches_jax_meshed(run):
    ranks, refs = run
    for q, want in refs["jax_swap"]["pfe"].items():
        assert np.all(np.abs(ranks[0]["swap"]["pfe"][q] - want)
                      <= _ulps32(refs["swap_v_max"]))


def test_cva_ladder_matches_jax_meshed(run):
    ranks, refs = run
    gj = np.asarray(refs["jax_cva_deltas"])
    got = ranks[0]["cva_deltas"]
    assert got.shape == gj.shape == (80,)
    assert np.max(np.abs(got - gj)) <= 1e-4 * np.max(np.abs(gj))
    assert ranks[0]["cva"] == pytest.approx(refs["jax_cva"], rel=1e-6)


@pytest.mark.parametrize("row", ROWS + ("ee_standalone", "pfe"))
def test_option_netting_set_matches_jax_meshed(run, row):
    ranks, refs = run
    got, want = ranks[0]["options"], refs["jax_options"]
    if row == "pfe":
        for q in want["pfe"]:
            assert np.max(np.abs(got["pfe"][q] - want["pfe"][q])) <= \
                _ulps32(np.max(np.abs(want["pfe"][q])))
        return
    scale = max(np.max(np.abs(want[r])) for r in ROWS + ("ee_standalone",))
    assert np.max(np.abs(got[row] - want[row])) <= 1e-6 * scale


# ---------------------------------------------------------------------------
# the hybrid on the mesh
# ---------------------------------------------------------------------------

def test_hybrid_martingale_and_option_on_the_mesh(run):
    """``TestHybridMesh.test_martingale_and_option_on_mesh``: the ranks'
    own streams are not the unsharded stream, so the option agrees within
    the noise."""
    ranks, refs = run
    h = ranks[0]["hybrid"]
    assert np.nanmax(np.abs(h["martingale_errors"])) < 0.02
    v_m, se_m = h["option"]
    v_u, se_u = refs["hybrid_own_option"]
    assert v_m != v_u
    assert abs(v_m - v_u) < 4 * (se_m + se_u)


def test_hybrid_exposure_profile_on_the_mesh(run):
    ranks, _ = run
    prof = ranks[0]["hybrid"]["profile"]
    times = ranks[0]["hybrid"]["profile_times"]
    assert np.allclose(prof["ee"] + prof["ene"], prof["forward_value"],
                       atol=1e-10)
    assert np.all(np.isfinite(prof["ee"])) and np.all(prof["ee"] >= 0.0)
    pre = times <= 3.0 - 1e-9              # index 6 of the 0.5-year grid
    assert prof["ee"][pre][-1] > prof["ee"][pre][0]


def test_hybrid_autocallable_on_the_mesh(run):
    ranks, _ = run
    v, e = ranks[0]["hybrid"]["note"]
    assert 0.8 < v < 1.2 and e > 0.0


def test_meshed_hybrid_is_the_unsharded_hybrid_on_the_rank_draws(run):
    """The unsharded hybrid fed the ranks' concatenated ``rank_seed`` draws
    simulates the meshed hybrid's paths: equal up to the order of the
    float64 sums. The option trade's close-out is a regression on
    all-reduced normal equations, so the netted values, and with them the
    PFE, move in their last bits (measured 3.4e-13 relative): the PFE
    within 1e-10 relative."""
    ranks, refs = run
    want = refs["hybrid_on_rank_draws"]
    for r in ranks:
        got = r["hybrid"]
        np.testing.assert_allclose(got["martingale_errors"],
                                   want["martingale_errors"], rtol=0,
                                   atol=1e-12)
        for key in ("option", "forward", "note"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                       atol=0)
        for row in ROWS:
            np.testing.assert_allclose(got["profile"][row],
                                       want["profile"][row], rtol=0,
                                       atol=1e-9)
        for q in want["profile"]["pfe"]:
            np.testing.assert_allclose(got["profile"]["pfe"][q],
                                       want["profile"]["pfe"][q],
                                       rtol=1e-10, atol=0)


def test_meshed_hybrid_simulate_gathers_every_path(run):
    ranks, _ = run
    for r in ranks:
        assert r["hybrid_simulated"] == [(len(range(1, 10)), 1, HYB_PATHS),
                                         (len(range(1, 10)), HYB_PATHS)]


def test_meshed_hybrid_refuses_injected_draws(run):
    """As the JAX hybrid refuses ``increments`` under a mesh (and the
    port's ``equity_normals`` with them), before any collective."""
    ranks, _ = run
    for r in ranks:
        assert r["hybrid_increments"].startswith("NotImplementedError")
        assert r["hybrid_equity_normals"].startswith("NotImplementedError")
