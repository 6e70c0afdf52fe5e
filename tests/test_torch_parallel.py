"""Path-axis sharding of the port over torch.distributed: ``parallel.mesh``
(``sharded_mean``, ``mc_price_sharded``, ``make_path_mesh``), the meshed
LMM engine, both calibrations and the sharded regression, on one spawned
gloo world of four CPU ranks (a ``file://`` store, one thread a rank).

The ranks import only torch, numpy and the port: every scenario runs in
``rank_scenarios`` at module level, which imports no JAX (this module
imports JAX only inside its fixtures), and returns its results; the tests
assert in the parent, where the JAX package runs on conftest's eight
virtual devices. The parent computes the JAX references and the unsharded
port while the ranks run.

Bounds:
* the meshed port against the unsharded port on one injected block: the
  float64 reduction gap (values 1e-12 relative; residuals, Jacobians and
  the batched pair 1e-9 absolute). The delta ladder sums each path's
  adjoint in the path dtype (the float32 ``expand`` backward), so rank
  blocks and the whole axis round differently there: 1e-6 of the largest
  entry (the gap measured at 1,600 paths: 1.0e-7 of it);
* the meshed port against the meshed JAX engine on that block:
  ``tests/test_torch_atm_calibration.py``'s cross-package bounds (values
  rtol 1e-5, implied vols atol 1e-6, Jacobian 1e-3 column-scaled), and for
  the stoch-vol benchmark on the finmath Mersenne stream implied vols
  atol 1e-6 (``tests/test_torch_stochvol_models.py``) and the Jacobian
  1e-3 column-scaled;
* on the port's own stream, ``tests/test_parallel.py``'s bounds (2e-3
  between meshed and unsharded, rtol 1e-6 / atol 1e-9 between batched rows
  and single calls, 0.05 on the stoch-vol quotes with target < 0.5).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.parallel.launch import start_world  # noqa: E402

W = 4
PATHS, JAC_PATHS, STEPS, BLOCK_SEED = 1_600, 400, 61, 20161230
SV_PATHS, SV_SEED = 4_096, 314151
S0, R, SIGMA, T, K = 1.0, 0.05, 0.30, 1.0, 1.05
MEAN_SIZE = 80_000
LM_ITERATIONS = 2
REG_PATHS, REG_BASIS = 4_000, 4


def atm_block() -> np.ndarray:
    """The injected realization ``[61, 1, 1600]``, sqrt(dt)-scaled (one
    step past the last exercise, which the JAX engine's fused scan needs)."""
    rng = np.random.default_rng(BLOCK_SEED)
    return (np.sqrt(0.5) * rng.standard_normal((STEPS, 1, PATHS))
            ).astype(np.float32)


def mean_floats() -> np.ndarray:
    return np.random.default_rng(0).standard_normal(MEAN_SIZE).astype(
        np.float32)


def regression_data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(REG_PATHS).astype(np.float32)
    basis = np.stack([x ** k for k in range(REG_BASIS)]).astype(np.float32)
    y = (np.exp(0.3 * x) + 0.1 * rng.standard_normal(REG_PATHS)).astype(
        np.float32)
    return basis, y


def _error(fn):
    """The exception's type name, or None: a rank records what raised
    instead of failing (the check runs before any collective)."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - recorded for the parent
        return type(exc).__name__
    return None


def _atm_engine(setup, paths, mesh, increments=None):
    from finmath_tpu_torch.models.lmm.model import LMMValuationEngine

    return LMMValuationEngine(setup.model, setup.products, paths, 1,
                              device="cpu", increments=increments, mesh=mesh)


def _block_results(engine, x0):
    X = np.stack([x0, 1.05 * x0])
    value, deltas = engine.forward_deltas(x0)
    return dict(values=engine.values(x0), implied_vols=engine.implied_vols(x0),
                residuals=engine.residuals(x0), jacobian=engine.jacobian(x0),
                residuals_batched=engine.residuals_batched(X),
                jacobian_batched=engine.jacobian_batched(X),
                forward_deltas=np.append(deltas, value))


def _lm_setup(setup, mesh):
    block = atm_block()
    return dataclasses.replace(
        setup, engine=_atm_engine(setup, PATHS, mesh, block),
        jacobian_engine=_atm_engine(setup, JAC_PATHS, mesh,
                                    block[:, :, :JAC_PATHS]))


def rank_scenarios(mesh):
    """Every scenario of this file on one rank of the world."""
    from torch.func import jacfwd

    from finmath_tpu_torch.models.lmm import atm_calibration as tatm
    from finmath_tpu_torch.models.lmm import benchmark_calibration as tbench
    from finmath_tpu_torch.models.lmm.kernel_backend import (
        ATMKernelCalibration, StochVolKernelCalibration)
    from finmath_tpu_torch.ops.conditional_expectation import regression_fit
    from finmath_tpu_torch.parallel import (make_path_mesh, mc_price_sharded,
                                            sharded_mean)

    out = {"rank": mesh.rank}
    x = mean_floats()
    out["mean"] = sharded_mean(mesh)(
        torch.as_tensor(x[mesh.local_slice(x.size)]))

    def price(seed, paths, steps, sigma=SIGMA):
        return mc_price_sharded(mesh, seed, paths, steps, S0, R, sigma, T, K)

    out["price"] = float(price(3141, 160_000, 50))
    out["price_repeat"] = [float(price(7, 16_000, 10)) for _ in range(2)]
    out["price_indivisible"] = _error(lambda: price(7, 1001, 10))
    sig = torch.tensor(SIGMA, dtype=torch.float64, requires_grad=True)
    (vega,) = torch.autograd.grad(price(3141, 80_000, 25, sig), sig)
    eps = 1e-3
    out["vega"] = float(vega)
    out["vega_fd"] = (float(price(3141, 80_000, 25, SIGMA + eps))
                      - float(price(3141, 80_000, 25, SIGMA - eps))) / (2 * eps)

    # the ATM engine on one injected block and on its own stream
    setup = tatm.build_atm_calibration(num_paths=PATHS, num_factors=1,
                                       jacobian_paths=JAC_PATHS, mesh=mesh,
                                       device="cpu")
    out["setup_meshed"] = (setup.engine.mesh is mesh
                           and setup.jacobian_engine.mesh is mesh)
    x0 = np.asarray(setup.covariance.initial_parameters)
    out["block"] = _block_results(
        _atm_engine(setup, PATHS, mesh, atm_block()), x0)
    own = setup.engine
    out["own_residuals"] = [own.residuals(x0), own.residuals(x0)]
    out["own_batched"] = own.residuals_batched(np.stack([x0, 1.05 * x0]))
    out["own_single_105"] = own.residuals(1.05 * x0)
    xt = torch.tensor(x0, requires_grad=True)
    loss = torch.sum(own._residuals(xt) ** 2)
    (g,) = torch.autograd.grad(loss, xt)
    out["loss"] = float(loss)
    out["loss_after_step"] = float(torch.sum(
        own._residuals(xt.detach() - 0.05 * g) ** 2))
    out["gradient_finite"] = bool(torch.all(torch.isfinite(g)))
    out["jacfwd_through_collective"] = _error(
        lambda: jacfwd(own._residuals)(torch.as_tensor(x0)))
    out["indivisible_engine"] = _error(
        lambda: _atm_engine(setup, PATHS + 1, mesh))
    out["odd_antithetic_block"] = _error(
        lambda: tatm.build_atm_calibration(num_paths=3 * W, mesh=mesh,
                                           device="cpu", antithetic=True))
    out["pathwise_values"] = _error(lambda: own.pathwise_values(x0))
    out["atm_kernel_backend"] = _error(lambda: ATMKernelCalibration(own))

    # the stoch-vol benchmark: the engine's own stream and the Mersenne one
    sv = tbench.build_benchmark_calibration(num_paths=SV_PATHS, seed=SV_SEED,
                                            mesh=mesh, device="cpu")
    p0 = np.asarray(sv.covariance.initial_parameters)
    out["sv_residuals"] = sv.engine.residuals(p0)
    out["sv_jacobian"] = sv.engine.jacobian(p0)
    out["sv_targets"] = np.asarray([p.target for p in sv.engine.products])
    out["sv_kernel_backend"] = _error(
        lambda: StochVolKernelCalibration(sv.engine))
    svm = tbench.build_benchmark_calibration(
        num_paths=SV_PATHS, seed=SV_SEED, brownian="finmath_mersenne",
        mesh=mesh, device="cpu")
    out["svm_implied_vols"] = svm.engine.implied_vols(p0)
    out["svm_jacobian"] = svm.engine.jacobian(p0)
    # the sweep engine's path count: rounded down to W (x 2 antithetic)
    sweep = {}
    for paths, anti in ((40_004, False), (40_008, True)):
        s = tbench.build_benchmark_calibration(
            num_paths=paths, seed=SV_SEED, mesh=mesh, device="cpu",
            antithetic=anti)
        sweep[(paths, anti)] = (s.sweep_engine().num_paths,
                                s.sweep_engine().mesh is mesh)
    out["sweep"] = sweep

    # the ATM calibration: identical iterates on every rank
    result = _lm_setup(setup, mesh).calibrate(max_iterations=LM_ITERATIONS)
    out["lm_parameters"] = result.parameters
    out["lm_history"] = np.asarray(result.history)

    basis, y = regression_data()
    block = mesh.local_slice(REG_PATHS)
    out["beta"] = regression_fit(torch.as_tensor(basis[:, block]),
                                 torch.as_tensor(y[block]),
                                 mesh=mesh).numpy()
    out["wrong_world_size"] = _error(lambda: make_path_mesh(W + 1,
                                                            device="cpu"))
    out["collectives"] = mesh.calls
    return out


def unsharded_references(mesh):
    """The unsharded port on the same inputs, in a process of its own
    beside the world (a world of one; its mesh is not used)."""
    from finmath_tpu_torch.models.lmm import atm_calibration as tatm
    from finmath_tpu_torch.models.lmm import benchmark_calibration as tbench

    ref = {}
    st = tatm.build_atm_calibration(num_paths=PATHS, num_factors=1,
                                    jacobian_paths=JAC_PATHS, device="cpu")
    x0 = np.asarray(st.covariance.initial_parameters)
    ref["block"] = _block_results(_atm_engine(st, PATHS, None, atm_block()),
                                  x0)
    ref["own_residuals"] = st.engine.residuals(x0)
    result = _lm_setup(st, None).calibrate(max_iterations=LM_ITERATIONS)
    ref["lm_parameters"] = result.parameters
    sv = tbench.build_benchmark_calibration(num_paths=SV_PATHS, seed=SV_SEED,
                                            device="cpu")
    ref["sv_residuals"] = sv.engine.residuals(
        np.asarray(sv.covariance.initial_parameters))
    return ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(per-rank results, references): the world and the unsharded port
    run in child processes while the parent computes the JAX
    references."""
    kw = dict(backend="gloo", device="cpu",
              directory=tmp_path_factory.mktemp("world"))
    with start_world(f"{__name__}:rank_scenarios", W, threads=1, **kw) \
            as world, start_world(f"{__name__}:unsharded_references", 1,
                                  threads=2, **kw) as unsharded:
        refs = _jax_references()
        ranks = world.join(timeout=600)
        refs.update(unsharded.join(timeout=600)[0])
    return ranks, refs


def _jax_references() -> dict:
    import jax.numpy as jnp

    from finmath_tpu.models.lmm import atm_calibration as jatm
    from finmath_tpu.models.lmm import benchmark_calibration as jbench
    from finmath_tpu.models.lmm import covariance as jcov
    from finmath_tpu.models.lmm.model import LMMValuationEngine as JaxEngine
    from finmath_tpu.ops.conditional_expectation import (
        regression_fit as jax_regression_fit)
    from finmath_tpu.parallel import make_path_mesh as jax_path_mesh
    from finmath_tpu.parallel import sharded_mean as jax_sharded_mean

    from test_torch_stochvol_models import _jax_factor_reduce_fixed_signs

    ref = {}
    jmesh = jax_path_mesh(8)
    ref["jax_mean"] = jax_sharded_mean(jmesh)(jnp.asarray(mean_floats()))
    ref["numpy_mean"] = float(np.mean(mean_floats().astype(np.float64)))
    basis, y = regression_data()
    ref["jax_beta"] = np.asarray(jax_regression_fit(jnp.asarray(basis),
                                                    jnp.asarray(y)))

    sj = jatm.build_atm_calibration(num_paths=PATHS, num_factors=1)
    je = JaxEngine(sj.model, sj.products, PATHS, 1, increments=atm_block(),
                   mesh=jmesh, scan_mode="fused")
    x0 = np.asarray(sj.covariance.initial_parameters)
    ref["jax_values"] = np.asarray(je.values(x0))
    ref["jax_implied_vols"] = np.asarray(je.implied_vols(x0))
    ref["jax_jacobian"] = np.asarray(je.jacobian(x0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcov, "factor_reduce", _jax_factor_reduce_fixed_signs)
        js = jbench.build_benchmark_calibration(
            num_paths=SV_PATHS, seed=SV_SEED, brownian="finmath_mersenne",
            mesh=jmesh, scan_mode="fused")
        p0 = np.asarray(js.covariance.initial_parameters)
        ref["jax_sv_implied_vols"] = np.asarray(js.engine.implied_vols(p0))
        ref["jax_sv_jacobian"] = np.asarray(js.engine.jacobian(p0))
    return ref


def _column_scaled_gap(J, J_ref) -> float:
    scale = np.maximum(np.abs(J_ref).max(axis=0), 1e-8)
    return float((np.abs(J - J_ref) / scale[None, :]).max())


def test_sharded_mean_matches_jax(run):
    ranks, refs = run
    for r in ranks:
        assert r["mean"] == pytest.approx(refs["jax_mean"], rel=1e-12)
        assert r["mean"] == pytest.approx(refs["numpy_mean"], rel=1e-12)


def test_mc_price_close_to_analytic(run):
    from finmath_tpu_torch.models.analytic import black_scholes_option_value

    ranks, _ = run
    analytic = black_scholes_option_value(S0, R, SIGMA, T, K)
    for r in ranks:
        assert r["price"] == pytest.approx(analytic, abs=0.01)
    assert len({r["price"] for r in ranks}) == 1


def test_mc_price_deterministic(run):
    ranks, _ = run
    for r in ranks:
        assert r["price_repeat"][0] == r["price_repeat"][1]


def test_mc_price_indivisible_paths_rejected(run):
    ranks, _ = run
    assert all(r["price_indivisible"] == "ValueError" for r in ranks)


def test_mc_price_gradient_through_collective(run):
    ranks, _ = run
    for r in ranks:
        assert r["vega"] == pytest.approx(r["vega_fd"], rel=5e-2)
        assert 0.2 < r["vega"] < 0.6
    assert len({r["vega"] for r in ranks}) == 1


def test_meshed_atm_engine_matches_jax_meshed_engine(run):
    ranks, refs = run
    got = ranks[0]["block"]
    np.testing.assert_allclose(got["values"], refs["jax_values"], rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(got["implied_vols"], refs["jax_implied_vols"],
                               rtol=0, atol=1e-6)
    assert got["jacobian"].shape == refs["jax_jacobian"].shape == (144, 43)
    assert _column_scaled_gap(got["jacobian"], refs["jax_jacobian"]) < 1e-3


@pytest.mark.parametrize("name, rtol, atol", [
    ("values", 1e-12, 0.0),
    ("implied_vols", 0.0, 1e-9),
    ("residuals", 0.0, 1e-9),
    ("jacobian", 0.0, 1e-9),
    ("residuals_batched", 0.0, 1e-9),
    ("jacobian_batched", 0.0, 1e-9),
    ("forward_deltas", 0.0, 1e-6),
])
def test_meshed_atm_engine_matches_unsharded_on_the_block(run, name, rtol,
                                                         atol):
    """The same injected paths, split over four ranks or not: the meshed
    results differ from the unsharded ones by the order of the float64
    sums only. The Jacobian is the check that an all-reduce inside
    ``jacfwd`` (which reduces the primal and leaves the tangent local)
    would fail: it would be a quarter of the unsharded one."""
    ranks, refs = run
    want = refs["block"][name]
    if name == "forward_deltas":        # 1e-6 of the largest entry
        atol *= np.abs(want).max()
    for r in ranks:
        got = r["block"][name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_every_rank_returns_the_same_results(run):
    ranks, _ = run
    for r in ranks[1:]:
        for name, value in ranks[0]["block"].items():
            np.testing.assert_array_equal(r["block"][name], value)
        np.testing.assert_array_equal(r["sv_jacobian"],
                                      ranks[0]["sv_jacobian"])
        np.testing.assert_array_equal(r["beta"], ranks[0]["beta"])


def test_own_stream_matches_unsharded_within_noise(run):
    ranks, refs = run
    assert ranks[0]["setup_meshed"]
    r_sh = ranks[0]["own_residuals"][0]
    assert np.max(np.abs(r_sh - refs["own_residuals"])) < 2e-3
    assert not np.array_equal(r_sh, refs["own_residuals"])


def test_own_stream_deterministic(run):
    ranks, _ = run
    for r in ranks:
        np.testing.assert_array_equal(*r["own_residuals"])


def test_indivisible_and_odd_antithetic_paths_rejected(run):
    ranks, _ = run
    for r in ranks:
        assert r["indivisible_engine"] == "ValueError"
        assert r["odd_antithetic_block"] == "ValueError"
        assert r["pathwise_values"] == "ValueError"


def test_batched_rows_equal_single_calls(run):
    ranks, _ = run
    r = ranks[0]
    np.testing.assert_allclose(r["own_batched"][0], r["own_residuals"][0],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(r["own_batched"][1], r["own_single_105"],
                               rtol=1e-6, atol=1e-9)
    block = r["block"]
    np.testing.assert_allclose(block["residuals_batched"][0],
                               block["residuals"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(block["jacobian_batched"][0],
                               block["jacobian"], rtol=1e-6, atol=1e-9)


def test_gradient_step_lowers_the_loss(run):
    ranks, _ = run
    for r in ranks:
        assert r["gradient_finite"]
        assert r["loss_after_step"] < r["loss"]


def test_no_forward_mode_through_a_collective(run):
    """``jacfwd`` through the engine's all-reduce fails loudly instead of
    returning a local tangent."""
    ranks, _ = run
    assert all(r["jacfwd_through_collective"] is not None for r in ranks)


def test_stochvol_benchmark_under_the_mesh(run):
    ranks, refs = run
    r = ranks[0]
    assert np.all(np.isfinite(r["sv_residuals"]))
    keep = r["sv_targets"] < 0.5
    assert np.max(np.abs(r["sv_residuals"] - refs["sv_residuals"])[keep]) \
        < 0.05
    assert r["sv_jacobian"].shape == (15, 8)
    assert np.all(np.isfinite(r["sv_jacobian"]))


def test_stochvol_mersenne_matches_jax_meshed_engine(run):
    ranks, refs = run
    r = ranks[0]
    np.testing.assert_allclose(r["svm_implied_vols"],
                               refs["jax_sv_implied_vols"], rtol=0,
                               atol=1e-6)
    assert _column_scaled_gap(r["svm_jacobian"],
                              refs["jax_sv_jacobian"]) < 1e-3


def test_atm_calibration_iterates_agree_on_every_rank(run):
    """The LM driver runs on each rank on the same all-reduced residuals
    and Jacobians: the parameters are bit for bit the same on all ranks,
    and equal to the unsharded calibration's on the same block."""
    ranks, refs = run
    for r in ranks:
        np.testing.assert_array_equal(r["lm_parameters"],
                                      ranks[0]["lm_parameters"])
        np.testing.assert_array_equal(r["lm_history"], ranks[0]["lm_history"])
    np.testing.assert_allclose(ranks[0]["lm_parameters"],
                               refs["lm_parameters"], rtol=0, atol=1e-8)
    assert len(ranks[0]["lm_history"]) >= 2


def test_regression_fit_matches_jax_on_the_whole_arrays(run):
    ranks, refs = run
    for r in ranks:
        np.testing.assert_allclose(r["beta"], refs["jax_beta"], rtol=1e-9,
                                   atol=1e-12)


def test_kernel_backends_refuse_a_meshed_engine(run):
    ranks, _ = run
    for r in ranks:
        assert r["atm_kernel_backend"] == "ValueError"
        assert r["sv_kernel_backend"] == "ValueError"


def test_make_path_mesh_rejects_a_wrong_world_size(run):
    ranks, _ = run
    assert all(r["wrong_world_size"] == "ValueError" for r in ranks)


def test_sweep_engine_rounds_to_the_mesh(run):
    ranks, _ = run
    for r in ranks:
        # 40,004 / 4 = 10,001 -> 10,000 (a multiple of 4); under antithetic
        # sampling 40,008 / 4 = 10,002 -> 10,000 (a multiple of 8)
        assert r["sweep"][(40_004, False)] == (10_000, True)
        assert r["sweep"][(40_008, True)] == (10_000, True)
    assert all(r["collectives"] == ranks[0]["collectives"] for r in ranks)


def test_make_path_mesh_needs_a_process_group():
    from finmath_tpu_torch.parallel import make_path_mesh
    from finmath_tpu_torch.parallel.mesh import check_mesh, rank_seed

    with pytest.raises(RuntimeError, match="process group"):
        make_path_mesh(1, device="cpu")
    with pytest.raises(NotImplementedError, match="PathMesh"):
        check_mesh(object())
    seeds = {rank_seed(31415, r) for r in range(64)}
    assert len(seeds) == 64 and all(0 <= s < 2 ** 63 for s in seeds)
    assert rank_seed(31415, 3) == rank_seed(31415, 3) != rank_seed(31416, 3)
