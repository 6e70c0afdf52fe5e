"""The port's LMM examples 05-08, 15 and 16 (``finmath_tpu_torch/
examples``), each loaded with ``importlib`` from its file path and its
``main`` run once in this process on ``device="cpu"`` at a small size
(module fixtures). On the CPU the kernel wrappers run their plain
versions and count no launch.

* 05: the step-loop and fused prices within the script's 0.005 of the
  analytic value, ``berm >= euro - 1e-4`` (the script's asserts), the
  kernel's swaption within 5% of the engine's on another stream.
* 06: the lazy averages within 1e-6 relative of the JAX package's
  ``RandomVariableTPULazy`` on the same input; the quotes on the
  reference's Mersenne realization and on antithetic Sobol paths, and
  the values on three swapped Sobol scramblings, against the JAX engine
  on the same increments within 5e-5 (the engine bound of
  ``tests/test_torch_stochvol_calibration.py``); the Sobol terminal
  variance equal to the JAX package's.
* 07: the delta matrix's rows sum to the portfolio ladder (the script's
  check, ``rtol=1e-4, atol=1e-6``).
* 08 and 15: the profiles' shapes, the CVA rising with the hazard, the
  netting benefit, the Bermudan bracket, KVA by the two routes.
* 16: the kernel backend's residuals on the reduced model against the
  JAX engine's on the same 256 Sobol paths (``tests/test_kernel_backend.py
  ::_small_setup``) within the kernel-vs-engine envelope of 5e-5; the
  book priced with one copy equal to its products priced one by one
  within 1e-12.

As in ``tests/test_torch_stochvol_models.py``, the JAX package runs with
its eigen-reduced factors given the port's signs (``jax_fixed_signs``), so
that both packages price the same paths."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_examples import run  # noqa: E402
from test_torch_stochvol_models import jax_fixed_signs  # noqa: E402, F401

QMC_PATHS = 1024
ENGINE_BOUND = 5e-5


def launch_counts():
    from finmath_tpu_torch.ops import (_swaption_paths, kernels,
                                       lmm_stochvol_kernel)

    return (dict(kernels.LAUNCHES), dict(_swaption_paths.LAUNCHES),
            lmm_stochvol_kernel.LAUNCHES)


@pytest.fixture(scope="module")
def kernels_run():
    before = launch_counts()
    out = run("05_pallas_kernels_and_bermudan", fused_paths=20_000,
              swaption_paths=8_192, bermudan_paths=4_000)
    return out, before, launch_counts()


@pytest.fixture(scope="module")
def qmc_run():
    return run("06_lazy_qmc_and_reference_stream", lazy_paths=20_000,
               reference_paths=QMC_PATHS, qmc_paths=QMC_PATHS,
               bermudan_paths=2_048, swap_paths=QMC_PATHS)


@pytest.fixture(scope="module")
def jax_06():
    """The JAX package on 06's host-made inputs."""
    from finmath_tpu import RandomVariableTPULazy, averages
    from finmath_tpu.models.lmm.benchmark_calibration import (
        build_benchmark_calibration)
    from finmath_tpu.models.qmc import sobol_brownian_increments

    x = np.random.default_rng(0).uniform(0.5, 2.0, 20_000).astype(
        np.float32)
    lazy = RandomVariableTPULazy(0.0, x)
    y = lazy.mult(1.01).add(0.02).exp().log().discount(lazy, 0.5)
    out = {"average": y.get_average(),
           "portfolio": averages(*[lazy.mult(k).exp().cap(3.0)
                                   for k in (0.5, 0.7, 0.9)])}
    inc = sobol_brownian_increments(np.full(16, 1.0 / 16), 1, QMC_PATHS,
                                    seed=7)
    out["terminal_variance"] = float(np.asarray(inc).sum(axis=0)[0].var())
    s = build_benchmark_calibration(num_paths=QMC_PATHS,
                                    brownian="finmath_mersenne")
    out["mersenne"] = np.asarray(s.engine.implied_vols(
        s.covariance.initial_parameters))
    s = build_benchmark_calibration(num_paths=QMC_PATHS, brownian="sobol",
                                    antithetic=True)
    out["sobol"] = np.asarray(s.engine.implied_vols(
        s.covariance.initial_parameters))
    s = build_benchmark_calibration(num_paths=QMC_PATHS, brownian="sobol",
                                    seed=0)
    p0 = s.covariance.initial_parameters
    out["values"] = np.asarray(s.engine.values(p0))
    out["swapped"] = []
    for k in (1, 2, 3):
        s.set_increments(np.asarray(sobol_brownian_increments(
            np.full(40, 0.5), 6, QMC_PATHS, seed=k)))
        out["swapped"].append(np.asarray(s.engine.values(p0)))
    return out


@pytest.fixture(scope="module")
def kernel_calibration_run():
    before = launch_counts()
    out = run("16_kernel_calibration_and_portfolio", book_paths=20_000)
    return out, before, launch_counts()


def test_05_kernels_and_bermudan(kernels_run):
    (out, printed), before, after = kernels_run
    for head in ("analytic ", " | step loop ", "fused kernel ",
                 "20,000 paths x 100 steps in one launch on cpu",
                 "LMM 5Yx10Y swaption: engine ", "| kernel ",
                 "different streams",
                 "payer swaption 4Yx6Y strike 1%: European "):
        assert head in printed, head
    assert abs(out["fused"] - out["analytic"]) < 0.005
    assert abs(out["scan"] - out["analytic"]) < 0.005
    assert out["bermudan"] >= out["european"] - 1e-4
    assert out["swaption_rel_dev"] < 0.05
    # on the CPU the wrappers run their plain versions: no launch counted
    assert after == before


def test_06_lazy_qmc_and_reference_stream(qmc_run, jax_06):
    out, printed = qmc_run
    for head in ("pending: RandomVariableTorchLazy(", "average: ",
                 "portfolio averages (one flush): ",
                 "mixed strict/lazy type: RandomVariableTorchLazy",
                 "implied vols on finmath's own 1024-path realization:",
                 "QMC terminal variance (want 1.0):",
                 "stoch-vol quotes on QMC paths:", "Bermudan LS value ",
                 "scrambling 3: first quote ",
                 "3 realization swaps + revaluations: "):
        assert head in printed, head
    lazy = out["lazy"]
    assert lazy["average"] == pytest.approx(jax_06["average"], rel=1e-6)
    np.testing.assert_allclose(lazy["portfolio"], jax_06["portfolio"],
                               rtol=1e-6)
    assert lazy["mixed_type"] == "RandomVariableTorchLazy"
    assert out["qmc"]["terminal_variance"] == jax_06["terminal_variance"]
    np.testing.assert_allclose(out["reference_vols"], jax_06["mersenne"],
                               rtol=0, atol=ENGINE_BOUND)
    np.testing.assert_allclose(out["qmc"]["vols"], jax_06["sobol"], rtol=0,
                               atol=ENGINE_BOUND)
    sw = out["swapping"]
    np.testing.assert_allclose(sw["values"], jax_06["values"], rtol=0,
                               atol=ENGINE_BOUND)
    for got, want in zip(sw["swapped"], jax_06["swapped"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=ENGINE_BOUND)
    assert not np.array_equal(sw["swapped"][0], sw["values"])
    berm = out["bermudan"]
    assert berm["lower"] <= berm["upper"]


def test_07_risk_ladders():
    out, printed = run("07_risk_ladders", ladder_paths=2_000,
                       matrix_paths=1_024)
    assert "portfolio of 144 swaptions, 80 curve buckets" in printed
    assert "delta matrix (15, 40), rows sum to portfolio ladder: True" \
        in printed
    assert printed.count("  bucket ") == 5
    for p in (0, 7, 14):
        assert f"  product {p:2d}: dominant bucket " in printed
    assert out["portfolio"]["ladder"].shape == (80,)
    assert np.all(np.isfinite(out["portfolio"]["ladder"]))
    m = out["matrix"]
    assert m["rows_sum_to_ladder"]
    np.testing.assert_allclose(m["matrix"].sum(axis=0), m["ladder"],
                               rtol=1e-4, atol=1e-6)


def test_08_exposure_cva():
    out, printed = run("08_exposure_cva", num_paths=2_000)
    for head in ("par rate of the underlying swap: ", "peak EE ",
                 "peak PFE(99%) ", "martingale check: ",
                 "CVA @ hazard   300 bp:", "netting set (3 trades):",
                 "CVA delta ladder (80 buckets, one reverse pass):",
                 "bilateral CVA (cpty 200bp / own 80bp):",
                 "5Y-into-5Y payer swaption (physical): value",
                 "post-exercise ENE (two-way swap):"):
        assert head in printed, head
    prof = out["profile"]
    assert prof.ee.shape == prof.times.shape == out["analytic"].shape
    assert np.all(prof.ee >= 0) and np.all(prof.ene <= 0)
    cva = [out["cva"][h] for h in (0.004, 0.012, 0.03)]
    assert 0 < cva[0] < cva[1] < cva[2]
    nprof = out["netting_profile"]
    assert np.all(nprof.ee <= nprof.ee_standalone + 1e-6)
    assert out["ladder"].shape == (80,) and np.all(np.isfinite(out["ladder"]))
    assert out["ladder_cva"] == pytest.approx(out["netted_cva"], rel=1e-6)
    assert out["bilateral_cva"] > 0
    assert np.all(np.isfinite(out["swaption_profile"].ee))


def test_15_bermudan_exposure_kva():
    out, printed = run("15_bermudan_exposure_kva", num_paths=2_000)
    for head in ("underlying par rate: ",
                 "exercises at tenor indices (8, 10, 12, 14, 16, 18, 20, 22)",
                 "Bermudan t=0 value (forward_value[0]): ",
                 "BermudanSwaptionPricer bracket: [", "peak EE ",
                 "CVA (2% hazard, 40% recovery): ", "netting benefit (peak): ",
                 "SA-CCR EAD at first obs: ", "KVA (10% cost of capital): ",
                 "one-call kva(): "):
        assert head in printed, head
    lo, hi = out["bracket"]
    assert 0 < lo <= hi
    assert out["cva"] > out["netted_cva"] >= 0
    assert out["ead"].shape == out["profile"].times.shape
    assert out["kva"] > 0
    assert out["kva_one_call"] == pytest.approx(out["kva"], rel=1e-12)


def test_16_kernel_calibration_and_portfolio(kernel_calibration_run):
    from test_kernel_backend import _small_setup

    (out, printed), before, after = kernel_calibration_run
    assert "kernel residuals+Jacobian ((4, 8)) in " in printed
    assert "the kernel's plain version, 17 parameter sets x 256 paths" \
        in printed
    assert "10-product book at 20,000 paths (one packed transfer):" \
        in printed
    cal = out["calibration"]
    assert cal["jacobian"].shape == (4, 8) and cal["parameter_sets"] == 17
    assert cal["gap"] < ENGINE_BOUND
    # on the CPU no launch is counted, in the timed call or elsewhere
    assert cal["launches"] == 0 and after == before
    # the JAX engine on the same 256 Sobol paths
    engine, _, _ = _small_setup()
    jr = np.asarray(engine.residuals(cal["x"]))
    np.testing.assert_allclose(cal["residuals"], jr, rtol=0,
                               atol=ENGINE_BOUND)
    np.testing.assert_allclose(cal["engine_residuals"], jr, rtol=0,
                               atol=ENGINE_BOUND)
    # the book priced with one copy is its products priced one by one
    book = out["book"]
    single = [p.get_value_and_error(book["model"]) for p in book["book"]]
    np.testing.assert_allclose(book["results"], single, rtol=1e-12,
                               atol=1e-12)
