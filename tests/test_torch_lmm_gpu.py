"""The LMM engine's float64 parity engine, batched API, realization swap
and delta ladder on a CUDA device, at small sizes (``gpu`` tests; no JAX
needed, run with ``-m gpu --noconftest``; each skips without a card).

Tolerances: the float32 engine within 1e-6 relative of the float64
engine on one stream (ATM setup, 4,000 paths; stoch-vol benchmark, 4,096
paths), the north-star parity of ``tests/test_price_parity.py``;
``residuals_batched`` / ``jacobian_batched`` within rtol 1e-6 / 1e-5 of
the per-set calls (1,024 paths, 2 factors); ``set_increments`` gives a
fresh engine's values bit for bit; the card's delta ladder within rtol
1e-4 of the CPU's on the same increments (absolute floor 1e-4 of the
largest bucket: the two devices round the float32 sweep differently);
the stoch-vol kernel's and the Black inversion kernel's launch counters
lose no launch when eight threads share one backend (a shortened switch
interval)."""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models.lmm import (  # noqa: E402
    StochVolKernelCalibration, build_atm_calibration,
    build_benchmark_calibration)
from finmath_tpu_torch.models.lmm.benchmark_calibration import (  # noqa: E402
    CURATED_BASINS)
from finmath_tpu_torch.models.lmm.model import (  # noqa: E402
    LMMValuationEngine)
from finmath_tpu_torch.models.qmc import (  # noqa: E402
    sobol_brownian_increments)
from finmath_tpu_torch.ops import (black_residuals,  # noqa: E402
                                   lmm_stochvol_kernel)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engines run on the card here")


def _max_rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("setup", ["atm", "stochvol"])
def test_float32_within_1e6_of_float64_on_card(setup):
    _needs_card()
    if setup == "atm":
        s32, s64 = (build_atm_calibration(num_paths=4_000, num_factors=1,
                                          dtype=d, device="cuda")
                    for d in (torch.float32, torch.float64))
    else:
        s32, s64 = (build_benchmark_calibration(num_paths=4_096, dtype=d,
                                                device="cuda")
                    for d in (torch.float32, torch.float64))
    x = s32.covariance.initial_parameters
    assert _max_rel(s32.engine.values(x), s64.engine.values(x)) < 1e-6


@pytest.mark.gpu
def test_batched_api_on_card():
    _needs_card()
    eng = build_benchmark_calibration(num_paths=1_024, num_factors=2,
                                      device="cuda").engine
    X = np.stack([CURATED_BASINS[0], CURATED_BASINS[1]])
    R, J = eng.residuals_batched(X), eng.jacobian_batched(X)
    for k, x in enumerate(X):
        np.testing.assert_allclose(R[k], eng.residuals(x), rtol=1e-6, atol=0)
        np.testing.assert_allclose(J[k], eng.jacobian(x), rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_set_increments_on_card():
    _needs_card()
    paths = 2_048
    a = build_benchmark_calibration(num_paths=paths, num_factors=2,
                                    brownian="sobol", seed=0, device="cuda")
    inc = sobol_brownian_increments(np.full(40, 0.5), 3, paths, seed=1)
    a.set_increments(inc)
    b = LMMValuationEngine(a.model, a.products, paths, 2, device="cuda",
                           increments=inc)
    x = CURATED_BASINS[0]
    np.testing.assert_array_equal(a.engine.values(x), b.values(x))


@pytest.mark.gpu
def test_delta_ladder_card_matches_cpu():
    _needs_card()
    s = build_atm_calibration(num_paths=2_000, num_factors=1, device="cuda")
    x = s.covariance.initial_parameters
    cpu = LMMValuationEngine(s.model, s.products, 2_000, 1, device="cpu",
                             increments=s.engine.increments.cpu())
    v_gpu, g_gpu = s.engine.forward_deltas(x)
    v_cpu, g_cpu = cpu.forward_deltas(x)
    assert v_gpu == pytest.approx(v_cpu, rel=1e-5)
    np.testing.assert_allclose(g_gpu, g_cpu, rtol=1e-4,
                               atol=1e-4 * np.abs(g_cpu).max())


@pytest.mark.gpu
def test_launch_counter_from_threads_on_card():
    _needs_card()
    setup = build_benchmark_calibration(num_paths=1_024, num_factors=2,
                                        device="cuda")
    kb = StochVolKernelCalibration(setup.engine)
    x = setup.covariance.initial_parameters
    kb.residuals(x)                       # builds the library first
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        lmm_stochvol_kernel.LAUNCHES = black_residuals.LAUNCHES = 0
        with ThreadPoolExecutor(max_workers=8) as pool:
            futures = [pool.submit(kb.residuals, x) for _ in range(200)]
            results = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert lmm_stochvol_kernel.LAUNCHES == 200
    assert black_residuals.LAUNCHES == 200
    for r in results:
        np.testing.assert_array_equal(r, results[0])
