"""The program's spans (``finmath_tpu_torch.utils.profiling``): off, a
span site reads no clock, enters no profiler range, allocates nothing
and records nothing; on, spans nest by thread with their parent and root
ids, and each record holds the profiler's range of the same span (the
clock the device trace shares); the Levenberg-Marquardt counts
agree with the kernel backend's call spans on a small stoch-vol
calibration (the reduced 12-libor, 3-factor model of the stoch-vol
tests, 256 paths, the plain version of the kernel on the CPU); a pricer
call records its root and its inputs. The ``gpu`` test holds the
backend's and the pricers' parts on a card (no JAX; on a machine with
the card: ``python -m pytest tests/test_torch_profiling.py -m gpu
--noconftest``)."""

import threading
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models import curves  # noqa: E402
from finmath_tpu_torch.models import time_discretization as td_mod  # noqa: E402
from finmath_tpu_torch.models.calibration import LevenbergMarquardt  # noqa: E402
from finmath_tpu_torch.models.lmm import covariance as cov_mod  # noqa: E402
from finmath_tpu_torch.models.lmm import model as model_mod  # noqa: E402
from finmath_tpu_torch.models.lmm.kernel_backend import (  # noqa: E402
    StochVolKernelCalibration)
from finmath_tpu_torch.ops import lmm_kernel as k1  # noqa: E402
from finmath_tpu_torch.ops import lmm_stochvol_kernel as ksv  # noqa: E402
from finmath_tpu_torch.utils import profiling  # noqa: E402

N_LIBORS, FACTORS, PATHS = 12, 3, 256
GRID = ((2, 8, 0.0), (4, 4, 0.0), (6, 4, -0.005), (6, 6, 0.005))
X0 = np.asarray([0.20, 0.05, 0.10, 0.05, 0.10, 0.2, 0.25, 0.15])


@pytest.fixture
def ring():
    profiling.clear()
    yield
    profiling.clear()


def _by_name(records, name):
    return [r for r in records if r.name == name]


def test_off_path_touches_nothing(ring, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("called with tracing off")

    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(profiling, "time", SimpleNamespace(
        time_ns=forbidden, perf_counter=forbidden))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    a = profiling.span("finmath.test.a")
    assert a is profiling.span("finmath.test.b")     # one shared object
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with profiling.span("finmath.test.a") as s:
                s.set(calls=1)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__
             and d.size_diff > 0]
    assert grown == []
    assert profiling.spans() == []


def test_spans_nest_and_share_the_profilers_clock(ring):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("finmath.test.outer", sets=2) as outer:
                with profiling.span("finmath.test.inner"):
                    torch.ones(64).sum()
                outer.set(done=True)
    records = profiling.spans()
    outers = _by_name(records, "finmath.test.outer")
    inners = _by_name(records, "finmath.test.inner")
    assert len(outers) == len(inners) == 3
    for o, i in zip(outers, inners):
        assert o.parent == 0 and o.root == o.id
        assert i.parent == o.id and i.root == o.id
        assert o.attrs == {"sets": 2, "done": True}
        assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
        assert o.thread == i.thread == threading.get_ident()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("finmath.test."):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name, mine in (("finmath.test.outer", outers),
                       ("finmath.test.inner", inners)):
        theirs = sorted(ranges[name])
        assert len(theirs) == len(mine)
        for r, (a, b) in zip(sorted(mine, key=lambda r: r.start_ns), theirs):
            assert r.start_ns <= a <= b <= r.end_ns
            assert (a - r.start_ns) + (r.end_ns - b) < 1_000_000


def test_recording_is_per_context_and_threads_nest_apart(ring):
    def worker():
        with profiling.span("finmath.test.thread"):
            pass

    with profiling.recording():
        with profiling.span("finmath.test.main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    with profiling.span("finmath.test.after"):
        pass
    records = profiling.spans()
    assert [r.name for r in records] == ["finmath.test.thread",
                                         "finmath.test.main"]
    assert all(r.parent == 0 and r.root == r.id for r in records)
    profiling.clear()
    assert profiling.spans() == []


def _reduced_setup(device="cpu"):
    """The stoch-vol tests' benchmark-family model at 12 libors."""
    fix = np.arange(0.0, 10.5, 0.5)
    fc = curves.ForwardCurveFromForwards(fix, 0.02 + 0.002 * np.sin(fix), 0.5)
    dc = curves.DiscountCurveFromForwardCurve(fc, horizon=12.0)
    td = td_mod.TimeDiscretization(initial=0.0, num_steps=N_LIBORS, step=0.5)
    cov = cov_mod.LIBORCovarianceModelExponentialForm5Param(
        td, td, FACTORS, (0.20, 0.05, 0.10, 0.05, 0.10))
    cov = cov_mod.BlendedLocalVolatilityModel(cov, blend=0.2,
                                              is_calibrateable=True)
    cov = cov_mod.LIBORCovarianceModelStochasticVolatility(
        cov, nu=0.25, rho=0.15, is_calibrateable=True)
    model = model_mod.LIBORMarketModelTorch(
        td, fc, dc, cov, measure="spot", state_space="normal",
        use_numeraire_adjustment=False)
    tenor = model.tenor_times
    products = [model_mod.SwaptionProduct(
        exercise_index=e, num_periods=m,
        strike=dk + curves.par_swap_rate(fc, dc, tenor[e:e + m + 1]),
        target=0.30, weight=1.0, value_unit="VOLATILITYLOGNORMAL")
        for e, m, dk in GRID]
    rng = np.random.default_rng(5)
    inc = (np.sqrt(0.5) * rng.standard_normal(
        (N_LIBORS, FACTORS + 1, PATHS))).astype(np.float32)
    return model_mod.LMMValuationEngine(model, products, PATHS, FACTORS,
                                        device=device, increments=inc)


def test_lm_counts_match_the_backends_call_spans(ring):
    backend = StochVolKernelCalibration(_reduced_setup())
    lm = LevenbergMarquardt(backend.residuals, backend.jacobian,
                            max_iterations=3, lower_bound=-np.inf)
    with profiling.recording():
        result = lm.run(X0)
    records = profiling.spans()
    (run,) = _by_name(records, "finmath.lm.run")
    assert run.attrs == dict(residual_calls=result.residual_calls,
                             jacobian_calls=result.jacobian_calls,
                             rejected_steps=result.rejected_steps,
                             iterations=result.iterations)
    calls = _by_name(records, "finmath.backend.residuals")
    jacobians = _by_name(records, "finmath.backend.jacobian")
    assert result.residual_calls == len(calls) > 1
    assert result.jacobian_calls == len(jacobians) >= 1
    accepted = len(result.history) - 1
    assert result.rejected_steps == result.residual_calls - 1 - accepted
    assert result.rejected_steps > 0
    solves = _by_name(records, "finmath.lm.solve")
    assert len(solves) == result.residual_calls - 1
    assert all(r.root == run.id for r in records)
    assert all(r.parent == run.id for r in calls + jacobians + solves)
    assert {c.attrs["sets"] for c in calls} == {1}
    assert {j.attrs["sets"] for j in jacobians} == {2 * len(X0) + 1}
    # the CPU's plain version: pack, implied vol and reduce, no launch
    for call in calls + jacobians:
        parts = {r.name for r in records if r.parent == call.id}
        assert parts == {"finmath.backend.pack", "finmath.backend.reduce",
                         "finmath.backend.implied_vol"}


def _pricer_args():
    rng = np.random.default_rng(5)
    vol_table = (0.008 + 0.004 * rng.random((4, 8))).astype(np.float32)
    l0 = 0.02 + 0.002 * np.arange(8)
    return (7, 250, 8, 2, 5, 4, vol_table, l0, np.full(8, 0.5), 0.5, 0.025)


def test_a_pricer_call_records_its_root_and_inputs(ring):
    with profiling.recording():
        v = k1.lmm_swaption_kernel(*_pricer_args(), device="cpu")
    assert float(v) > 0
    records = profiling.spans()
    (root,) = _by_name(records, "finmath.pricer.price")
    (inputs,) = _by_name(records, "finmath.pricer.inputs")
    assert root.attrs == {"kernel": "lmm_swaption_paths", "paths": 250}
    assert root.parent == 0 and inputs.parent == root.id
    assert {r.name for r in records} == {"finmath.pricer.price",
                                         "finmath.pricer.inputs"}


@pytest.mark.gpu
def test_the_card_records_every_part(ring):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the launch and upload parts exist "
                    "only on the card")
    backend = StochVolKernelCalibration(_reduced_setup("cuda"))
    with profiling.recording():
        backend.residuals(X0)
        backend.jacobian(X0)
        args = list(_pricer_args())
        k1.lmm_swaption_kernel(*args, device="cuda")
        rng = np.random.default_rng(17)
        R = rng.standard_normal((8, 2))
        R /= np.linalg.norm(R, axis=1, keepdims=True)
        ksv.lmm_stochvol_swaption_kernel(
            7, 250, 8, 2, 2, 5, 4, 0.1 + 0.2 * rng.random((4, 8)), R,
            np.full(8, 0.024), np.full(8, 0.5), 0.5, 0.025, 0.7, 0.4, -0.3,
            device="cuda")
    records = profiling.spans()
    for name in ("finmath.backend.residuals", "finmath.backend.jacobian"):
        for call in _by_name(records, name):
            inner = {r.name for r in records
                     if r.root == call.id and r.id != call.id}
            assert inner == {"finmath.backend.pack", "finmath.backend.launch",
                             "finmath.backend.reduce",
                             "finmath.backend.implied_vol"}
    roots = _by_name(records, "finmath.pricer.price")
    assert [r.attrs["kernel"] for r in roots] == [
        "lmm_swaption_paths", "lmm_stochvol_swaption_paths"]
    for root in roots:
        assert {r.name for r in records if r.parent == root.id} == {
            "finmath.pricer.inputs", "finmath.pricer.upload",
            "finmath.pricer.launch"}
