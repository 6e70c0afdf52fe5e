"""Drive the PyTorch + CUDA port (finmath_tpu_torch) once on one NVIDIA GPU
and check what it computes.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --profile  # and phase 6, the device's busy share

Phases, one line of output each (more for the kernel builds), in order:

1. the card: ``torch.cuda.get_device_name()`` and ``nvidia-smi``'s name
   and power limit (fails without a CUDA device);
2. build both kernels from the sources, one ``nvcc`` each, started
   together: the ATM-surface kernel (``csrc/lmm_atm_products.cu``) and
   the stoch-vol kernel (``csrc/lmm_stochvol_products.cu``); print each
   build's seconds and ptxas' register/spill report;
3. the ATM kernel against its plain PyTorch version on the card at the ATM
   shapes: 100,000 paths B=1 NORMAL, 100,003 paths (ragged tail), and the
   FD-Jacobian batch B=87 at 8,192 paths DISPLACED; every row's path sum
   within rtol 1e-5, atol 1e-7 * paths, and a second launch bitwise equal;
4. slice A's main path — the reference's ATM swaption calibration at
   100,000 paths with the 5,000-path engine Jacobian and kernel residuals,
   warmed up once, then timed; it must reach |mean_dev| < 2e-4 and
   rms_dev < 2e-4 and go through the kernel (launch count > 0, one launch
   per residual call of the timed run); a second, instrumented run prints
   where the wall goes;
5. ATM kernel against plain version time at the main path's shape
   (median of 5 after a warm-up, CUDA events);
7. the stoch-vol kernel against its plain version on the card, on the
   benchmark setup at its initial parameters and the reference's Mersenne
   realization: 81,920 paths at B=1 and the FD-Jacobian batch B=17 (the
   main path's two launch shapes), 81,923 paths (ragged tail), and B=17 at
   8,192 paths; the same bounds and the same bitwise repeat as phase 3;
   then the kernel-vs-engine residual gap at the first curated basin
   (fails above 5e-3 vol);
8. slice B's main path — the reference's stoch-vol benchmark calibration
   (LIBORMarketModelCalibrationTest) at 81,920 paths on its Mersenne
   realization, every program warmed up, then
   ``calibrate_multistart(target_rms19=0.00198, kernel_backend=...)``
   timed; it must go through the kernel (launches = backend residual +
   Jacobian calls), give 15 finite deviations with |mean| < 1e-2 (the
   reference test's assert), an engine-oracle rms19 < 0.25%, and kernel
   residuals within 5e-5 of the engine's at the initial point; its
   ``stages`` dict splits the wall by stage, and the calls of each kind
   (kernel, reduced-path engine, oracle, analytic) are counted and timed;
9. stoch-vol kernel against plain version time at B=1 and B=17, 81,920
   paths (median of 5, CUDA events);
6. with ``--profile`` only, last: device operations and busy time under
   ``torch.profiler`` for one ATM calibration, one engine Jacobian, one
   ATM kernel residual call, one stoch-vol kernel
   ``residuals_and_jacobian`` call and one reduced-path stoch-vol engine
   Jacobian, against the same call's unprofiled wall.

Then the whole script's seconds, one JSON line with both kernels' numbers
(``bound_ms`` is the least time of the same work on an H100: the larger
of the operations counted from the shapes over 67 TFLOP/s float32 and the
bytes over 3.35 TB/s) and, last, the device line ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero before those
lines; there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PATHS, JAC_PATHS, SEED = 100_000, 5_000, 31415
SV_PATHS, SV_SEED, SV_TARGET_RMS19 = 81_920, 314151, 0.00198
RTOL, ATOL_PER_PATH = 1e-5, 1e-7
# the published H100 SXM peaks the bound is taken against
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12


def _sweep_operations(num_libors, num_factors, products, paths, B, *,
                      stoch_vol, displaced=False):
    """Float32 operations of one LMM path sweep as the kernels do it (an
    FMA counted as two), from the shapes: per step and alive libor the
    drift term (3), the update and clamp (5) and per factor the loading
    and three running sums (6, +1 with a local factor); the local factor
    itself (displaced 1, blended times sqrt(V) 4); per step the normals'
    scaling, the numeraire (3) and for stoch vol exp(log V / 2) and the
    log V step (10); per exercise step the running bond product (6 a
    period) and per product the payoff, its masking and its path sum
    (7), plus the ATM kernel's numeraire-adjustment row (2)."""
    n, F = num_libors, num_factors
    S = products[-1][0]
    local = 4 if stoch_vol else (1 if displaced else 0)
    per_libor = 8 + local + F * (6 + int(stoch_vol or displaced))
    per_step = F + 3 + (10 if stoch_vol else 0)
    ops = sum(per_step + (n - 1 - s) * per_libor for s in range(S))
    by_step = {}
    for e, m, _ in products:
        by_step.setdefault(e, []).append(m)
    for ms in by_step.values():
        ops += 6 * max(ms) + 7 * len(ms) + (0 if stoch_vol else 2)
    return ops * paths * B


def _bound(args, out, operations):
    """(bound_ms, bound_by): the larger of the operations over the float32
    peak and the bytes (each input tensor read once, the output written
    once) over the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        out.numel() * out.element_size()
    by_ops = operations / PEAK_F32_FLOPS
    by_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def _time_ms(torch, fn, reps=5):
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


class _Counted:
    """Counts the calls of a function, and adds nothing else to them."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


class _Timed:
    """Counts the calls of a function and their host seconds (synchronised),
    for the breakdown of the calibration wall."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls, self.seconds = torch, fn, 0, 0.0

    def __call__(self, *args):
        t0 = time.perf_counter()
        out = self.fn(*args)
        self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def _profile(torch, setup, kb, sv, sv_kb) -> None:
    """Phase 6 (``--profile``): the device's busy share of one whole ATM
    calibration, of one call of each of its device stages, of one
    stoch-vol kernel ``residuals_and_jacobian`` call and of one call of
    the stoch-vol multistart's dominant stage, the reduced-path engine
    Jacobian. Each is run once unprofiled (host wall, synchronised) and
    once under ``torch.profiler``; the device events of the profiled run
    (kernels, copies, memsets) give the device operation count and busy
    time, set against the unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p0 = setup.covariance.initial_parameters
    sv_p0 = sv.covariance.initial_parameters
    sweep = sv.sweep_engine()
    runs = {
        "calibration": lambda: setup.calibrate(
            max_iterations=60, accuracy=1e-7, warm_start="analytic",
            residual_backend=kb),
        "engine jacobian (5k paths)": lambda: setup.jacobian_engine.jacobian(p0),
        "kernel residuals (100k paths)": lambda: kb.residuals(p0),
        "stoch-vol kernel residuals_and_jacobian (81,920 paths)":
            lambda: sv_kb.residuals_and_jacobian(sv_p0),
        f"stoch-vol engine jacobian ({sweep.num_paths:,} paths)":
            lambda: sweep.jacobian(sv_p0),
    }
    out = {}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
        out[name] = {"unprofiled_wall_ms": wall_ms, "device_ops": len(device),
                     "device_busy_ms": busy_ms,
                     "busy_share": busy_ms / wall_ms}
    print("phase 6 profile: " + json.dumps(out), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 6: the device's busy share of the "
                             "calibration under torch.profiler")
    opts = parser.parse_args(argv)
    t_script = time.perf_counter()
    import torch

    # -- 1: the card ------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    sys.path.insert(0, REPO)
    from finmath_tpu_torch.models.lmm import (ATMKernelCalibration,
                                              StochVolKernelCalibration,
                                              build_atm_calibration,
                                              build_benchmark_calibration)
    from finmath_tpu_torch.models.lmm.benchmark_calibration import (
        CURATED_BASINS)
    from finmath_tpu_torch.native import host_rng
    from finmath_tpu_torch.ops import (_cuda_build, lmm_kernel,
                                       lmm_stochvol_kernel)

    # -- 2: build both kernels, one nvcc each, started together ----------
    def build(module):
        t0 = time.perf_counter()
        module.load_kernel()
        return time.perf_counter() - t0

    kernel_modules = (lmm_kernel, lmm_stochvol_kernel)
    with ThreadPoolExecutor(len(kernel_modules)) as pool:
        build_s = list(pool.map(build, kernel_modules))
    for module, seconds in zip(kernel_modules, build_s):
        log = _cuda_build.library_path(module.SOURCE).with_suffix(".log")
        ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"phase 2 build: {seconds:.3f} s ({module.SOURCE}); "
              + " | ".join(ptxas), flush=True)

    # -- 3: kernel against plain version on the card ----------------------
    max_abs_err = 0.0
    cases = (("a", PATHS, "NORMAL", False), ("b", PATHS + 3, "NORMAL", False),
             ("c", 8_192, "DISPLACED", True))
    for label, paths, model_type, fd_batch in cases:
        setup = build_atm_calibration(num_paths=paths, num_factors=1,
                                      seed=SEED, model_type=model_type,
                                      device="cuda")
        kb = ATMKernelCalibration(setup.engine)
        x = kb.params(setup.covariance.initial_parameters)
        X = kb.fd_parameter_sets(x)[0] if fd_batch else x[None, :]
        args, kwargs = kb.kernel_arguments(X)
        got = lmm_kernel.lmm_atm_swaptions_batch(*args, **kwargs)
        again = lmm_kernel.lmm_atm_swaptions_batch(*args, **kwargs)
        torch.cuda.synchronize()
        ref = lmm_kernel.lmm_atm_swaptions_batch_reference(*args, **kwargs)
        err = (got - ref).abs()
        bound = RTOL * ref.abs() + ATOL_PER_PATH * paths
        repeatable = bool(torch.equal(got, again))
        ok = (bool(torch.isfinite(got).all()) and bool((err <= bound).all())
              and repeatable)
        max_abs_err = max(max_abs_err, float(err.max()))
        print(f"phase 3{label} kernel vs plain: paths={paths} "
              f"B={X.shape[0]} {model_type} rows={got.shape[1]} "
              f"max_abs_err={float(err.max()):.3e} "
              f"max_rel_err={float((err / ref.abs()).max()):.3e} "
              f"bitwise repeatable={repeatable} "
              f"within rtol={RTOL}, atol={ATOL_PER_PATH}*paths: {ok}",
              flush=True)
        if not ok:
            raise SystemExit(f"chip_smoke: phase 3{label}: kernel disagrees "
                             "with its plain version")
        del setup, kb, args, got, ref

    # -- 4: the main path --------------------------------------------------
    t0 = time.perf_counter()
    setup = build_atm_calibration(num_paths=PATHS, num_factors=1, seed=SEED,
                                  jacobian_paths=JAC_PATHS, device="cuda")
    kb = ATMKernelCalibration(setup.engine)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    p0 = setup.covariance.initial_parameters
    t0 = time.perf_counter()
    kb.residuals(p0)
    setup.engine.implied_vols(p0)
    setup.jacobian_engine.jacobian(p0)
    # the analytic warm-start engine is built lazily: build and warm it here
    # too, so the timed region is the calibration procedure alone
    setup.analytic_engine.residuals(p0)
    setup.analytic_engine.jacobian(p0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # count the calibration's residual calls: each must be one kernel launch
    residual_calls = _Counted(kb.residuals)
    kb.residuals = residual_calls
    lmm_kernel.LAUNCHES = lmm_stochvol_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    result = setup.calibrate(max_iterations=60, accuracy=1e-7,
                             warm_start="analytic", residual_backend=kb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lmm_kernel.LAUNCHES
    del kb.residuals
    dev = setup.deviations(result.parameters)
    mean_dev = float(np.mean(dev))
    rms_dev = float(np.sqrt(np.mean(dev ** 2)))
    r_kernel = kb.residuals(result.parameters)
    r_engine = setup.engine.residuals(result.parameters)
    kernel_vs_engine = float(np.abs(r_kernel - r_engine).max())
    on_cuda = (setup.engine.increments.is_cuda
               and all(t.is_cuda for t in kb.kernel_arguments(
                   kb.params(p0)[None, :])[0]))
    print(f"phase 4 calibration: paths={PATHS} jacobian_paths={JAC_PATHS} "
          f"products={len(setup.engine.products)} "
          f"parameters={setup.covariance.n_params} "
          f"iterations={result.iterations} rms_error={result.rms_error:.6e} "
          f"mean_dev={mean_dev:.6e} rms_dev={rms_dev:.6e} wall_s={wall:.4f} "
          f"setup_s={setup_s:.3f} warmup_s={warm_s:.3f} "
          f"kernel_launches={launches} "
          f"residual_calls={residual_calls.calls} "
          f"kernel_vs_engine_residuals={kernel_vs_engine:.3e} "
          f"on_cuda={on_cuda}", flush=True)
    checks = {
        "kernel launched": launches > 0,
        "one launch per residual call": launches == residual_calls.calls,
        "realization and kernel inputs on cuda": on_cuda,
        "deviations finite, one per product": bool(
            np.all(np.isfinite(dev)) and dev.shape == (144,)),
        "|mean_dev| < 2e-4": abs(mean_dev) < 2e-4,
        "rms_dev < 2e-4": rms_dev < 2e-4,
        "kernel residuals within 5e-5 of the engine's": kernel_vs_engine < 5e-5,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 4 failed: {failed}")

    # where the calibration wall goes: the same procedure once more, with
    # each stage's calls counted and timed (host clock, synchronised)
    stages = {"analytic residuals": (setup.analytic_engine, "residuals"),
              "analytic jacobian": (setup.analytic_engine, "jacobian"),
              "engine jacobian (5k paths)": (setup.jacobian_engine, "jacobian"),
              "kernel residuals (100k paths)": (kb, "residuals")}
    timers = {}
    for name, (obj, attr) in stages.items():
        timers[name] = _Timed(torch, getattr(obj, attr))
        setattr(obj, attr, timers[name])
    t0 = time.perf_counter()
    setup.calibrate(max_iterations=60, accuracy=1e-7, warm_start="analytic",
                    residual_backend=kb)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    for name, (obj, attr) in stages.items():
        delattr(obj, attr)
    print("phase 4 breakdown: " + json.dumps(
        {"wall_s": round(wall2, 4), **{
            name: {"calls": t.calls, "s": round(t.seconds, 4)}
            for name, t in timers.items()}}), flush=True)

    # -- 5: kernel against plain version, main path's shape ---------------
    args, kwargs = kb.kernel_arguments(kb.params(result.parameters)[None, :])
    ms = _time_ms(torch, lambda: lmm_kernel.lmm_atm_swaptions_batch(
        *args, **kwargs))
    plain_ms = _time_ms(torch, lambda: lmm_kernel.lmm_atm_swaptions_batch_reference(
        *args, **kwargs))
    X = kb.fd_parameter_sets(kb.params(result.parameters))[0]
    fd_args, fd_kwargs = kb.kernel_arguments(X)
    fd_ms = _time_ms(torch, lambda: lmm_kernel.lmm_atm_swaptions_batch(
        *fd_args, **fd_kwargs))
    atm_ops = dict(num_libors=kwargs["num_libors"],
                   num_factors=kwargs["num_factors"],
                   products=kwargs["products"], paths=PATHS, stoch_vol=False,
                   displaced=kwargs["displaced"])
    bound_ms, bound_by = _bound(
        args, lmm_kernel.lmm_atm_swaptions_batch(*args, **kwargs),
        _sweep_operations(B=1, **atm_ops))
    fd_bound_ms, _ = _bound(
        fd_args, lmm_kernel.lmm_atm_swaptions_batch(*fd_args, **fd_kwargs),
        _sweep_operations(B=X.shape[0], **atm_ops))
    print(f"phase 5 timing (median of 5, CUDA events): B=1 paths={PATHS} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"speedup={plain_ms / ms:.2f}x bound_ms={bound_ms:.4f} "
          f"({bound_by}); kernel B={X.shape[0]} paths={PATHS} "
          f"ms={fd_ms:.4f} bound_ms={fd_bound_ms:.4f}", flush=True)
    atm_row = {
        "name": "lmm_atm_products",
        "route": "cuda",
        "source": "finmath_tpu_torch/csrc/lmm_atm_products.cu",
        "replaces": "finmath_tpu/ops/lmm_kernel.py:178",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    del args, fd_args

    # -- 7: stoch-vol kernel against plain version on the card ------------
    sv_max_abs_err = 0.0
    # (paths, [(label, FD batch?)]): one setup per path count; 7b is the
    # main path's FD-Jacobian launch, B=17 at the full path count
    for paths, cases in ((SV_PATHS, (("a", False), ("b", True))),
                         (SV_PATHS + 3, (("c", False),)),
                         (8_192, (("d", True),))):
        sv = build_benchmark_calibration(num_paths=paths, seed=SV_SEED,
                                         brownian="finmath_mersenne",
                                         device="cuda")
        sv_kb = StochVolKernelCalibration(sv.engine)
        x = sv_kb.params(sv.covariance.initial_parameters)
        for label, fd_batch in cases:
            X = sv_kb.fd_parameter_sets(x)[0] if fd_batch else x[None, :]
            args, kwargs = sv_kb.kernel_arguments(X)
            run = lmm_stochvol_kernel.lmm_stochvol_swaptions_batch
            got = run(*args, **kwargs)
            again = run(*args, **kwargs)
            torch.cuda.synchronize()
            ref = lmm_stochvol_kernel.lmm_stochvol_swaptions_batch_reference(
                *args, **kwargs)
            err = (got - ref).abs()
            bound = RTOL * ref.abs() + ATOL_PER_PATH * paths
            repeatable = bool(torch.equal(got, again))
            ok = (bool(torch.isfinite(got).all())
                  and bool((err <= bound).all()) and repeatable)
            sv_max_abs_err = max(sv_max_abs_err, float(err.max()))
            print(f"phase 7{label} stoch-vol kernel vs plain: paths={paths} "
                  f"B={X.shape[0]} rows={got.shape[1]} "
                  f"max_abs_err={float(err.max()):.3e} "
                  f"max_rel_err={float((err / ref.abs()).max()):.3e} "
                  f"bitwise repeatable={repeatable} "
                  f"within rtol={RTOL}, atol={ATOL_PER_PATH}*paths: {ok}",
                  flush=True)
            if not ok:
                raise SystemExit(f"chip_smoke: phase 7{label}: stoch-vol "
                                 "kernel disagrees with its plain version")
            del args, got, again, ref
        if paths == SV_PATHS:
            basin = CURATED_BASINS[0]
            basin_gap = float(np.abs(sv_kb.residuals(basin)
                                     - sv.engine.residuals(basin)).max())
            print(f"phase 7a curated basin 0: kernel vs engine residuals "
                  f"max gap {basin_gap:.3e} (limit 5e-3)", flush=True)
            if not basin_gap <= 5e-3:
                raise SystemExit("chip_smoke: phase 7a: kernel and engine "
                                 "disagree at the curated basin")
        del sv, sv_kb

    # -- 8: slice B's main path, the stoch-vol benchmark calibration -------
    t0 = time.perf_counter()
    sv = build_benchmark_calibration(num_paths=SV_PATHS, seed=SV_SEED,
                                     brownian="finmath_mersenne",
                                     device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if not host_rng.native_available():
        raise SystemExit("chip_smoke: phase 8: the native host RNG did not "
                         "build")
    sv_kb = StochVolKernelCalibration(sv.engine)
    sv_p0 = sv.covariance.initial_parameters
    sweep = sv.sweep_engine()
    analytic = sv.analytic_engine()
    t0 = time.perf_counter()
    for warm in (lambda: sv_kb.residuals(sv_p0),
                 lambda: sv_kb.residuals_and_jacobian(sv_p0),
                 lambda: sv.engine.values(sv_p0),
                 lambda: sv.engine.implied_vols(sv_p0),
                 lambda: sweep.residuals(sv_p0),
                 lambda: sweep.jacobian(sv_p0),
                 lambda: analytic.residuals(sv_p0),
                 lambda: analytic.jacobian(sv_p0)):
        warm()
    torch.cuda.synchronize()
    sv_warm_s = time.perf_counter() - t0
    # count and time the calls of each stage: each backend residual and
    # each backend Jacobian call must be one kernel launch. Every call
    # returns NumPy, so it has synchronised anyway and the timers add
    # nothing to the wall.
    sv_stages = {
        "kernel residuals (81,920 paths)": (sv_kb, "residuals"),
        "kernel FD jacobian (81,920 paths)": (sv_kb, "jacobian"),
        f"engine residuals ({sweep.num_paths:,} paths)": (sweep, "residuals"),
        f"engine jacobian ({sweep.num_paths:,} paths)": (sweep, "jacobian"),
        "engine oracle implied vols (81,920 paths)": (sv.engine,
                                                      "implied_vols"),
        "analytic residuals": (analytic, "residuals"),
        "analytic jacobian": (analytic, "jacobian"),
    }
    sv_timers = {}
    for name, (obj, attr) in sv_stages.items():
        sv_timers[name] = _Timed(torch, getattr(obj, attr))
        setattr(obj, attr, sv_timers[name])
    lmm_kernel.LAUNCHES = lmm_stochvol_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    sv_result = sv.calibrate_multistart(target_rms19=SV_TARGET_RMS19,
                                        kernel_backend=sv_kb)
    torch.cuda.synchronize()
    sv_wall = time.perf_counter() - t0
    sv_launches = lmm_stochvol_kernel.LAUNCHES
    for obj, attr in sv_stages.values():
        delattr(obj, attr)
    sv_res_calls = sv_timers["kernel residuals (81,920 paths)"]
    sv_jac_calls = sv_timers["kernel FD jacobian (81,920 paths)"]
    sv_dev = sv.deviations(sv_result.parameters)
    sv_mean_dev = float(np.mean(sv_dev))
    rms19 = float(np.sqrt(np.sum(sv_dev ** 2) / 19.0))
    sv_gap = float(np.abs(sv_kb.residuals(sv_p0)
                          - sv.engine.residuals(sv_p0)).max())
    sv_on_cuda = (sv.engine.increments.is_cuda
                  and all(t.is_cuda for t in sv_kb.kernel_arguments(
                      sv_kb.params(sv_p0)[None, :])[0]))
    backend_calls = sv_res_calls.calls + sv_jac_calls.calls
    print(f"phase 8 stoch-vol calibration: paths={SV_PATHS} "
          f"products={len(sv.engine.products)} "
          f"parameters={sv.covariance.n_params} "
          f"mersenne_generation_s={gen_s:.3f} warmup_s={sv_warm_s:.3f} "
          f"wall_s={sv_wall:.4f} evaluations={sv_result.iterations} "
          f"rms19={rms19:.6e} rms15={sv_result.rms_error:.6e} "
          f"mean_dev={sv_mean_dev:.6e} kernel_launches={sv_launches} "
          f"backend_residual_calls={sv_res_calls.calls} "
          f"backend_jacobian_calls={sv_jac_calls.calls} "
          f"kernel_vs_engine_residuals_p0={sv_gap:.3e} "
          f"on_cuda={sv_on_cuda}", flush=True)
    print("phase 8 stages: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in sv_result.stages.items()}), flush=True)
    print("phase 8 breakdown: " + json.dumps(
        {"wall_s": round(sv_wall, 4), **{
            name: {"calls": t.calls, "s": round(t.seconds, 4)}
            for name, t in sv_timers.items()}}), flush=True)
    print("phase 8 result: " + json.dumps({
        "parameters": [float(v) for v in sv_result.parameters],
        "deviations": [float(v) for v in sv_dev],
        "history_rms": [round(float(h), 6) for h in sv_result.history]}),
        flush=True)
    checks = {
        "kernel launched": sv_launches > 0,
        "launches == backend residual + jacobian calls":
            sv_launches == backend_calls,
        "realization and kernel inputs on cuda": sv_on_cuda,
        "15 finite deviations": bool(
            np.all(np.isfinite(sv_dev)) and sv_dev.shape == (15,)),
        "|mean_dev| < 1e-2": abs(sv_mean_dev) < 1e-2,
        "rms19 < 0.25%": rms19 < 0.0025,
        "kernel residuals within 5e-5 of the engine's at p0": sv_gap < 5e-5,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: phase 8 failed: {failed}")

    # -- 9: stoch-vol kernel against plain version, main path's shapes -----
    x = sv_kb.params(sv_result.parameters)
    sv_args, sv_kwargs = sv_kb.kernel_arguments(x[None, :])
    sv_fd_args, sv_fd_kwargs = sv_kb.kernel_arguments(
        sv_kb.fd_parameter_sets(x)[0])
    run = lmm_stochvol_kernel.lmm_stochvol_swaptions_batch
    plain = lmm_stochvol_kernel.lmm_stochvol_swaptions_batch_reference
    sv_ms = _time_ms(torch, lambda: run(*sv_args, **sv_kwargs))
    sv_plain_ms = _time_ms(torch, lambda: plain(*sv_args, **sv_kwargs))
    sv_fd_ms = _time_ms(torch, lambda: run(*sv_fd_args, **sv_fd_kwargs))
    sv_fd_plain_ms = _time_ms(torch, lambda: plain(*sv_fd_args,
                                                   **sv_fd_kwargs))
    B_fd = sv_fd_args[1].shape[0]
    sv_ops = dict(num_libors=sv_kwargs["num_libors"],
                  num_factors=sv_kwargs["num_factors"],
                  products=sv_kwargs["products"], paths=SV_PATHS,
                  stoch_vol=True)
    sv_bound_ms, sv_bound_by = _bound(
        sv_args, run(*sv_args, **sv_kwargs), _sweep_operations(B=1, **sv_ops))
    sv_fd_bound_ms, sv_fd_bound_by = _bound(
        sv_fd_args, run(*sv_fd_args, **sv_fd_kwargs),
        _sweep_operations(B=B_fd, **sv_ops))
    print(f"phase 9 timing (median of 5, CUDA events): paths={SV_PATHS} "
          f"B=1 kernel_ms={sv_ms:.4f} plain_ms={sv_plain_ms:.4f} "
          f"bound_ms={sv_bound_ms:.4f} ({sv_bound_by}); B={B_fd} "
          f"kernel_ms={sv_fd_ms:.4f} plain_ms={sv_fd_plain_ms:.4f} "
          f"bound_ms={sv_fd_bound_ms:.4f} ({sv_fd_bound_by})", flush=True)

    if opts.profile:
        _profile(torch, setup, kb, sv, sv_kb)

    print(f"chip_smoke seconds: {time.perf_counter() - t_script:.1f}",
          flush=True)
    print(json.dumps({"kernels": [atm_row, {
        "name": "lmm_stochvol_products",
        "route": "cuda",
        "source": "finmath_tpu_torch/csrc/lmm_stochvol_products.cu",
        "replaces": "finmath_tpu/ops/lmm_stochvol_kernel.py:192",
        "launches": sv_launches,
        "max_abs_err": sv_max_abs_err,
        "ms": sv_ms,
        "plain_ms": sv_plain_ms,
        "bound_ms": sv_bound_ms,
        "bound_by": sv_bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
