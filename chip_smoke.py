"""Drive the PyTorch + CUDA port (finmath_tpu_torch) once on one NVIDIA GPU
and check what it computes.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --profile  # and phase 6, the device's busy share

Phases, one line of output each (more for the kernel build), in order:

1. the card: ``torch.cuda.get_device_name()`` and ``nvidia-smi``'s name
   and power limit (fails without a CUDA device);
2. build the ATM-surface kernel (``csrc/lmm_atm_products.cu``) from the
   sources and print the build seconds and ptxas' register report;
3. the kernel against its plain PyTorch version on the card at the ATM
   shapes: 100,000 paths B=1 NORMAL, 100,003 paths (ragged tail), and the
   FD-Jacobian batch B=87 at 8,192 paths DISPLACED; every row's path sum
   within rtol 1e-5, atol 1e-7 * paths, and a second launch bitwise equal;
4. the main path — the reference's ATM swaption calibration at 100,000
   paths with the 5,000-path engine Jacobian and kernel residuals, warmed
   up once, then timed; it must reach |mean_dev| < 2e-4 and rms_dev < 2e-4
   and go through the kernel (launch count > 0, one launch per residual
   call of the timed run); a second, instrumented run prints where the
   wall goes;
5. kernel against plain version time at the main path's shape (median of
   5 after a warm-up, CUDA events);
6. with ``--profile`` only: device operations and busy time under
   ``torch.profiler`` for one calibration, one engine Jacobian and one
   kernel residual call, against the same call's unprofiled wall.

Then one JSON line with the kernel's numbers and, last, the device line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before those two lines; there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PATHS, JAC_PATHS, SEED = 100_000, 5_000, 31415
RTOL, ATOL_PER_PATH = 1e-5, 1e-7


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


def _profile(torch, setup, kb) -> None:
    """Phase 6 (``--profile``): the device's busy share of one whole
    calibration and of one call of each device stage. Each is run once
    unprofiled (host wall, synchronised) and once under ``torch.profiler``;
    the device events of the profiled run (kernels, copies, memsets) give
    the device operation count and busy time, set against the unprofiled
    wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p0 = setup.covariance.initial_parameters
    runs = {
        "calibration": lambda: setup.calibrate(
            max_iterations=60, accuracy=1e-7, warm_start="analytic",
            residual_backend=kb),
        "engine jacobian (5k paths)": lambda: setup.jacobian_engine.jacobian(p0),
        "kernel residuals (100k paths)": lambda: kb.residuals(p0),
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
                                              build_atm_calibration)
    from finmath_tpu_torch.ops import _cuda_build, lmm_kernel

    # -- 2: build ---------------------------------------------------------
    t0 = time.perf_counter()
    lmm_kernel.load_kernel()
    build_s = time.perf_counter() - t0
    log = _cuda_build.library_path(lmm_kernel.SOURCE).with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {build_s:.3f} s ({lmm_kernel.SOURCE}); "
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
    lmm_kernel.LAUNCHES = 0
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
    print(f"phase 5 timing (median of 5, CUDA events): B=1 paths={PATHS} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"speedup={plain_ms / ms:.2f}x; kernel B={X.shape[0]} "
          f"paths={PATHS} ms={fd_ms:.4f}", flush=True)

    if opts.profile:
        _profile(torch, setup, kb)

    print(json.dumps({"kernels": [{
        "name": "lmm_atm_products",
        "route": "cuda",
        "source": "finmath_tpu_torch/csrc/lmm_atm_products.cu",
        "replaces": "finmath_tpu/ops/lmm_kernel.py:178",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
