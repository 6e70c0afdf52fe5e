"""One run of one cell: load the cell's files by name, set up, warm up,
measure, check the answers against the reference, and print the result.

Files, found from the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration; its ``system`` and its
  ``limits`` (one group per kind of traffic);
* ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
  the two files of code that drive it:
* ``loops/<kind>.py``: ``Loop(target, traffic, seed)``, the order of the
  requests, where a window may end, and the end-to-end quantities, and
* ``systems/<system>/<kind>.py``: ``Target(cfg, traffic, seed, device,
  recorder)``, the program's entry point fed the benchmark's inputs
  (``request``, ``shape``, ``close``) and ``check(records, rng,
  control)``, the numbers its answers read against the plain reference;
* ``metrics/<metric>.py``: ``read(ctx)``, one per per-layer metric;
* ``roofline/<kernel>.py``: the work of a kernel's launch, from shapes.

This file only times, traces, reads the metrics and compares the numbers
with the configuration's limits."""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import host
import spans
import trace as trace_mod
from seeds import CHECK, seed_words

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "finmath_tpu")


class RunError(RuntimeError):
    """A run that may print no result (exit code 2)."""


def load_module(path: Path):
    """A module of the benchmark loaded from its file by name."""
    if not path.is_file():
        raise RunError(f"no file {path}")
    name = "_".join(path.with_suffix("").parts[-3:])
    spec = importlib.util.spec_from_file_location(
        "portbench_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise RunError(f"no file {path}")
    return json.loads(path.read_text())


def resolve(spec: dict, workload: str, bench: Path = BENCH) -> SimpleNamespace:
    """The cell ``workload`` of ``spec`` with its configuration, traffic,
    the files of its loop and target, and the metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(bench.parent / config["file"])
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    kind = traffic["kind"]

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if applies(m) and m["moves"] in names]
    return SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic, kind=kind, end_to_end=e2e,
        per_layer=per_layer, limits=cfg["limits"][kind],
        loop=bench / "loops" / f"{kind}.py",
        target=bench / "systems" / cfg["system"] / f"{kind}.py",
        metric_files={m["name"]: bench / "metrics" / f"{m['name']}.py"
                      for m in per_layer})


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def window(loop, limit: float, watch=None) -> SimpleNamespace:
    """Requests back to back until ``limit`` seconds have passed and the
    loop lets the window end."""
    records, latencies = [], []
    with torch.profiler.record_function(trace_mod.WINDOW):
        t0 = time.perf_counter()
        k = 0
        while True:
            with torch.profiler.record_function("portbench.request"):
                ts = time.perf_counter()
                try:
                    records.append(loop.request(k))
                except (RuntimeError, ValueError, FloatingPointError) as exc:
                    print(f"request {k} failed: {exc!r}", file=sys.stderr)
                    records.append(dict(ok=False))
                te = time.perf_counter()
            latencies.append(te - ts)
            if watch is not None:
                watch.tick(te)
            done = te - t0 >= limit and loop.ends_window(k)
            k += 1
            if done:
                break
    return SimpleNamespace(records=records, latencies=latencies,
                           seconds=te - t0)


def judge(numbers: dict, limits: dict, failed: int):
    """``correct`` and each compared number beside its limit."""
    compared = {name: {"value": numbers.get(name), "limit": limits[name]}
                for name in limits}
    correct = bool(failed == 0 and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in compared.values()))
    return correct, compared


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device=None, traffic_overrides=None,
        control: bool = False, spec: dict = None) -> dict:
    """One run; returns the result line as a dict, ``checks`` (each
    compared number beside its limit) last. ``device`` skips the look for
    a card. ``control`` also judges the control in the program's place,
    under ``control`` (its ``correct`` and ``checks``). ``spec`` stands in
    for ``BENCHMARK.json``."""
    seed = int(seed) % (1 << 64)
    cell = resolve(spec or load_json(BENCH.parent / "BENCHMARK.json"),
                   workload)
    traffic = dict(cell.traffic, **(traffic_overrides or {}))
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell.cell["chips"]):
            raise RunError(f"{workload} needs {cell.cell['chips']} CUDA "
                           "device(s); this machine has "
                           f"{torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    rec = spans.Recorder()
    target = load_module(cell.target).Target(cell.cfg, traffic, seed,
                                             device, rec)
    loops = load_module(cell.loop)
    loop = loops.Loop(target, traffic, seed)
    for k in range(int(traffic["warmup_requests"])):
        loop.request(-1 - k)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    rec.reset()
    watch = host.HostWatch()
    watch.start()
    timed = window(loop, float(seconds), watch)
    watch.stop()
    measured = rec.snapshot()
    traced = prof = None
    if trace:
        # a second window under the profiler, for what only the device
        # trace shows; the spans and counters are the first window's
        from torch.profiler import ProfilerActivity, profile
        rec.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = window(loop, float(traffic["trace_seconds"]))
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of the JAX package loaded: {found}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    lat = timed.latencies
    print("request seconds: " + " ".join(f"{x:.4g}" for x in (
        lat if len(lat) <= 64 else np.quantile(lat, np.linspace(0, 1, 11)))),
        file=sys.stderr)
    for line in watch.lines():
        print(line, file=sys.stderr)
    records = timed.records + (traced.records if traced else [])
    failed = sum(1 for r in records if not r.get("ok"))
    result = {"correct": None, "attempted": len(records), "failed": failed}
    if not trace:
        e2e = loops.Loop.end_to_end(timed.seconds, lat)
        e2e["setup_s"] = (setup_s, "s")
        metrics = {m["name"]: {"value": e2e[m["name"]][0],
                               "unit": e2e[m["name"]][1]}
                   for m in cell.end_to_end}
    else:
        tr = trace_mod.read(prof)
        n = len(traced.latencies)
        print(f"traced window: {traced.seconds:.4g} s for {n} requests, "
              f"{traced.seconds / n:.4g} s each, against "
              f"{timed.seconds / len(lat):.4g} s untraced", file=sys.stderr)
        ctx = SimpleNamespace(
            kind=cell.kind, spans=measured, requests=len(lat),
            window_s=timed.seconds, traced=rec.snapshot(),
            traced_requests=n, trace=tr, shape=target.shape,
            peaks=load_json(BENCH / "peaks.json"), load_module=load_module,
            bench=BENCH)
        metrics = {}
        for m in cell.per_layer:
            value = load_module(cell.metric_files[m["name"]]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": int(cell.cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_by_range()}
        if device.type == "cuda":
            result["device"]["power"] = power_limit()
        del prof, tr

    # the program's state goes before the reference runs
    target.close()
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    answered = [r for r in records if r.get("ok")]

    def numbers(control_side: bool) -> dict:
        if not answered:
            return {}
        rng = np.random.default_rng(seed_words(seed)[CHECK])
        with torch.no_grad():
            return target.check(answered, rng, control=control_side)

    result["correct"], compared = judge(numbers(False), cell.limits, failed)
    if control:
        correct, checks = judge(numbers(True), cell.limits, failed)
        result["control"] = {"correct": correct, "checks": checks}
    result["checks"] = compared
    return result


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="print the control's judgement in the program's "
                         "place (its correct has to come out false)")
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=t_start,
                     control=bool(args.control))
    except RunError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    if args.control:
        for name, c in result["checks"].items():
            print(f"program {name}: {c['value']!r} (limit {c['limit']!r})",
                  file=sys.stderr)
        control = result.pop("control")
        result["correct"] = control["correct"]
        result["checks"] = control["checks"]
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of the JAX package loaded: {found}",
              file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
