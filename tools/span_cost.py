"""What the program's spans (``finmath_tpu_torch.utils.profiling``) cost
and show, on a card.

    python3 tools/span_cost.py probe
    python3 tools/span_cost.py pairs --workload CELL --seeds 1,2 \
        --seconds 20
    python3 tools/span_cost.py traced --workload CELL --seed 3 --seconds 20

Run from the repository root on a machine with a CUDA device (``probe``
runs on the CPU too, for a rehearsal; its numbers then are the CPU's).

``probe``: (1) the clock: under ``torch.profiler`` with CPU and CUDA
activities, each span record's interval against the profiler's range of
the same span (it has to hold it, and exceed it by under 1 ms); (2) no
device copy: the device events named like a span (a
``record_function`` range has such a copy, ``gpu_user_annotation``; a
span must not); (3) the cost of one span site in ns, off (no profiler,
no ``recording()``), under ``recording()`` and under the profiler, from
loops of empty ``with`` bodies less the empty loop.

``pairs``: the benchmark's runs of one cell (``portbench/harness.py``,
in this process), with ``recording()`` off and on in turns for each
seed (off, on for the first seed, on, off for the next, ...), printing
each run's end-to-end metrics, and for each run with recording the
host self time per request of each span name over its measured window.

``traced``: one ``--trace 1`` run of the cell: its result line, the same
self times over its traced window, the share of the idle that the
benchmark's own range of the layer holds in the trace's ``idle_gaps``
which the layer's idle metrics cover, and the residual calls of the
program's ``finmath.lm.run`` spans against ``lm_residual_calls``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.getcwd()


def _self_times(records, lo, hi):
    """Host self ns by span name over the records inside [lo, hi], and
    the number of root spans there."""
    inside = [r for r in records if lo <= r.start_ns and r.end_ns <= hi]
    child = defaultdict(int)
    for r in inside:
        if r.parent:
            child[r.parent] += r.end_ns - r.start_ns
    out = defaultdict(int)
    for r in inside:
        out[r.name] += r.end_ns - r.start_ns - child[r.id]
    return dict(out), sum(1 for r in inside if not r.parent)


def probe() -> int:
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from finmath_tpu_torch.utils import profiling

    card = torch.cuda.is_available()
    dev = torch.device("cuda" if card else "cpu")
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * card
    print("device:", torch.cuda.get_device_name(dev) if card else "cpu")
    x = torch.ones(1 << 20, device=dev)
    profiling.clear()
    with profile(activities=activities) as prof:
        for _ in range(20):
            with profiling.span("finmath.probe.outer"):
                with profiling.span("finmath.probe.inner"):
                    (x * 2.0).sum().item()
            with record_function("finmath.probe.record_function"):
                (x + 1.0).sum().item()
    host, device = defaultdict(list), defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        if not e.name().startswith("finmath.probe"):
            continue
        if "CUDA" in str(e.device_type()):
            device[e.name()] += 1
        else:
            host[e.name()].append((e.start_ns(),
                                   e.start_ns() + e.duration_ns()))
    records = [r for r in profiling.spans()
               if r.name.startswith("finmath.probe")]
    worst_in, worst_out, held = 0, 0, True
    for name in ("finmath.probe.outer", "finmath.probe.inner"):
        mine = sorted((r.start_ns, r.end_ns) for r in records
                      if r.name == name)
        theirs = sorted(host[name])
        if len(mine) != len(theirs):
            print(f"clock: {name}: {len(mine)} records, {len(theirs)} "
                  "profiler ranges")
            held = False
            continue
        for (a, b), (c, d) in zip(mine, theirs):
            held &= a <= c and d <= b
            worst_in = max(worst_in, c - a, b - d)
            worst_out = max(worst_out, a - c, d - b)
    print(f"clock: every record holds its profiler range: {held}; the "
          f"most a record exceeds its range at one end: {worst_in} ns; "
          f"the most a range exceeds its record: {worst_out} ns")
    print(f"device events named like the probe's ranges: {dict(device)}")

    n = 1_000_000

    def sites(k):
        t = time.perf_counter_ns()
        for _ in range(k):
            with profiling.span("finmath.probe.site"):
                pass
        return time.perf_counter_ns() - t

    def sites_attrs(k):
        t = time.perf_counter_ns()
        for _ in range(k):
            with profiling.span("finmath.probe.site", sets=17):
                pass
        return time.perf_counter_ns() - t

    def empty(k):
        t = time.perf_counter_ns()
        for _ in range(k):
            pass
        return time.perf_counter_ns() - t

    def best(fn, k, reps=5):
        return min(fn(k) for _ in range(reps)) / k

    base = best(empty, n)
    print(f"off: {best(sites, n) - base:.1f} ns a site, "
          f"{best(sites_attrs, n) - base:.1f} ns with one attribute "
          f"(empty loop {base:.1f} ns a pass)")
    with profiling.recording():
        on = best(sites, 100_000) - base
    profiling.clear()
    with profile(activities=activities):
        traced = best(sites, 20_000, reps=3) - base
    profiling.clear()
    print(f"on: {on:.1f} ns a site under recording(), {traced:.1f} ns "
          "under the profiler")
    return 0


def runs(args) -> int:
    sys.path[:0] = [os.path.join(ROOT, "portbench"), ROOT]
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                 "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"
    import harness

    from finmath_tpu_torch.utils import profiling

    windows = []
    real_window = harness.window

    def window(loop, limit, watch=None):
        lo = time.time_ns()
        out = real_window(loop, limit, watch)
        windows.append((lo, time.time_ns(), len(out.latencies)))
        return out
    harness.window = window
    traces = []
    real_read = harness.trace_mod.read

    def read(prof):
        traces.append(real_read(prof))
        return traces[-1]
    harness.trace_mod.read = read

    def one(seed, record, trace=False):
        windows.clear()
        profiling.clear()
        t0 = time.perf_counter()
        if record:
            with profiling.recording():
                r = harness.run(args.workload, seed, args.seconds, trace,
                                t_start=t0)
        else:
            r = harness.run(args.workload, seed, args.seconds, trace,
                            t_start=t0)
        return r, list(windows), profiling.spans()

    def show_self(tag, records, lo, hi, n):
        self_ns, roots = _self_times(records, lo, hi)
        parts = " ".join(f"{k}={v / n / 1e3:.1f}" for k, v in
                         sorted(self_ns.items(), key=lambda t: -t[1]))
        print(f"{tag} self us per request ({n} requests, {roots} roots): "
              f"{parts}")

    if args.mode == "pairs":
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            order = (False, True) if i % 2 == 0 else (True, False)
            for record in order:
                r, win, records = one(seed, record)
                e2e = {k: v["value"] for k, v in r["metrics"].items()}
                print(json.dumps({"seed": seed, "recording": record,
                                  "correct": r["correct"], "metrics": e2e}),
                      flush=True)
                if record:
                    lo, hi, n = win[0]
                    show_self("measured window", records, lo, hi, n)
        return 0
    r, win, records = one(args.seed, False, trace=True)
    print(json.dumps(r), flush=True)
    lo, hi, n = win[-1]
    show_self("traced window", records, lo, hi, n)
    import program_spans
    trace = traces[-1]
    lo, hi = trace.window
    gaps = program_spans.idle_gaps(trace)
    inside = [s for s in records if lo <= s.start_ns and s.end_ns <= hi]
    by = program_spans.attribute(gaps, inside)
    idle = sum(b - a for a, b in gaps)
    parts = " ".join(f"{k}={v / n / 1e3:.1f}" for k, v in
                     sorted(by.items(), key=lambda t: -t[1]))
    print(f"traced window idle us per request by innermost program span: "
          f"{parts}; outside every program span "
          f"{(idle - sum(by.values())) / n / 1e3:.1f}; all "
          f"{idle / n / 1e3:.1f}")
    metrics = {k: v["value"] for k, v in r["metrics"].items()}
    gaps = dict(r["breakdown"]["idle_gaps"])
    for prefix, layer, scale in (("backend_idle_ms.", "portbench.kernel_backend",
                                  1e-3),
                                 ("pricer_idle_us.", "portbench.pricer", 1e-6)):
        mine = [v for k, v in metrics.items() if k.startswith(prefix)]
        if mine and layer in gaps:
            total = sum(mine) * scale * n
            print(f"coverage: {prefix}* {total:.6f} s of {gaps[layer]:.6f} s "
                  f"idle under {layer} ({100 * total / gaps[layer]:.2f}%)")
    lm_runs = [s for s in records if s.name == "finmath.lm.run"
            and lo <= s.start_ns and s.end_ns <= hi]
    if lm_runs:
        calls = (sum(s.attrs["residual_calls"] for s in lm_runs)
                 / len(lm_runs))
        accepted = [s.attrs["residual_calls"] - 1 - s.attrs["rejected_steps"]
                    for s in lm_runs]
        print(f"program residual_calls per calibration {calls} (traced "
              f"window), lm_residual_calls {metrics.get('lm_residual_calls')}"
              f" (measured window); accepted steps per calibration "
              f"{accepted}, iterations "
              f"{[s.attrs['iterations'] for s in lm_runs]}")
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)
    sub.add_parser("probe")
    for mode, seeds in (("pairs", "--seeds"), ("traced", "--seed")):
        p = sub.add_parser(mode)
        p.add_argument("--workload", required=True)
        p.add_argument(seeds, required=True,
                       type=str if mode == "pairs" else int)
        p.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    return probe() if args.mode == "probe" else runs(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
