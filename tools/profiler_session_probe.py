"""Which kernels a ``utils.profiling.capture_trace`` session records,
depending on what the process profiled before.

    python3 tools/profiler_session_probe.py MODE

Run it from the repository root on a card. The traced body launches the
path kernel ``bs_paths_kernel`` once (1M x 100) and three torch operations
(a fill, a cumulative sum, the kernel's mean): eight kernel events in a
fresh process. ``MODE``:

* ``fresh``: the session first in the process;
* ``loaded_first``: the kernels' library loaded and launched before;
* ``profiled_first``: one small ``torch.profiler`` session before;
* ``many``: 40 sessions of about 600 device operations before;
* ``thread_load``: the library loaded from worker threads before;
* ``sync_debug``: ``torch.cuda.set_sync_debug_mode`` used before;
* ``heavy``, ``heavy_pause``, ``heavy_empty``: one session of 30,001
  device operations before (then a 0.2 s pause inside the traced session,
  or an empty session in between);
* ``phase41``: ``chip_smoke.py``'s phase 41 (its ``_device_busy``
  profiles an SLV simulation) before.

Prints the trace's event counts by category and the first 60 characters
of each kernel event's name (the heavy modes twice: two sessions after).
Needs a CUDA device.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import subprocess
import sys
import tempfile
import time


def main(mode: str) -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    from finmath_tpu_torch.ops import kernels
    from finmath_tpu_torch.utils.profiling import capture_trace

    def launch():
        kernels.bs_paths_kernel(3141, 1_000_000, 100, 1.0, 0.05, 0.3, 1.0,
                                1.05, device="cuda")
        x = torch.ones(1000, device="cuda").cumsum(0)
        torch.cuda.synchronize()
        return x

    def summary(tag, pause=0.0):
        with tempfile.TemporaryDirectory() as tmp:
            with capture_trace(tmp):
                time.sleep(pause)
                launch()
            (path,) = glob.glob(os.path.join(tmp, "trace.*.json"))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        cats = collections.Counter(e.get("cat") for e in events)
        names = [e.get("name", "")[:60] for e in events
                 if e.get("cat") == "kernel"]
        print(tag, dict(cats), names, flush=True)

    def device_events(p):
        return sum(1 for e in p.events() if e.device_type.name == "CUDA")

    if mode == "fresh":
        summary("fresh process:")
    elif mode == "loaded_first":
        kernels.load_kernel()
        launch()
        summary("after load and launch:")
        summary("second session:")
    elif mode == "profiled_first":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            torch.ones(10, device="cuda").sum()
            torch.cuda.synchronize()
        print("first session device events:", device_events(p), flush=True)
        kernels.load_kernel()
        launch()
        summary("after a profile session, load and launch:")
    elif mode == "many":
        for _ in range(40):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                x = torch.randn(1_000_000, device="cuda")
                for _ in range(300):
                    x = x * 1.0001 + 0.001
                torch.cuda.synchronize()
        print("40 sessions, last device events:", device_events(p),
              flush=True)
        summary("after 40 sessions:")
    elif mode == "thread_load":
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda _: kernels.load_kernel(), range(2)))
        launch()
        summary("library loaded in a thread:")
    elif mode == "sync_debug":
        torch.cuda.set_sync_debug_mode("error")
        torch.ones(10, device="cuda") * 2
        torch.cuda.set_sync_debug_mode(0)
        summary("after sync debug mode:")
    elif mode.startswith("heavy"):
        kernels.load_kernel()
        launch()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            x = torch.randn(100_000, device="cuda")
            for _ in range(15_000):
                x = x * 1.0001 + 0.001
            torch.cuda.synchronize()
        print("heavy session device events:", device_events(p), flush=True)
        if mode == "heavy_empty":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                pass
        summary(f"after a heavy session ({mode}):",
                pause=0.2 if mode == "heavy_pause" else 0.0)
        summary(f"second capture ({mode}):")
    elif mode == "phase41":
        import chip_smoke
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        kernels.load_kernel()
        launch()
        chip_smoke._slv(torch, smi)
        summary("after phase 41:")
    else:
        raise SystemExit(f"profiler_session_probe: unknown mode {mode!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
