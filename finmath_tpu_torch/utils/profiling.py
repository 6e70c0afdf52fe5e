"""Profiling and tracing helpers.

Counterpart of ``finmath_tpu.utils.profiling``: named regions that show
in a profiler trace and log their wall time, and a context that captures
a whole trace (host operations and, with a card, the CUDA kernels) into a
Chrome trace file, which ``chrome://tracing`` or Perfetto opens.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from pathlib import Path
from typing import Iterator

import torch

logger = logging.getLogger("finmath_tpu_torch")


@contextlib.contextmanager
def trace(label: str) -> Iterator[None]:
    """Mark a region for the PyTorch profiler
    (``torch.profiler.record_function``) and log its wall time at INFO
    on the ``finmath_tpu_torch`` logger."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(label):
        yield
    logger.info("%s: %.3f s", label, time.perf_counter() - t0)


@contextlib.contextmanager
def capture_trace(log_dir: str) -> Iterator[None]:
    """Profile the body's CPU operations and, where CUDA is available,
    its CUDA kernels, and write a Chrome trace
    ``trace.<pid>.<ns>.json`` into ``log_dir`` (made if missing) on exit,
    also when the body raises.

    With torch 2.11 (CUDA 12.8) on an H100, once a process has profiled a
    session of about 30,000 device operations, every later session of it
    misses kernels at its start: the first of a short session after one
    such session, all five of a short session after ``chip_smoke.py``'s
    phases 38-45 (phase 48 checks its trace in a fresh process). Profile
    such workloads in a process of their own."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            str(out / f"trace.{os.getpid()}.{time.time_ns()}.json"))
