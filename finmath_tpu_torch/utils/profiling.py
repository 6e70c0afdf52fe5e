"""Profiling and tracing helpers.

Counterpart of ``finmath_tpu.utils.profiling``: named regions that show
in a profiler trace and log their wall time, and a context that captures
a whole trace (host operations and, with a card, the CUDA kernels) into a
Chrome trace file, which ``chrome://tracing`` or Perfetto opens.

The program's own spans: ``span(name, **attrs)`` marks one part of the
program's work (names ``finmath.<layer>.<part>``). Tracing is on while a
torch profiler session is active or inside ``recording()``; then a span
appends a ``SpanRecord`` to a bounded ring (the newest ``CAPACITY``,
read by ``spans()``, emptied by ``clear()``) and, under the profiler,
also opens a range of its name in the profiler's trace. Off, a span
costs a check of two flags and returns a shared object that does
nothing: no clock read, no record, no profiler call.

A record's times are ``time.time_ns()``: the clock the profiler stamps
its host events with (and, aligned to them, the device's), so a record
can be laid on a device trace of the same process. Its interval holds
the profiler's range of the same span.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import threading
import time
from pathlib import Path
from typing import Iterator, List, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("finmath_tpu_torch")

#: records the ring keeps; older ones are dropped
CAPACITY = 1 << 16


class SpanRecord(NamedTuple):
    """One finished span. ``parent`` is 0 for a span opened outside any
    other of its thread; ``root`` is the id of the outermost span it was
    opened in (its own for a root), shared by all spans of one request."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    root: int
    thread: int
    attrs: dict


_records = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()
_recording = 0
_recording_lock = threading.Lock()


class _Off:
    """The span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    """An open span of tracing on; nests on its thread's stack."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Attributes known only when the span ends."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else 0
        self.root = outer.root if outer is not None else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            # a range of the profiler's own (function) scope: it names the
            # host's work in the trace and has no copy on the device
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(None, None, None)
        end = time.time_ns()
        _local.stack.pop()
        _records.append(SpanRecord(self.name, self.start_ns, end, self.id,
                                   self.parent, self.root,
                                   threading.get_ident(), self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager marking one part of the program's work; ``with
    span(...) as s: ... s.set(key=value)`` adds attributes at its end."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans in the body without a profiler (and without its
    cost); contexts nest, and apply to every thread."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def spans() -> List[SpanRecord]:
    """The records in the ring, in the order their spans ended."""
    return list(_records)


def clear() -> None:
    """Empty the ring."""
    _records.clear()


@contextlib.contextmanager
def trace(label: str) -> Iterator[None]:
    """Mark a region as a ``span`` (a range of the PyTorch profiler when
    one is active) and log its wall time at INFO on the
    ``finmath_tpu_torch`` logger."""
    t0 = time.perf_counter()
    with span(label):
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
