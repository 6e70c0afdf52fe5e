"""Readings of a traced window shared by the metric readers.

``share``: a kernel's share of its roofline, the least time its launches
could take on the card (for each launch the larger of its operations over
the float32 peak and its bytes over the memory rate, from
``roofline/<kernel>.py`` and the launch's shape) over the device time the
profiler gave those launches. Nothing is returned unless the trace holds
exactly the launches the benchmark's spans saw in that window.

``idle_share``: the device's idle share of the measured window."""

from __future__ import annotations


def share(ctx, kernel: str):
    spec = ctx.load_module(ctx.bench / "roofline" / f"{kernel}.py")
    batches = [b for k, b in ctx.traced.launches if k == kernel]
    launches, seconds = ctx.trace.kernel_seconds(spec.PATTERN)
    if not batches or launches != len(batches) or seconds <= 0.0:
        return None
    peak = ctx.peaks
    least = sum(max(spec.operations(ctx.shape, b) / peak["float32_flops"],
                    spec.bytes_moved(ctx.shape, b) / peak["bytes_per_s"])
                for b in batches)
    return 100.0 * least / seconds


def idle_share(ctx):
    if not ctx.traced_requests or not ctx.requests or ctx.window_s <= 0.0 \
            or ctx.trace.busy_s <= 0.0:
        return None
    busy = ctx.trace.busy_s / ctx.traced_requests
    return 100.0 * (1.0 - busy / (ctx.window_s / ctx.requests))
