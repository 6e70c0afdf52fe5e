"""The program's own spans (``finmath_tpu_torch.utils.profiling``) laid
on the device trace of the traced window, shared by the readers of the
per-layer metrics that read them.

The program records spans while a torch profiler is active, so the
traced window's spans are in its ring, stamped with the clock of the
profiler's events. ``records`` keeps those that lie inside
``ctx.trace.window`` and its root spans of one name, one per request;
``idle_under`` gives each idle nanosecond of the device (the gaps between
``ctx.trace.busy_intervals()``) to the innermost program span open at it,
by overlap, and divides by the roots. Each returns None where the
program has no ``spans`` (a program without its own tracing), where the
window holds no device operation or no span, or where the roots are not
one per traced request: a clock that disagreed with the trace's reads as nothing, not
as a wrong number."""

from __future__ import annotations

from collections import defaultdict


def _program_spans():
    try:
        from finmath_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def records(ctx, root: str, spans=None):
    """``(spans in the window, its roots named root)``, or None."""
    spans = _program_spans() if spans is None else spans
    if not spans or not ctx.trace.busy_intervals():
        return None
    lo, hi = ctx.trace.window
    inside = [s for s in spans if lo <= s.start_ns and s.end_ns <= hi]
    roots = [s for s in inside if s.name == root]
    if not roots or len(roots) != ctx.traced_requests:
        return None
    return inside, roots


def idle_gaps(trace) -> list:
    """The window's idle intervals ``(start, end)`` in ns, in order."""
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in trace.busy_intervals():
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def innermost(spans) -> list:
    """``(start, end, name)`` pieces of time, in order, each under one
    innermost span: of the spans open there, the one opened last."""
    edges = sorted({s.start_ns for s in spans} | {s.end_ns for s in spans})
    starts = sorted(spans, key=lambda s: s.start_ns)
    pieces, open_, i = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while i < len(starts) and starts[i].start_ns <= a:
            open_.append(starts[i])
            i += 1
        open_ = [s for s in open_ if s.end_ns > a]
        if open_:
            pieces.append((a, b, max(open_, key=lambda s: s.start_ns).name))
    return pieces


def attribute(gaps, spans) -> dict:
    """Idle ns by the name of the innermost span over each part of each
    gap; idle outside every span is left out."""
    by = defaultdict(int)
    pieces = innermost(spans)
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                by[pieces[k][2]] += hi - lo
            k += 1
    return dict(by)


def idle_under(ctx, root: str, spans=None):
    """Idle device ns per root span, by innermost span name, or None."""
    got = records(ctx, root, spans)
    if got is None:
        return None
    inside, roots = got
    by = attribute(idle_gaps(ctx.trace), inside)
    return {name: ns / len(roots) for name, ns in by.items()}


def idle_ms(ctx, root: str, *names, scale: float = 1e-6):
    """Idle device time per root under the spans ``names`` (summed), in
    ms (``scale`` 1e-3: in us), or None."""
    by = idle_under(ctx, root)
    if by is None:
        return None
    return scale * sum(by.get(name, 0.0) for name in names)
