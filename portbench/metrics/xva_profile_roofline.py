"""Share of its roofline that an exposure profile reaches: the least time
of a profile's work (``roofline/xva_profile.py``, from the cell's shapes)
over the device's busy time per traced profile (the union of the
profiler's kernel, copy and set intervals in the traced window over the
profiles in it). Nothing is returned unless the traced window holds one
program root span ``finmath.xva.profile`` per traced request."""

from program_spans import records


def read(ctx):
    if records(ctx, "finmath.xva.profile") is None \
            or "underlyings" not in getattr(ctx, "shape", {}):
        return None
    busy = ctx.trace.busy_s / ctx.traced_requests
    if busy <= 0.0:
        return None
    spec = ctx.load_module(ctx.bench / "roofline" / "xva_profile.py")
    return 100.0 * spec.least_seconds(ctx.shape, ctx.peaks) / busy
