"""Share of the time in which no operation runs on the device, in the
price cells: 1 minus the device's busy seconds per request in the traced
window (the union of the profiler's kernel, copy and set intervals) over
the wall per request of the measured window, whose requests do the same
work. The traced window's own wall is longer by the profiler's host cost,
so it is not the denominator."""

from rooflines import idle_share


def read(ctx):
    if ctx.kind != "price":
        return None
    return idle_share(ctx)
