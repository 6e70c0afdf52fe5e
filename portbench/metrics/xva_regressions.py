"""Regressions an exposure profile fits: the mean of the ``regressions``
attribute of the program's ``finmath.xva.profile`` spans in the traced
window (``program_spans``)."""

from program_spans import records


def read(ctx):
    got = records(ctx, "finmath.xva.profile")
    if got is None:
        return None
    roots = got[1]
    counts = [s.attrs.get("regressions") for s in roots]
    if any(v is None for v in counts):
        return None
    return sum(counts) / len(roots)
