"""Trial steps that Levenberg-Marquardt rejected per calibration:
the mean of the ``rejected_steps`` attribute of the program's
``finmath.lm.run`` spans in the traced window (``program_spans``). A
rejected step costs a residual call that does not move the iterate."""

from program_spans import records


def read(ctx):
    got = records(ctx, "finmath.lm.run")
    if got is None:
        return None
    roots = got[1]
    steps = [s.attrs.get("rejected_steps") for s in roots]
    if any(v is None for v in steps):
        return None
    return sum(steps) / len(roots)
