"""Residual calls the Levenberg-Marquardt driver makes per calibration:
the benchmark's counter around the residual function it hands the LM,
over the measured window."""


def read(ctx):
    if ctx.kind != "calibrate" or not ctx.requests:
        return None
    return ctx.spans.counters.get("lm_residual_calls", 0) / ctx.requests
