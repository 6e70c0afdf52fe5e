"""Host seconds per calibration inside the LMM engine's forward-mode
Jacobian (on the Jacobian engine's path prefix), over the measured
window."""


def read(ctx):
    if not ctx.spans.calls.get("engine_jacobian"):
        return None
    return ctx.spans.seconds["engine_jacobian"] / ctx.requests
