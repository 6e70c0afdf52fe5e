"""Host seconds per calibration inside the analytic approximation's
residual and Jacobian calls (the warm start), over the measured window."""


def read(ctx):
    if not ctx.spans.calls.get("analytic"):
        return None
    return ctx.spans.seconds["analytic"] / ctx.requests
