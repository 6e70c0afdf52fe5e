"""Wall of one kernel-backend residual or Jacobian call, from the call to
its host result (the backend returns host arrays, so the wall includes the
launch it waits for), over the measured window."""


def read(ctx):
    calls = ctx.spans.calls.get("kernel_backend")
    if not calls:
        return None
    return 1e3 * ctx.spans.seconds["kernel_backend"] / calls
