"""Device idle time per calibration under the kernel backend's call spans'
own time (``finmath.backend.residuals`` and
``finmath.backend.jacobian`` outside their parts: the fetch of the rows
to the host, mostly), traced window (``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.lm.run", "finmath.backend.residuals",
                   "finmath.backend.jacobian")
