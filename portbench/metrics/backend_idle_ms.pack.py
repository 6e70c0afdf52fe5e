"""Device idle time per calibration under the kernel backend's
``finmath.backend.pack`` spans (the parameters to the device, the
central-difference sets, the loading tables with the factor reduction's
eigendecomposition, the scalars and the float32 casts), traced window
(``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.lm.run", "finmath.backend.pack")
