"""Device idle time per calibration under the kernel backend's
``finmath.backend.launch`` spans (the parameter sets packed as a block
stages them, the product tables, the partials allocated and the kernel
enqueued), traced window (``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.lm.run", "finmath.backend.launch")
