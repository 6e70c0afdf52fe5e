"""Device idle time per calibration under the kernel backend's
``finmath.backend.reduce`` spans (the kernel's float64 tile sums, the
division by the paths, the weights and the central differences), traced
window (``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.lm.run", "finmath.backend.reduce")
