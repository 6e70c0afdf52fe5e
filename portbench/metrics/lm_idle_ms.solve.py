"""Device idle time per calibration under the program's
``finmath.lm.solve`` spans (the trial steps' normal equations, solve and
clip on the host), traced window (``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.lm.run", "finmath.lm.solve")
