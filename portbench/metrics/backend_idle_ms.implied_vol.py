"""Device idle time per calibration under the kernel backend's
``finmath.backend.implied_vol`` spans (the Black implied-volatility
Newton), traced window (``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.lm.run", "finmath.backend.implied_vol")
