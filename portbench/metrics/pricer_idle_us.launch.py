"""Device idle time per price under the pricer entry points'
``finmath.pricer.launch`` spans (the payoffs allocated and the launcher
called), traced window (``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.pricer.price", "finmath.pricer.launch",
                   scale=1e-3)
