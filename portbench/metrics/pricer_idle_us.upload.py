"""Device idle time per price under the pricer entry points'
``finmath.pricer.upload`` spans (the table's copy to the device),
traced window (``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.pricer.price", "finmath.pricer.upload",
                   scale=1e-3)
