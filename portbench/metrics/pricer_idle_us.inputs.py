"""Device idle time per price under the pricer entry points'
``finmath.pricer.inputs`` spans (the inputs built on the host, checked,
packed into the table, and the scalars read), traced window
(``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.pricer.price", "finmath.pricer.inputs",
                   scale=1e-3)
