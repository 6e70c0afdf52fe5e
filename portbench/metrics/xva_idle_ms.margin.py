"""Device idle time per exposure profile under the program's
``finmath.xva.margin`` spans (the CSA's pathwise margin scan over the dates), traced window
(``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.xva.profile", "finmath.xva.margin")
