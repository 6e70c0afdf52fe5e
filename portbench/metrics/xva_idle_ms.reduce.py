"""Device idle time per exposure profile under the program's
``finmath.xva.reduce`` spans (the means of the profile's rows, the sort and the PFE quantiles), traced window
(``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.xva.profile", "finmath.xva.reduce")
