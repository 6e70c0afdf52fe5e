"""Device idle time per exposure profile under the program's
``finmath.xva.collect`` spans (the collection at each observation date: the bond curve, the swaps' and the underlyings' annuity products, the values written into the dates' buffers), traced window
(``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.xva.profile", "finmath.xva.collect")
