"""Device idle time per exposure profile under the program's
``finmath.xva.simulate`` spans (the engine's step loop outside the dates' collections, and the paths' discount factors), traced window
(``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.xva.profile", "finmath.xva.simulate")
