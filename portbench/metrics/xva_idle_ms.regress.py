"""Device idle time per exposure profile under the program's
``finmath.xva.regress`` spans (the close-out values of the European and Bermudan swaptions: the Longstaff-Schwartz regressions, the backward induction and the stopped paths), traced window
(``program_spans``)."""

from program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "finmath.xva.profile", "finmath.xva.regress")
