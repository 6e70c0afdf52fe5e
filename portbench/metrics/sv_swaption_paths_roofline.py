"""Share of its roofline that the kernel of ``roofline/sv_swaption_paths.py``
reaches over the traced window (``rooflines.share``)."""

from rooflines import share


def read(ctx):
    return share(ctx, "sv_swaption_paths")
