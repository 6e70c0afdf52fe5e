"""Share of its roofline that the kernel of ``roofline/swaption_paths.py``
reaches over the traced window (``rooflines.share``)."""

from rooflines import share


def read(ctx):
    return share(ctx, "swaption_paths")
