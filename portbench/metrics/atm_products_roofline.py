"""Share of its roofline that the kernel of ``roofline/atm_products.py``
reaches over the traced window (``rooflines.share``)."""

from rooflines import share


def read(ctx):
    return share(ctx, "atm_products")
