"""``lmm_atm_products_kernel`` (``csrc/lmm_atm_products.cu``): one launch
values B parameter sets over every path."""

import re

from roofline._sweep import bytes_moved as _bytes
from roofline._sweep import operations as _operations

PATTERN = re.compile(
    r"(?<![A-Za-z0-9_])lmm_atm_products_kernel(?![A-Za-z0-9_])")


def operations(shape: dict, batch: int) -> float:
    return _operations(shape["num_libors"], shape["num_factors"],
                       shape["products"], shape["paths"], batch,
                       stoch_vol=shape["stoch_vol"],
                       displaced=shape["displaced"])


def bytes_moved(shape: dict, batch: int) -> float:
    return _bytes(shape["num_libors"], shape["num_factors"],
                  shape["products"], shape["paths"], batch,
                  stoch_vol=shape["stoch_vol"])
