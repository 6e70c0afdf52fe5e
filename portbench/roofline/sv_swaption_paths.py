"""``lmm_stochvol_swaption_paths_kernel`` (``csrc/lmm_swaption_paths.cu``):
one launch prices one swaption over every path, each path drawing its
own normals."""

import re

from roofline._pricer import bytes_moved as _bytes
from roofline._pricer import operations as _operations

PATTERN = re.compile(
    r"(?<![A-Za-z0-9_])lmm_stochvol_swaption_paths_kernel(?![A-Za-z0-9_])")


def operations(shape: dict, batch: int) -> float:
    return batch * _operations(shape["num_factors"], shape["steps"],
                               shape["exercise"], shape["periods"],
                               shape["paths"], stoch_vol=True)


def bytes_moved(shape: dict, batch: int) -> float:
    return batch * _bytes(shape["num_libors"], shape["num_factors"],
                          shape["steps"], shape["paths"], stoch_vol=True)
