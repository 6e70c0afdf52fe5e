"""Shared pieces of the RandomVariable API.

Copied from ``finmath_tpu.ops._api`` (NumPy only): the port keeps its own
copy so that it never imports the JAX package. The device type's priority
keeps the reference's name, ``TYPE_PRIORITY_TPU`` (20).

The reference defines the contract in two sibling implementations that must
agree bit-for-bit (RandomVariableCuda.java:67-68):

* the device implementation (RandomVariableCuda.java) and
* the CPU float oracle (cpu/montecarlo/RandomVariableFromFloatArray.java).

This module holds what both of our implementations share: type-priority
constants, the finmath-compatible quantile index convention, and the helper
that installs finmath-style camelCase aliases next to the Pythonic
snake_case API, so that a user of the reference finds the names they know
(``getAverage``, ``addProduct``, ...) on our classes.
"""

from __future__ import annotations

import math

import numpy as np

# Type priorities drive binary-operator dispatch: if the argument has a
# higher priority, the operation is delegated to it (with arguments flipped
# for non-commutative ops). Reference: CPU float = 1
# (RandomVariableFromFloatArray.java:47), device = 20
# (RandomVariableCuda.java:568), AAD wrappers higher (README.md:50-52).
TYPE_PRIORITY_FLOAT = 1
TYPE_PRIORITY_TPU = 20
TYPE_PRIORITY_AAD = 30


def det_eval(fn, *xs) -> float:
    """Evaluate a deterministic-fast-path scalar op with IEEE/Java
    semantics: domain errors yield NaN, overflow / division by zero yield
    signed infinity — exactly like the stochastic array path and the Java
    reference (Math.log(-1) is NaN, 1.0/0.0 is Infinity). Python's float
    math raises ValueError/ZeroDivisionError/OverflowError instead, which
    would make a pricing chain CRASH when an intermediate happens to
    collapse to a deterministic scalar. Operands are promoted to numpy
    float64 so plain arithmetic lambdas (a/b, 1.0/x, ...) pick up IEEE
    behavior too; pass numpy ufuncs (np.log, np.sqrt, ...) rather than
    math.* for the transcendental ops."""
    with np.errstate(all="ignore"):
        return float(fn(*(np.float64(x) for x in xs)))


def quantile_index(size: int, quantile: float) -> int:
    """finmath's quantile index convention on sorted realizations.

    Java's Math.round is floor(x + 0.5) (half-up); Python's round() is
    half-to-even, which differs on exact .5 ties (e.g. size=19, q=0.075:
    Java gives index 1, banker's rounding gives 0), so the Java form is
    spelled out."""
    idx = int(math.floor((size + 1) * quantile - 1 + 0.5))
    return min(max(idx, 0), size - 1)


#: snake_case -> camelCase alias table (finmath RandomVariable interface).
_CAMEL_ALIASES = {
    "get_filtration_time": "getFiltrationTime",
    "get_type_priority": "getTypePriority",
    "double_value": "doubleValue",
    "is_deterministic": "isDeterministic",
    "get_realizations": "getRealizations",
    "get_min": "getMin",
    "get_max": "getMax",
    "get_average": "getAverage",
    "get_variance": "getVariance",
    "get_sample_variance": "getSampleVariance",
    "get_standard_deviation": "getStandardDeviation",
    "get_standard_error": "getStandardError",
    "get_quantile": "getQuantile",
    "get_quantile_expectation": "getQuantileExpectation",
    "get_histogram": "getHistogram",
    "get_conditional_expectation": "getConditionalExpectation",
    "add_product": "addProduct",
    "add_ratio": "addRatio",
    "sub_ratio": "subRatio",
    "add_sum_product": "addSumProduct",
    "is_nan": "isNaN",
    "get_operator": "getOperator",
    "get_realizations_stream": "getRealizationsStream",
}


def install_camel_aliases(cls: type) -> type:
    """Install finmath-style camelCase aliases for the snake_case API."""
    for snake, camel in _CAMEL_ALIASES.items():
        if hasattr(cls, snake) and not hasattr(cls, camel):
            setattr(cls, camel, getattr(cls, snake))
    return cls
