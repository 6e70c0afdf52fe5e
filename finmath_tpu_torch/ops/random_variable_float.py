"""CPU float32 oracle implementation of the RandomVariable contract.

Copied from ``finmath_tpu.ops.random_variable_float`` (NumPy only), with
its base class taken from the port's ``ops.random_variable``: the port
keeps its own copy so that it never imports the JAX package. Mixed
operations with ``RandomVariableTorch`` (priority 20) are delegated to it.

This is the parity-test oracle, the analog of the reference's
``RandomVariableFromFloatArray`` (finmath-lib's net/finmath/cuda/cpu/
montecarlo/RandomVariableFromFloatArray.java:43-1460): a NumPy float32
implementation whose elementwise results the device implementation must
match pointwise at ~1 ULP (the reference states the bit-compatibility
contract at RandomVariableCuda.java:67-68 and tests it at
RandomVariableGPUTest.java:190-360 with tolerance 1e-7*(1+|x|)).

Reductions use Kahan-compensated double-precision accumulation exactly as
the reference oracle does (RandomVariableFromFloatArray.java:314-382).
Type priority is 1 (ref. :47), so any mixed CPU/device operation is
delegated to the device implementation by the dispatch protocol.
"""

from __future__ import annotations

import math
import numbers
from typing import Callable, Sequence

import numpy as np

from ._api import (
    TYPE_PRIORITY_FLOAT,
    det_eval as _det_eval,
    install_camel_aliases,
    quantile_index,
)
from .random_variable import RandomVariable


def _is_scalar(x) -> bool:
    return isinstance(x, numbers.Real) and not isinstance(x, bool)


def kahan_sum(values: np.ndarray) -> float:
    """Kahan-compensated sum of a float array, accumulating in double
    (ref. RandomVariableFromFloatArray.java:314-334)."""
    s = 0.0
    c = 0.0
    for x in values.astype(np.float64):
        y = x - c
        t = s + y
        c = (t - s) - y
        s = t
    return s


def _kahan_sum_blocked(values: np.ndarray, lanes: int = 2048) -> float:
    """Vectorized TRUE Kahan summation: the array is laid out as
    [rows, lanes]; each lane runs its own compensated accumulator (the
    scalar Kahan recurrence applied to NumPy vectors, so the Python loop is
    over rows only), and the per-lane sums are combined — together with
    their accumulated compensations — by the scalar Kahan loop. This keeps
    the oracle contract (Kahan everywhere, like
    RandomVariableFromFloatArray.java:314-334) at every size without the
    pure-Python per-element loop dominating test runtime."""
    v = values.astype(np.float64).ravel()
    rows = -(-v.size // lanes)
    if rows * lanes != v.size:
        v = np.concatenate([v, np.zeros(rows * lanes - v.size)])
    v = v.reshape(rows, lanes)
    s = np.zeros(lanes)
    c = np.zeros(lanes)
    for row in v:
        y = row - c
        t = s + y
        c = (t - s) - y
        s = t
    # true per-lane sum ~= s - c; feed both through the scalar Kahan
    return kahan_sum(np.concatenate([s, -c]))


def _accurate_sum(values: np.ndarray) -> float:
    # Scalar Kahan for small arrays, lane-parallel Kahan for large ones —
    # compensated summation at every size (the oracle contract).
    if values.size <= 4096:
        return kahan_sum(values)
    return _kahan_sum_blocked(values)


class RandomVariableFloat(RandomVariable):
    """Immutable CPU float32 vector of path realizations + filtration time."""

    __slots__ = ("_time", "_values")

    _TYPE_PRIORITY = TYPE_PRIORITY_FLOAT

    def __init__(self, time: float = 0.0, values=None, value: float = None):
        if values is None and value is not None:
            values = value
        if values is None:
            raise ValueError("RandomVariableFloat requires a value or values")
        self._time = float(time)
        if _is_scalar(values):
            self._values = float(values)
        else:
            arr = np.asarray(values)
            if arr.ndim == 0:
                self._values = float(arr)
            else:
                self._values = arr.astype(np.float32, copy=False)

    @classmethod
    def of(cls, time: float, values) -> "RandomVariableFloat":
        rv = object.__new__(cls)
        rv._time = float(time)
        rv._values = values
        return rv

    @classmethod
    def from_random_variable(cls, other: RandomVariable) -> "RandomVariableFloat":
        if isinstance(other, RandomVariableFloat):
            return other
        if other.is_deterministic():
            return cls(other.get_filtration_time(), other.double_value())
        return cls(other.get_filtration_time(), np.asarray(other.get_realizations()))

    # ------------------------------------------------------------------
    # inspection
    # ------------------------------------------------------------------
    def get_filtration_time(self) -> float:
        return self._time

    def get_type_priority(self) -> int:
        return self._TYPE_PRIORITY

    def is_deterministic(self) -> bool:
        return not isinstance(self._values, np.ndarray)

    def size(self) -> int:
        return 1 if self.is_deterministic() else int(self._values.shape[0])

    def double_value(self) -> float:
        if not self.is_deterministic():
            raise ValueError("doubleValue on a stochastic random variable")
        return float(self._values)

    def get(self, index: int) -> float:
        if self.is_deterministic():
            return float(self._values)
        return float(self._values[index])

    def get_realizations(self) -> np.ndarray:
        if self.is_deterministic():
            raise ValueError("getRealizations on a deterministic random variable")
        return self._values

    @property
    def values(self):
        return self._values

    def cache(self):
        return self

    def get_operator(self):
        return None

    def get_realizations_stream(self):
        if self.is_deterministic():
            return iter([float(self._values)])
        return iter(self._values)

    def __repr__(self) -> str:
        if self.is_deterministic():
            return f"RandomVariableFloat(time={self._time}, value={self._values})"
        return f"RandomVariableFloat(time={self._time}, size={self.size()})"

    def equals(self, other: RandomVariable) -> bool:
        if self._time != other.get_filtration_time():
            return False
        if self.is_deterministic() and other.is_deterministic():
            return self.double_value() == other.double_value()
        if self.is_deterministic() != other.is_deterministic():
            return False
        a = self._values
        b = np.asarray(other.get_realizations())
        return a.shape == b.shape and bool(np.all(a == b))

    # ------------------------------------------------------------------
    # dispatch helpers
    # ------------------------------------------------------------------
    def _defer(self, other) -> bool:
        return (
            isinstance(other, RandomVariable)
            and other.get_type_priority() > self.get_type_priority()
        )

    def _host(self, other: RandomVariable):
        o = RandomVariableFloat.from_random_variable(other)
        return o.is_deterministic(), o._values

    # ------------------------------------------------------------------
    # unary ops (float32 elementwise, double scalar fast path — mirrors the
    # reference oracle which does (float) Math.op(double) per element)
    # ------------------------------------------------------------------
    def _unary(self, scalar_fn, array_fn) -> "RandomVariableFloat":
        if self.is_deterministic():
            return RandomVariableFloat.of(self._time, _det_eval(scalar_fn, self._values))
        return RandomVariableFloat.of(
            self._time, array_fn(self._values).astype(np.float32, copy=False)
        )

    def squared(self):
        return self._unary(lambda x: x * x, lambda v: v * v)

    def sqrt(self):
        return self._unary(np.sqrt, np.sqrt)

    def exp(self):
        return self._unary(np.exp, np.exp)

    def log(self):
        return self._unary(np.log, np.log)

    def sin(self):
        return self._unary(np.sin, np.sin)

    def cos(self):
        return self._unary(np.cos, np.cos)

    def invert(self):
        return self._unary(lambda x: 1.0 / x, lambda v: np.float32(1.0) / v)

    def abs(self):
        return self._unary(abs, np.abs)

    def is_nan(self):
        return self._unary(
            lambda x: 1.0 if math.isnan(x) else 0.0,
            lambda v: np.isnan(v).astype(np.float32),
        )

    def average(self):
        return RandomVariableFloat.of(self._time, self.get_average())

    # ------------------------------------------------------------------
    # scalar ops
    # ------------------------------------------------------------------
    def _scalar_op(self, value: float, scalar_fn, array_fn) -> "RandomVariableFloat":
        value = float(value)
        if self.is_deterministic():
            return RandomVariableFloat.of(self._time, _det_eval(scalar_fn, self._values, value))
        return RandomVariableFloat.of(
            self._time,
            array_fn(self._values, np.float32(value)).astype(np.float32, copy=False),
        )

    def cap(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, min, np.minimum, "cap")
        return self._scalar_op(other, min, np.minimum)

    def floor(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, max, np.maximum, "floor")
        return self._scalar_op(other, max, np.maximum)

    def add(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, lambda a, b: a + b, lambda a, b: a + b, "add")
        return self._scalar_op(other, lambda a, b: a + b, lambda a, b: a + b)

    def sub(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, lambda a, b: a - b, lambda a, b: a - b, "sub")
        return self._scalar_op(other, lambda a, b: a - b, lambda a, b: a - b)

    def bus(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, lambda a, b: b - a, lambda a, b: b - a, "bus")
        return self._scalar_op(other, lambda a, b: b - a, lambda a, b: b - a)

    def mult(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, lambda a, b: a * b, lambda a, b: a * b, "mult")
        return self._scalar_op(other, lambda a, b: a * b, lambda a, b: a * b)

    def div(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, lambda a, b: a / b, lambda a, b: a / b, "div")
        return self._scalar_op(other, lambda a, b: a / b, lambda a, b: a / b)

    def vid(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, lambda a, b: b / a, lambda a, b: b / a, "vid")
        return self._scalar_op(other, lambda a, b: b / a, lambda a, b: b / a)

    def pow(self, exponent: float):
        exponent = float(exponent)
        return self._unary(
            lambda x: np.power(x, exponent),
            lambda v: np.power(v, np.float32(exponent)),
        )

    # ------------------------------------------------------------------
    # RV binary ops
    # ------------------------------------------------------------------
    _FLIP = {"add": "add", "mult": "mult", "cap": "cap", "floor": "floor",
             "sub": "bus", "bus": "sub", "div": "vid", "vid": "div"}

    def _binary(self, other, scalar_fn, array_fn, name: str) -> "RandomVariableFloat":
        if self._defer(other):
            return getattr(other, self._FLIP[name])(self)
        new_time = max(self._time, other.get_filtration_time())
        o_det, o_vals = self._host(other)
        if self.is_deterministic() and o_det:
            return RandomVariableFloat.of(new_time, _det_eval(scalar_fn, self._values, o_vals))
        a = self._values if not self.is_deterministic() else np.float32(self._values)
        b = o_vals if not o_det else np.float32(o_vals)
        return RandomVariableFloat.of(new_time, array_fn(a, b).astype(np.float32, copy=False))

    # ------------------------------------------------------------------
    # fused financial ops
    # ------------------------------------------------------------------
    def accrue(self, rate: RandomVariable, period_length: float):
        if self._defer(rate):
            return rate.mult(period_length).add(1.0).mult(self)
        new_time = max(self._time, rate.get_filtration_time())
        r_det, r = self._host(rate)
        p = np.float32(period_length)
        if self.is_deterministic() and r_det:
            return RandomVariableFloat.of(
                new_time, float(self._values) * (1.0 + float(r) * float(period_length))
            )
        a = self._values if not self.is_deterministic() else np.float32(self._values)
        rr = r if not r_det else np.float32(r)
        return RandomVariableFloat.of(
            new_time, (a * (np.float32(1.0) + rr * p)).astype(np.float32, copy=False)
        )

    def discount(self, rate: RandomVariable, period_length: float):
        if self._defer(rate):
            return rate.mult(period_length).add(1.0).vid(self)
        new_time = max(self._time, rate.get_filtration_time())
        r_det, r = self._host(rate)
        p = np.float32(period_length)
        if self.is_deterministic() and r_det:
            return RandomVariableFloat.of(
                new_time,
                _det_eval(lambda s_, rr: s_ / (1.0 + rr * float(period_length)),
                          self._values, r))
        a = self._values if not self.is_deterministic() else np.float32(self._values)
        rr = r if not r_det else np.float32(r)
        return RandomVariableFloat.of(
            new_time, (a / (np.float32(1.0) + rr * p)).astype(np.float32, copy=False)
        )

    def add_product(self, factor1: RandomVariable, factor2):
        if self._defer(factor1) or (
            isinstance(factor2, RandomVariable) and self._defer(factor2)
        ):
            return factor1.mult(factor2).add(self)
        new_time = max(self._time, factor1.get_filtration_time())
        f1_det, f1 = self._host(factor1)
        if isinstance(factor2, RandomVariable):
            new_time = max(new_time, factor2.get_filtration_time())
            f2_det, f2 = self._host(factor2)
        else:
            f2_det, f2 = True, float(factor2)
        if self.is_deterministic() and f1_det and f2_det:
            return RandomVariableFloat.of(
                new_time, float(self._values) + float(f1) * float(f2)
            )
        a = self._values if not self.is_deterministic() else np.float32(self._values)
        b = f1 if not f1_det else np.float32(f1)
        c = f2 if not f2_det else np.float32(f2)
        return RandomVariableFloat.of(new_time, (a + b * c).astype(np.float32, copy=False))

    def add_ratio(self, numerator: RandomVariable, denominator: RandomVariable):
        if self._defer(numerator) or self._defer(denominator):
            return self.add(numerator.div(denominator))
        return self._ratio(numerator, denominator, +1.0)

    def sub_ratio(self, numerator: RandomVariable, denominator: RandomVariable):
        if self._defer(numerator) or self._defer(denominator):
            return self.sub(numerator.div(denominator))
        return self._ratio(numerator, denominator, -1.0)

    def _ratio(self, numerator, denominator, sign: float):
        new_time = max(
            self._time,
            numerator.get_filtration_time(),
            denominator.get_filtration_time(),
        )
        n_det, n = self._host(numerator)
        d_det, d = self._host(denominator)
        if self.is_deterministic() and n_det and d_det:
            return RandomVariableFloat.of(
                new_time,
                _det_eval(lambda s_, nn_, dd_: s_ + sign * nn_ / dd_,
                          self._values, n, d))
        a = self._values if not self.is_deterministic() else np.float32(self._values)
        nn = n if not n_det else np.float32(n)
        dd = d if not d_det else np.float32(d)
        r = (a + np.float32(sign) * (nn / dd)).astype(np.float32, copy=False)
        return RandomVariableFloat.of(new_time, r)

    def add_sum_product(self, factors1: Sequence, factors2: Sequence):
        result = self
        for f1, f2 in zip(factors1, factors2):
            result = result.add_product(f1, f2)
        return result

    def choose(self, value_if_nonneg: RandomVariable, value_if_neg: RandomVariable):
        """ref. RandomVariableFromFloatArray.java:1264-1285."""
        if self._defer(value_if_nonneg) or self._defer(value_if_neg):
            return value_if_nonneg.mult(self.ge_zero()).add_product(
                value_if_neg, self.ge_zero().bus(1.0)
            )
        new_time = max(
            self._time,
            value_if_nonneg.get_filtration_time(),
            value_if_neg.get_filtration_time(),
        )
        a_det, a = self._host(value_if_nonneg)
        b_det, b = self._host(value_if_neg)
        if self.is_deterministic():
            chosen = value_if_nonneg if float(self._values) >= 0 else value_if_neg
            out = RandomVariableFloat.from_random_variable(chosen)
            return RandomVariableFloat.of(new_time, out._values)
        aa = a if not a_det else np.float32(a)
        bb = b if not b_det else np.float32(b)
        return RandomVariableFloat.of(
            new_time, np.where(self._values >= 0, aa, bb).astype(np.float32, copy=False)
        )

    def ge_zero(self):
        return self._unary(
            lambda x: 1.0 if x >= 0 else 0.0,
            lambda v: (v >= 0).astype(np.float32),
        )

    def apply(self, function: Callable, *args: RandomVariable):
        operands = [self] + [RandomVariableFloat.from_random_variable(a) for a in args]
        new_time = max(o.get_filtration_time() for o in operands)
        if all(o.is_deterministic() for o in operands):
            return RandomVariableFloat.of(
                new_time, float(function(*[float(o._values) for o in operands]))
            )
        vals = [
            o._values if not o.is_deterministic() else np.float32(o._values)
            for o in operands
        ]
        return RandomVariableFloat.of(
            new_time, np.asarray(function(*vals), dtype=np.float32)
        )

    # ------------------------------------------------------------------
    # reductions — Kahan double accumulation
    # ------------------------------------------------------------------
    def get_average(self, probabilities: RandomVariable = None) -> float:
        if probabilities is not None:
            p = RandomVariableFloat.from_random_variable(probabilities)
            if self.is_deterministic():
                if p.is_deterministic():
                    return float(self._values) * float(p._values)
                return float(self._values) * _accurate_sum(p._values)
            if p.is_deterministic():
                return float(p._values) * _accurate_sum(self._values)
            return _accurate_sum(
                (self._values.astype(np.float64) * p._values.astype(np.float64))
            )
        if self.is_deterministic():
            return float(self._values)
        return _accurate_sum(self._values) / self.size()

    def get_variance(self, probabilities: RandomVariable = None) -> float:
        if self.is_deterministic():
            return 0.0
        if probabilities is not None:
            mean = self.get_average(probabilities)
            p = RandomVariableFloat.from_random_variable(probabilities)
            dev = self._values.astype(np.float64) - mean
            return _accurate_sum(dev * dev * p._values.astype(np.float64))
        mean = self.get_average()
        dev = self._values.astype(np.float64) - mean
        return _accurate_sum(dev * dev) / self.size()

    def get_sample_variance(self) -> float:
        n = self.size()
        if n == 1 or self.is_deterministic():
            return 0.0
        return self.get_variance() * n / (n - 1)

    def get_standard_deviation(self, probabilities: RandomVariable = None) -> float:
        if self.is_deterministic():
            return 0.0
        return math.sqrt(self.get_variance(probabilities))

    def get_standard_error(self, probabilities: RandomVariable = None) -> float:
        if self.is_deterministic():
            return 0.0
        return self.get_standard_deviation(probabilities) / math.sqrt(self.size())

    def get_min(self) -> float:
        if self.is_deterministic():
            return float(self._values)
        return float(np.min(self._values))

    def get_max(self) -> float:
        if self.is_deterministic():
            return float(self._values)
        return float(np.max(self._values))

    def get_quantile(self, quantile: float, probabilities: RandomVariable = None) -> float:
        if self.is_deterministic():
            return float(self._values)
        if probabilities is not None:
            order = np.argsort(self._values)
            p = RandomVariableFloat.from_random_variable(probabilities)
            if p.is_deterministic():
                pv = np.full(self.size(), float(p.values), dtype=np.float64)
            else:
                pv = p.values[order].astype(np.float64)
            cum = np.cumsum(pv)
            idx = int(np.clip(np.searchsorted(cum, quantile), 0, self.size() - 1))
            return float(self._values[order[idx]])
        sorted_vals = np.sort(self._values)
        return float(sorted_vals[quantile_index(self.size(), quantile)])

    def get_quantile_expectation(self, q_start: float, q_end: float) -> float:
        if self.is_deterministic():
            return float(self._values)
        if q_start > q_end:
            return self.get_quantile_expectation(q_end, q_start)
        n = self.size()
        lo = quantile_index(n, q_start)
        hi = quantile_index(n, q_end)
        sorted_vals = np.sort(self._values)
        return _accurate_sum(sorted_vals[lo : hi + 1]) / (hi - lo + 1)

    def get_histogram(self, interval_points=None, number_of_points: int = None,
                      standard_deviations: float = None):
        if interval_points is not None:
            pts = np.asarray(interval_points, dtype=np.float64)
            if self.is_deterministic():
                counts = np.zeros(len(pts) + 1)
                counts[int(np.searchsorted(pts, float(self._values), side="right"))] = 1.0
                return counts
            idx = np.searchsorted(pts, self._values.astype(np.float64), side="right")
            counts = np.bincount(idx, minlength=len(pts) + 1).astype(np.float64)
            return counts / self.size()
        mean = self.get_average()
        std = self.get_standard_deviation()
        lower = mean - standard_deviations * std
        upper = mean + standard_deviations * std
        pts = np.linspace(lower, upper, number_of_points - 1) if number_of_points > 1 else np.array([mean])
        freqs = self.get_histogram(interval_points=pts)
        step = (upper - lower) / max(number_of_points - 2, 1)
        centers = np.concatenate([[pts[0] - step / 2], (pts[:-1] + pts[1:]) / 2, [pts[-1] + step / 2]]) if len(pts) > 1 else np.array([mean, mean])
        return np.stack([centers, freqs])

    def get_conditional_expectation(self, estimator):
        return estimator.get_conditional_expectation(self)

    # ------------------------------------------------------------------
    # operator sugar
    # ------------------------------------------------------------------
    def __add__(self, other):
        return self.add(other)

    __radd__ = __add__

    def __sub__(self, other):
        return self.sub(other)

    def __rsub__(self, other):
        return self.bus(other)

    def __mul__(self, other):
        return self.mult(other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.div(other)

    def __rtruediv__(self, other):
        return self.vid(other)

    def __pow__(self, exponent):
        return self.pow(exponent)

    def __neg__(self):
        return self.mult(-1.0)

    def __abs__(self):
        return self.abs()


install_camel_aliases(RandomVariableFloat)


class RandomVariableFloatFactory:
    """Factory for the CPU float oracle (ref. RandomVariableFloatFactory.java:16-36)."""

    def create_random_variable(self, time: float, values) -> RandomVariableFloat:
        return RandomVariableFloat(time, values)

    createRandomVariable = create_random_variable

    def create_random_variable_from_array(self, time: float, values) -> RandomVariableFloat:
        return RandomVariableFloat(time, values)

    def __repr__(self):
        return "RandomVariableFloatFactory()"
