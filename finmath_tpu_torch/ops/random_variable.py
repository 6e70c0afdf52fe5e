"""The device RandomVariable: an immutable vector of Monte-Carlo path
realizations plus a filtration time.

Counterpart of ``finmath_tpu.ops.random_variable`` (``RandomVariableTPU``),
itself the redesign of the reference's device vector type
``RandomVariableCuda``. The contract is the same:

* immutable (values, filtration time, type priority);
* float32 storage, float64-accumulated reductions (the reference
  accumulates float32 input in float64 with Kahan compensation;
  ``torch.sum(..., dtype=torch.float64)`` here);
* a deterministic-scalar fast path on every operation: a scalar random
  variable holds a Python float, does no device work, and
  ``get_realizations`` raises ``ValueError`` on it;
* ``max(filtrationTime)`` propagation on binary operations;
* type-priority dispatch (device 20, float oracle 1, AAD 30): an operand of
  higher priority takes the operation over, with the arguments flipped for
  the non-commutative ones (``sub``/``bus``, ``div``/``vid``).

PyTorch runs eagerly, so each operation is one or a few device kernels on
the tensor's device. ``log`` and ``pow`` are ``torch.log`` and
``torch.pow`` in float32: the JAX package's ``precise_math`` replaced the
TPU's approximate transcendentals, which the CUDA and CPU math libraries do
not need. ``exp`` is the exception: CUDA's float32 ``expf`` (up to 2 ULP)
missed the parity sweep's 2.5e-7 bound against the float oracle on an H100
(2.518e-7 at 1M paths), so it is evaluated in float64 and rounded once,
on every device. Values that come from the host
(NumPy, lists) are uploaded to ``device=``, which defaults to
``select_device()``; a tensor keeps its device.

A variable may carry a ``parallel.PathMesh`` (``mesh=``): its tensor is
then this rank's block of the path axis, the other ranks hold the rest,
and every operation's result carries the mesh on (two different meshes
raise). Its reductions are global: sums, means and the two-pass variance
all-reduce in float64, min and max all-reduce, ``size`` counts every
rank's paths, and the quantiles, the histogram, ``get`` and
``get_realizations`` work on the realizations gathered in path order.
"""

from __future__ import annotations

import math
import numbers
from typing import Callable, Sequence

import numpy as np
import torch

from ..parallel.mesh import check_mesh
from ..utils.config import select_device
from ._api import (
    TYPE_PRIORITY_TPU,
    det_eval as _det_eval,
    install_camel_aliases,
    quantile_index,
)

FLOAT_DTYPE = torch.float32
ACC_DTYPE = torch.float64  # reduction accumulator dtype


def _is_scalar(x) -> bool:
    return isinstance(x, numbers.Real) and not isinstance(x, bool)


def _minimum(a, b):
    """Elementwise min of a tensor and a tensor or float (NaN-keeping)."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    return torch.clamp_max(a, b)


def _maximum(a, b):
    """Elementwise max of a tensor and a tensor or float (NaN-keeping)."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    return torch.clamp_min(a, b)


def _joint_mesh(*operands):
    """The mesh of the operands that carry one (None if none does); two
    different meshes raise ``ValueError``."""
    found = None
    for x in operands:
        m = getattr(x, "mesh", None)
        if m is None:
            continue
        if found is not None and m is not found:
            raise ValueError("operands live on two different meshes")
        found = m
    return found


def _exp_rounded(v: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor, computed in float64 and rounded to float32
    (within half an ULP but for double rounding)."""
    return torch.exp(v.to(torch.float64)).to(FLOAT_DTYPE)


class RandomVariable:
    """Abstract marker base so ``isinstance(x, RandomVariable)`` works across
    all implementations (device, CPU float oracle, AAD wrapper)."""

    __slots__ = ()


class RandomVariableTorch(RandomVariable):
    """Immutable float32 vector of path realizations + time, on a device.

    ``values`` is either a Python float (deterministic fast path, no device
    work) or a rank-1 ``float32`` tensor. ``device`` is where host values
    are uploaded (default ``select_device()``); a deterministic variable
    remembers it for the operations that upload another operand. ``mesh``:
    the ``parallel.PathMesh`` whose ranks hold the other blocks of the
    path axis (module docstring).
    """

    __slots__ = ("_time", "_values", "_device", "_mesh")

    _TYPE_PRIORITY = TYPE_PRIORITY_TPU

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def __init__(self, time: float = 0.0, values=None, value: float = None,
                 device=None, mesh=None):
        if values is None and value is not None:
            values = value
        if values is None:
            raise ValueError("RandomVariableTorch requires a value or values")
        self._mesh = check_mesh(mesh)
        self._time = float(time)
        self._device = torch.device(device) if device is not None else None
        if _is_scalar(values):
            self._values = float(values)
        elif isinstance(values, torch.Tensor):
            if values.ndim == 0:
                self._values = float(values)
            else:
                if device is not None:
                    values = values.to(self._device)
                self._values = values.to(FLOAT_DTYPE)
        elif isinstance(values, (list, tuple, np.ndarray)):
            arr = np.asarray(values)
            if arr.ndim == 0:
                self._values = float(arr)
            else:
                target = (self._device if self._device is not None
                          else select_device())
                # a copy: the caller's array may change, the variable not
                self._values = torch.tensor(arr, dtype=FLOAT_DTYPE,
                                            device=target)
        else:
            raise TypeError(f"unsupported values type: {type(values)}")

    @classmethod
    def of(cls, time: float, values, device=None,
           mesh=None) -> "RandomVariableTorch":
        """Wrap existing values without copying (trusted internal path)."""
        rv = object.__new__(cls)
        rv._time = float(time)
        rv._values = values
        rv._device = None if isinstance(values, torch.Tensor) else device
        rv._mesh = mesh
        return rv

    @classmethod
    def from_random_variable(cls, other: "RandomVariable",
                             device=None) -> "RandomVariableTorch":
        """Upload another implementation's realizations to ``device``
        (ref. getRandomVariableCuda, RandomVariableCuda.java:759-766)."""
        if isinstance(other, RandomVariableTorch):
            return other
        if other.is_deterministic():
            return cls(other.get_filtration_time(), other.double_value(),
                       device=device)
        return cls(other.get_filtration_time(),
                   np.asarray(other.get_realizations()), device=device)

    # ------------------------------------------------------------------
    # inspection
    # ------------------------------------------------------------------
    def get_filtration_time(self) -> float:
        return self._time

    def get_type_priority(self) -> int:
        return self._TYPE_PRIORITY

    def is_deterministic(self) -> bool:
        return not isinstance(self._values, torch.Tensor)

    @property
    def mesh(self):
        """The ``PathMesh`` whose ranks hold the other blocks of the path
        axis, or None."""
        return getattr(self, "_mesh", None)

    def _global(self, local: torch.Tensor, op: str = "sum",
                mesh=None) -> torch.Tensor:
        """A path-axis reduction of this rank's block completed over the
        ranks of ``mesh`` (default: this variable's)."""
        mesh = self.mesh if mesh is None else mesh
        return local if mesh is None else mesh.all_reduce(local, op)

    def _gathered(self) -> "RandomVariableTorch":
        """The variable over every rank's paths, in path order, without a
        mesh (itself when it has none)."""
        if self.mesh is None or self.is_deterministic():
            return self
        return RandomVariableTorch.of(self._time,
                                      self.mesh.all_gather(self._values))

    @property
    def device(self) -> torch.device:
        """The values' device; for a deterministic variable, the device its
        operations upload to (``select_device()`` unless one was given)."""
        if isinstance(self._values, torch.Tensor):
            return self._values.device
        return self._device if self._device is not None else select_device()

    def size(self) -> int:
        """The number of paths (over every rank under a mesh)."""
        if self.is_deterministic():
            return 1
        n = int(self._values.shape[0])
        return n if self.mesh is None else n * self.mesh.world_size

    def double_value(self) -> float:
        if not self.is_deterministic():
            raise ValueError("doubleValue on a stochastic random variable")
        return float(self._values)

    def get(self, index: int) -> float:
        """Single realization (one device fetch)."""
        if self.is_deterministic():
            return float(self._values)
        if self.mesh is not None:
            return self._gathered().get(index)
        return float(self._values[index])

    def get_realizations(self) -> np.ndarray:
        """Host copy of all realizations (synchronizes; under a mesh
        every rank's, in path order)."""
        if self.is_deterministic():
            raise ValueError("getRealizations on a deterministic random variable")
        return self._gathered()._values.detach().cpu().numpy()

    @property
    def values(self):
        """Raw backing value: Python float or float32 tensor [paths]."""
        return self._values

    def cache(self) -> "RandomVariableTorch":
        """Wait for the device to finish computing the values."""
        if not self.is_deterministic() and self._values.is_cuda:
            torch.cuda.synchronize(self._values.device)
        return self

    def get_operator(self):  # parity with finmath API surface
        return None

    def get_realizations_stream(self):
        if self.is_deterministic():
            return iter([float(self._values)])
        return iter(self.get_realizations())

    def __repr__(self) -> str:
        if self.is_deterministic():
            return f"RandomVariableTorch(time={self._time}, value={self._values})"
        return (
            f"RandomVariableTorch(time={self._time}, size={self.size()}, "
            f"dtype={self._values.dtype}, device={self._values.device})"
        )

    def equals(self, other: "RandomVariable") -> bool:
        if self._time != other.get_filtration_time():
            return False
        if self.is_deterministic() and other.is_deterministic():
            return self.double_value() == other.double_value()
        if self.is_deterministic() != other.is_deterministic():
            return False
        a = self.get_realizations()
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

    def _dev(self, other: "RandomVariable"):
        """Other's values as (is_deterministic, float-or-tensor), uploaded
        to this variable's device when they live on the host."""
        if isinstance(other, RandomVariableTorch) or other.is_deterministic():
            o = RandomVariableTorch.from_random_variable(other)
        else:
            o = RandomVariableTorch.from_random_variable(other, self.device)
        return o.is_deterministic(), o._values

    def _new_time(self, other: "RandomVariable") -> float:
        return max(self._time, other.get_filtration_time())

    def _of(self, time: float, values, *operands) -> "RandomVariableTorch":
        return type(self).of(time, values, self._device,
                             _joint_mesh(self, *operands))

    # ------------------------------------------------------------------
    # unary ops
    # ------------------------------------------------------------------
    def _unary(self, scalar_fn: Callable, array_fn: Callable) -> "RandomVariableTorch":
        if self.is_deterministic():
            return self._of(self._time, _det_eval(scalar_fn, self._values))
        return self._of(self._time, array_fn(self._values))

    def squared(self):
        return self._unary(lambda x: x * x, lambda v: v * v)

    def sqrt(self):
        return self._unary(np.sqrt, torch.sqrt)

    def exp(self):
        # evaluated in float64 and rounded once: CUDA's float32 expf is off
        # by up to 2 ULP, which breaks the parity sweep's 2.5e-7 bound
        # against the float oracle on the card
        return self._unary(np.exp, _exp_rounded)

    def log(self):
        return self._unary(np.log, torch.log)

    def sin(self):
        return self._unary(np.sin, torch.sin)

    def cos(self):
        return self._unary(np.cos, torch.cos)

    def invert(self):
        return self._unary(lambda x: 1.0 / x, lambda v: 1.0 / v)

    def abs(self):
        return self._unary(abs, torch.abs)

    def is_nan(self):
        """1.0 where NaN else 0.0."""
        return self._unary(
            lambda x: 1.0 if math.isnan(x) else 0.0,
            lambda v: torch.isnan(v).to(FLOAT_DTYPE),
        )

    def average(self) -> "RandomVariableTorch":
        """The mean as a deterministic RandomVariable."""
        return self._of(self._time, self.get_average())

    # ------------------------------------------------------------------
    # binary ops with scalars
    # ------------------------------------------------------------------
    def _scalar_op(self, value: float, scalar_fn, array_fn) -> "RandomVariableTorch":
        value = float(value)
        if self.is_deterministic():
            return self._of(self._time, _det_eval(scalar_fn, self._values, value))
        return self._of(self._time, array_fn(self._values, value))

    def cap(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, min, _minimum, "cap")
        return self._scalar_op(other, min, _minimum)

    def floor(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, max, _maximum, "floor")
        return self._scalar_op(other, max, _maximum)

    def add(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, lambda a, b: a + b, lambda a, b: a + b, "add")
        return self._scalar_op(other, lambda a, b: a + b, lambda a, b: a + b)

    def sub(self, other):
        if isinstance(other, RandomVariable):
            return self._binary(other, lambda a, b: a - b, lambda a, b: a - b, "sub")
        return self._scalar_op(other, lambda a, b: a - b, lambda a, b: a - b)

    def bus(self, other):
        """Reverse subtraction: other - self."""
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
        """Reverse division: other / self."""
        if isinstance(other, RandomVariable):
            return self._binary(other, lambda a, b: b / a, lambda a, b: b / a, "vid")
        return self._scalar_op(other, lambda a, b: b / a, lambda a, b: b / a)

    def pow(self, exponent: float):
        exponent = float(exponent)
        return self._unary(
            lambda x: np.power(x, exponent), lambda v: torch.pow(v, exponent)
        )

    # ------------------------------------------------------------------
    # binary ops with random variables (type-priority dispatch)
    # ------------------------------------------------------------------
    _FLIP = {"add": "add", "mult": "mult", "cap": "cap", "floor": "floor",
             "sub": "bus", "bus": "sub", "div": "vid", "vid": "div"}

    def _binary(self, other, scalar_fn, array_fn, name: str) -> "RandomVariableTorch":
        if self._defer(other):
            # delegate to the higher-priority implementation, flipping the
            # operation for non-commutative ops
            return getattr(other, self._FLIP[name])(self)
        new_time = self._new_time(other)
        o_det, o_vals = self._dev(other)
        if self.is_deterministic() and o_det:
            return self._of(new_time, _det_eval(scalar_fn, self._values, o_vals))
        return self._of(new_time, array_fn(self._values, o_vals), other)

    # ------------------------------------------------------------------
    # fused financial ops (ref. the accrue/discount/addProduct kernels)
    # ------------------------------------------------------------------
    def accrue(self, rate: "RandomVariable", period_length: float):
        """self * (1 + rate * periodLength)."""
        if self._defer(rate):
            return rate.mult(period_length).add(1.0).mult(self)
        if isinstance(rate, RandomVariable):
            new_time = max(self._time, rate.get_filtration_time())
            r_det, r = self._dev(rate)
        else:
            new_time, r_det, r = self._time, True, float(rate)
        p = float(period_length)
        if self.is_deterministic() and r_det:
            return self._of(new_time, float(self._values) * (1.0 + float(r) * p))
        return self._of(new_time, self._values * (1.0 + r * p), rate)

    def discount(self, rate: "RandomVariable", period_length: float):
        """self / (1 + rate * periodLength)."""
        if self._defer(rate):
            return rate.mult(period_length).add(1.0).vid(self)
        if isinstance(rate, RandomVariable):
            new_time = max(self._time, rate.get_filtration_time())
            r_det, r = self._dev(rate)
        else:
            new_time, r_det, r = self._time, True, float(rate)
        p = float(period_length)
        if self.is_deterministic() and r_det:
            return self._of(
                new_time,
                _det_eval(lambda s, rr: s / (1.0 + rr * p), self._values, r))
        return self._of(new_time, self._values / (1.0 + r * p), rate)

    def add_product(self, factor1: "RandomVariable", factor2):
        """self + factor1 * factor2 (factor2 scalar or RV)."""
        if self._defer(factor1) or (
            isinstance(factor2, RandomVariable) and self._defer(factor2)
        ):
            return factor1.mult(factor2).add(self)
        new_time = max(self._time, factor1.get_filtration_time())
        f1_det, f1 = self._dev(factor1)
        if isinstance(factor2, RandomVariable):
            new_time = max(new_time, factor2.get_filtration_time())
            f2_det, f2 = self._dev(factor2)
        else:
            f2_det, f2 = True, float(factor2)
        if self.is_deterministic() and f1_det and f2_det:
            return self._of(new_time, float(self._values) + float(f1) * float(f2))
        return self._of(new_time, self._values + f1 * f2, factor1, factor2)

    def add_ratio(self, numerator: "RandomVariable", denominator: "RandomVariable"):
        """self + numerator / denominator."""
        if self._defer(numerator) or self._defer(denominator):
            return self.add(numerator.div(denominator))
        return self._ratio(numerator, denominator, +1.0)

    def sub_ratio(self, numerator: "RandomVariable", denominator: "RandomVariable"):
        """self - numerator / denominator."""
        if self._defer(numerator) or self._defer(denominator):
            return self.sub(numerator.div(denominator))
        return self._ratio(numerator, denominator, -1.0)

    def _ratio(self, numerator, denominator, sign: float):
        new_time = max(
            self._time,
            numerator.get_filtration_time(),
            denominator.get_filtration_time(),
        )
        n_det, n = self._dev(numerator)
        d_det, d = self._dev(denominator)
        if self.is_deterministic() and n_det and d_det:
            return self._of(
                new_time,
                _det_eval(lambda s, nn, dd: s + sign * nn / dd,
                          self._values, n, d))
        return self._of(new_time, self._values + sign * (n / d), numerator,
                        denominator)

    def add_sum_product(
        self,
        factors1: Sequence["RandomVariable"],
        factors2: Sequence["RandomVariable"],
    ):
        """self + sum_i factors1[i] * factors2[i]."""
        result = self
        for f1, f2 in zip(factors1, factors2):
            result = result.add_product(f1, f2)
        return result

    def choose(self, value_if_nonneg: "RandomVariable", value_if_neg: "RandomVariable"):
        """Elementwise ternary on the sign of self (trigger), branch-free
        as Longstaff-Schwartz needs it."""
        if self._defer(value_if_nonneg) or self._defer(value_if_neg):
            # delegate: trigger >= 0 ? a : b with higher-priority operands
            return value_if_nonneg.mult(self.ge_zero()).add_product(
                value_if_neg, self.ge_zero().bus(1.0)
            )
        new_time = max(
            self._time,
            value_if_nonneg.get_filtration_time(),
            value_if_neg.get_filtration_time(),
        )
        if self.is_deterministic():
            chosen = value_if_nonneg if float(self._values) >= 0 else value_if_neg
            return self._of(new_time, self._dev(chosen)[1], chosen)
        _, a = self._dev(value_if_nonneg)
        _, b = self._dev(value_if_neg)
        dev = self._values.device
        a = torch.as_tensor(a, dtype=FLOAT_DTYPE, device=dev)
        b = torch.as_tensor(b, dtype=FLOAT_DTYPE, device=dev)
        return self._of(new_time, torch.where(self._values >= 0, a, b),
                        value_if_nonneg, value_if_neg)

    def ge_zero(self):
        """Indicator of self >= 0 (helper used by choose delegation)."""
        return self._unary(
            lambda x: 1.0 if x >= 0 else 0.0,
            lambda v: (v >= 0).to(FLOAT_DTYPE),
        )

    # ------------------------------------------------------------------
    # apply: the callable runs on the operands' tensors (torch operations)
    # ------------------------------------------------------------------
    def apply(self, function: Callable, *args: "RandomVariable"):
        operands = [(self.is_deterministic(), self._values)] + \
            [self._dev(a) for a in args]
        new_time = max([self._time] + [a.get_filtration_time() for a in args])
        if all(det for det, _ in operands):
            return self._of(new_time,
                            float(function(*[float(v) for _, v in operands])))
        out = function(*[v for _, v in operands])
        dev = next(v.device for det, v in operands if not det)
        return self._of(new_time,
                        torch.as_tensor(out, dtype=FLOAT_DTYPE, device=dev),
                        *args)

    # ------------------------------------------------------------------
    # reductions: float32 input, float64 accumulation
    # ------------------------------------------------------------------
    def _acc(self) -> torch.Tensor:
        return self._values.to(ACC_DTYPE)

    def get_average(self, probabilities: "RandomVariable" = None) -> float:
        if probabilities is not None:
            # expectation under the given measure: sum(x_i * p_i), no 1/n
            mesh = _joint_mesh(self, probabilities)
            p_det, p = self._dev(probabilities)
            if self.is_deterministic():
                if p_det:
                    return float(self._values) * float(p)
                return float(self._values) * float(self._global(
                    torch.sum(p, dtype=ACC_DTYPE), mesh=mesh))
            if p_det:
                return float(p) * float(self._global(
                    torch.sum(self._values, dtype=ACC_DTYPE)))
            return float(self._global(
                torch.sum(self._acc() * p.to(ACC_DTYPE)), mesh=mesh))
        if self.is_deterministic():
            return float(self._values)
        return float(self._global(
            torch.sum(self._values, dtype=ACC_DTYPE))) / self.size()

    def get_variance(self, probabilities: "RandomVariable" = None) -> float:
        if self.is_deterministic():
            return 0.0
        if probabilities is not None:
            mean = self.get_average(probabilities)
            _, p = self._dev(probabilities)
            dev = self._acc() - mean
            return float(self._global(torch.sum(dev * dev * torch.as_tensor(
                p, dtype=ACC_DTYPE, device=dev.device)),
                mesh=_joint_mesh(self, probabilities)))
        mean = self.get_average()
        dev = self._acc() - mean
        return float(self._global(torch.sum(dev * dev))) / self.size()

    def get_sample_variance(self) -> float:
        n = self.size()
        if n == 1 or self.is_deterministic():
            return 0.0
        return self.get_variance() * n / (n - 1)

    def get_standard_deviation(self, probabilities: "RandomVariable" = None) -> float:
        if self.is_deterministic():
            return 0.0
        return math.sqrt(self.get_variance(probabilities))

    def get_standard_error(self, probabilities: "RandomVariable" = None) -> float:
        if self.is_deterministic():
            return 0.0
        return self.get_standard_deviation(probabilities) / math.sqrt(self.size())

    def get_min(self) -> float:
        if self.is_deterministic():
            return float(self._values)
        return float(self._global(torch.min(self._values), "min"))

    def get_max(self) -> float:
        if self.is_deterministic():
            return float(self._values)
        return float(self._global(torch.max(self._values), "max"))

    def get_quantile(self, quantile: float, probabilities: "RandomVariable" = None) -> float:
        """Sorted on the device (under a mesh: the gathered
        realizations)."""
        if self.is_deterministic():
            return float(self._values)
        if self.mesh is not None:
            if isinstance(probabilities, RandomVariableTorch):
                probabilities = probabilities._gathered()
            return self._gathered().get_quantile(quantile, probabilities)
        if probabilities is not None:
            order = torch.argsort(self._values)
            p_det, p = self._dev(probabilities)
            if p_det:
                pv = torch.full((self.size(),), float(p), dtype=ACC_DTYPE,
                                device=self._values.device)
            else:
                pv = p[order].to(ACC_DTYPE)
            cum = torch.cumsum(pv, dim=0)
            idx = int(torch.searchsorted(
                cum, torch.tensor([quantile], dtype=ACC_DTYPE,
                                  device=cum.device))[0])
            idx = min(max(idx, 0), self.size() - 1)
            return float(self._values[order[idx]])
        sorted_vals = torch.sort(self._values).values
        return float(sorted_vals[quantile_index(self.size(), quantile)])

    def get_quantile_expectation(self, q_start: float, q_end: float) -> float:
        """Average of realizations between two quantiles (inclusive),
        finmath convention."""
        if self.is_deterministic():
            return float(self._values)
        if self.mesh is not None:
            return self._gathered().get_quantile_expectation(q_start, q_end)
        if q_start > q_end:
            return self.get_quantile_expectation(q_end, q_start)
        n = self.size()
        lo = quantile_index(n, q_start)
        hi = quantile_index(n, q_end)
        sorted_vals = torch.sort(self._values).values
        return float(torch.sum(sorted_vals[lo:hi + 1], dtype=ACC_DTYPE)) \
            / (hi - lo + 1)

    def get_histogram(self, interval_points=None, number_of_points: int = None,
                      standard_deviations: float = None):
        """Histogram frequencies (normalized by size).

        Two forms as in finmath: explicit interval points -> array of
        len(points)+1 frequencies (outer bins are open); or
        (numberOfPoints, standardDeviations) -> [2][n] array of mid points
        and frequencies. Under a mesh: of the gathered realizations.
        """
        if self.mesh is not None and not self.is_deterministic():
            return self._gathered().get_histogram(
                interval_points, number_of_points, standard_deviations)
        if interval_points is not None:
            pts = np.asarray(interval_points, dtype=np.float64)
            if self.is_deterministic():
                counts = np.zeros(len(pts) + 1)
                counts[int(np.searchsorted(pts, float(self._values), side="right"))] = 1.0
                return counts
            pts_t = torch.as_tensor(pts, device=self._values.device)
            idx = torch.searchsorted(pts_t, self._acc(), right=True)
            counts = torch.bincount(idx, minlength=len(pts) + 1)
            return counts.cpu().numpy().astype(np.float64) / self.size()
        # (numberOfPoints, standardDeviations) form
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
        """Delegates to a regression estimator (Longstaff-Schwartz,
        ``ops.conditional_expectation``), ref.
        RandomVariableFromFloatArray.java:860-864."""
        return estimator.get_conditional_expectation(self)

    # ------------------------------------------------------------------
    # Python operator sugar
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

    # ------------------------------------------------------------------
    # serialization: realizations round-trip through the host and come
    # back on the device they left
    # ------------------------------------------------------------------
    def __getstate__(self):
        if self.is_deterministic():
            device = None if self._device is None else str(self._device)
            return {"time": self._time, "values": self._values,
                    "device": device}
        return {"time": self._time, "values": self.get_realizations(),
                "device": str(self._values.device)}

    def __setstate__(self, state):
        self._time = state["time"]
        v = state["values"]
        device = state["device"]
        if _is_scalar(v):
            self._values = v
            self._device = None if device is None else torch.device(device)
        else:
            self._values = torch.as_tensor(v).to(device)
            self._device = None


install_camel_aliases(RandomVariableTorch)


class RandomVariableTorchFactory:
    """The injection point (ref. RandomVariableCudaFactory.java:18-35):
    models built with this factory execute per-path arithmetic on
    ``device`` (default ``select_device()``)."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None

    def create_random_variable(self, time: float, values) -> RandomVariableTorch:
        return RandomVariableTorch(time, values, device=self.device)

    # finmath-style aliases
    createRandomVariable = create_random_variable

    def create_random_variable_from_array(self, time: float, values) -> RandomVariableTorch:
        return RandomVariableTorch(time, values, device=self.device)

    def __repr__(self):
        return f"RandomVariableTorchFactory(device={self.device})"
