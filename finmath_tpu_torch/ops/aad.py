"""Adjoint algorithmic differentiation (AAD) over the port's random
variables.

Counterpart of ``finmath_tpu.ops.aad``: finmath's
``RandomVariableDifferentiableAAD`` on the vector engine. A wrapper with a
higher type priority (the reference's ordering float oracle < device < AAD:
a mixed operation promotes to the differentiable type), an operator tape,
and ``get_gradient()``, whose reverse sweep runs on ``RandomVariableTorch``
so that every adjoint is computed on the variables' device, in float32
paths with float64 reductions, the engine's contract.

The tape is finmath's, not ``torch.autograd``: it serves the eager,
finmath-style workflow, where a user composes random variables and then
asks any result for its gradient, and the priority dispatch that routes a
mixed expression into it. For a pricer written as one function of tensors,
``torch.autograd`` is the tool (``models.black_scholes.
mc_european_call_price_differentiable``).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence

from ._api import TYPE_PRIORITY_AAD, install_camel_aliases
from .random_variable import RandomVariable, RandomVariableTorch

_id_counter = itertools.count()


def _torch(x, like: RandomVariableTorch = None) -> RandomVariableTorch:
    """``x`` as a ``RandomVariableTorch``; host realizations go to the
    device of ``like``."""
    if isinstance(x, RandomVariableDifferentiable):
        return x.values
    if isinstance(x, RandomVariable):
        if isinstance(x, RandomVariableTorch) or x.is_deterministic():
            return RandomVariableTorch.from_random_variable(x)
        return RandomVariableTorch.from_random_variable(
            x, like.device if like is not None else None)
    return RandomVariableTorch(0.0, float(x))


def _unwrap(x):
    return x if isinstance(x, RandomVariableDifferentiable) else None


class RandomVariableDifferentiable(RandomVariable):
    """A random variable that records the operations applied to it.

    ``values`` is the underlying ``RandomVariableTorch``;
    ``get_gradient()`` returns {leaf id: dV/dleaf} with every adjoint
    computed on the device."""

    __slots__ = ("_values", "_id", "_parents", "_vjps")

    _TYPE_PRIORITY = TYPE_PRIORITY_AAD

    def __init__(self, values, time: float = 0.0,
                 _parents: Sequence["RandomVariableDifferentiable"] = (),
                 _vjps: Sequence[Callable] = (), device=None):
        if isinstance(values, RandomVariableTorch):
            self._values = values
        elif isinstance(values, RandomVariable):
            self._values = RandomVariableTorch.from_random_variable(
                values, device)
        else:
            self._values = RandomVariableTorch(time, values, device=device)
        self._id = next(_id_counter)
        self._parents = tuple(_parents)
        self._vjps = tuple(_vjps)

    # ------------------------------------------------------------------
    @property
    def values(self) -> RandomVariableTorch:
        return self._values

    def get_id(self) -> int:
        return self._id

    def get_type_priority(self) -> int:
        return self._TYPE_PRIORITY

    def get_filtration_time(self) -> float:
        return self._values.get_filtration_time()

    def is_deterministic(self) -> bool:
        return self._values.is_deterministic()

    def size(self) -> int:
        return self._values.size()

    def double_value(self) -> float:
        return self._values.double_value()

    def get_realizations(self):
        return self._values.get_realizations()

    def get_average(self, probabilities=None) -> float:
        return self._values.get_average(probabilities)

    def get_variance(self, probabilities=None) -> float:
        return self._values.get_variance(probabilities)

    def get_standard_deviation(self, probabilities=None) -> float:
        return self._values.get_standard_deviation(probabilities)

    def get_standard_error(self, probabilities=None) -> float:
        return self._values.get_standard_error(probabilities)

    def get_min(self) -> float:
        return self._values.get_min()

    def get_max(self) -> float:
        return self._values.get_max()

    def get_quantile(self, q, probabilities=None) -> float:
        return self._values.get_quantile(q, probabilities)

    def get_sample_variance(self) -> float:
        return self._values.get_sample_variance()

    def get_quantile_expectation(self, q_start: float, q_end: float) -> float:
        return self._values.get_quantile_expectation(q_start, q_end)

    def get_histogram(self, *args, **kwargs):
        return self._values.get_histogram(*args, **kwargs)

    def get_operator(self):
        return self._values.get_operator()

    def get_realizations_stream(self):
        return self._values.get_realizations_stream()

    def equals(self, other) -> bool:
        return self._values.equals(_torch(other, self._values))

    def apply(self, function, *args):
        """Elementwise apply on the underlying values. The result enters
        the tape as a constant (no gradient edge): an arbitrary function
        has no registered vjp, as in finmath, whose AAD class inherits
        apply from the plain implementation."""
        return RandomVariableDifferentiable(self._values.apply(
            function, *[_torch(a, self._values) for a in args]))

    def __repr__(self):
        return f"RandomVariableDifferentiable(id={self._id}, {self._values!r})"

    # ------------------------------------------------------------------
    # tape construction
    # ------------------------------------------------------------------
    @staticmethod
    def _record(result: RandomVariableTorch, operands, vjps):
        parents, kept_vjps = [], []
        for op, vjp in zip(operands, vjps):
            n = _unwrap(op)
            if n is not None:
                parents.append(n)
                kept_vjps.append(vjp)
        return RandomVariableDifferentiable(result, _parents=parents,
                                            _vjps=kept_vjps)

    def _operand(self, other) -> RandomVariableTorch:
        return _torch(other, self._values)

    # unary -------------------------------------------------------------
    def _unary_op(self, fn, dfn):
        x = self._values
        return self._record(fn(x), (self,),
                            ((lambda a, xx=x: a.mult(dfn(xx))),))

    def exp(self):
        return self._unary_op(lambda x: x.exp(), lambda x: x.exp())

    def log(self):
        return self._unary_op(lambda x: x.log(), lambda x: x.invert())

    def sqrt(self):
        return self._unary_op(
            lambda x: x.sqrt(), lambda x: x.sqrt().invert().mult(0.5))

    def squared(self):
        return self._unary_op(lambda x: x.squared(), lambda x: x.mult(2.0))

    def invert(self):
        return self._unary_op(
            lambda x: x.invert(), lambda x: x.squared().invert().mult(-1.0))

    def abs(self):
        return self._unary_op(
            lambda x: x.abs(), lambda x: x.ge_zero().mult(2.0).sub(1.0))

    def sin(self):
        return self._unary_op(lambda x: x.sin(), lambda x: x.cos())

    def cos(self):
        return self._unary_op(lambda x: x.cos(), lambda x: x.sin().mult(-1.0))

    def pow(self, exponent: float):
        e = float(exponent)
        return self._unary_op(
            lambda x: x.pow(e), lambda x: x.pow(e - 1.0).mult(e))

    # binary ------------------------------------------------------------
    def add(self, other):
        a, b = self._values, self._operand(other)
        return self._record(a.add(b), (self, other),
                            (lambda g: g, lambda g: g))

    def sub(self, other):
        a, b = self._values, self._operand(other)
        return self._record(a.sub(b), (self, other),
                            (lambda g: g, lambda g: g.mult(-1.0)))

    def bus(self, other):
        a, b = self._values, self._operand(other)
        return self._record(a.bus(b), (self, other),
                            (lambda g: g.mult(-1.0), lambda g: g))

    def mult(self, other):
        a, b = self._values, self._operand(other)
        return self._record(a.mult(b), (self, other),
                            (lambda g, bb=b: g.mult(bb),
                             lambda g, aa=a: g.mult(aa)))

    def div(self, other):
        a, b = self._values, self._operand(other)
        return self._record(
            a.div(b), (self, other),
            (lambda g, bb=b: g.div(bb),
             lambda g, aa=a, bb=b: g.mult(aa).div(bb.squared()).mult(-1.0)))

    def vid(self, other):
        a, b = self._values, self._operand(other)
        return self._record(
            a.vid(b), (self, other),
            (lambda g, aa=a, bb=b: g.mult(bb).div(aa.squared()).mult(-1.0),
             lambda g, aa=a: g.div(aa)))

    def cap(self, other):
        a, b = self._values, self._operand(other)
        mask = a.sub(b).ge_zero()  # 1 where a >= b (b is the min there)
        return self._record(a.cap(b), (self, other),
                            (lambda g, m=mask: g.mult(m.bus(1.0)),
                             lambda g, m=mask: g.mult(m)))

    def floor(self, other):
        a, b = self._values, self._operand(other)
        mask = a.sub(b).ge_zero()  # 1 where a >= b (a survives the floor)
        return self._record(a.floor(b), (self, other),
                            (lambda g, m=mask: g.mult(m),
                             lambda g, m=mask: g.mult(m.bus(1.0))))

    def accrue(self, rate, period_length: float):
        a, r = self._values, self._operand(rate)
        p = float(period_length)
        return self._record(a.accrue(r, p), (self, rate),
                            (lambda g, rr=r: g.mult(rr.mult(p).add(1.0)),
                             lambda g, aa=a: g.mult(aa).mult(p)))

    def discount(self, rate, period_length: float):
        a, r = self._values, self._operand(rate)
        p = float(period_length)
        denom = r.mult(p).add(1.0)
        return self._record(
            a.div(denom), (self, rate),
            (lambda g, d=denom: g.div(d),
             lambda g, aa=a, d=denom: g.mult(aa).mult(-p).div(d.squared())))

    def add_product(self, f1, f2):
        a, b, c = self._values, self._operand(f1), self._operand(f2)
        return self._record(a.add_product(b, c), (self, f1, f2),
                            (lambda g: g,
                             lambda g, cc=c: g.mult(cc),
                             lambda g, bb=b: g.mult(bb)))

    def add_ratio(self, num, den):
        return self.add(_wrap(num, self._values).div(den))

    def sub_ratio(self, num, den):
        return self.sub(_wrap(num, self._values).div(den))

    def add_sum_product(self, f1s, f2s):
        out = self
        for f1, f2 in zip(f1s, f2s):
            out = out.add_product(f1, f2)
        return out

    def choose(self, v_pos, v_neg):
        """The trigger's derivative is zero almost everywhere (an
        indicator), finmath's AAD convention (without its optional
        smoothing)."""
        t = self._values
        a, b = self._operand(v_pos), self._operand(v_neg)
        mask = t.ge_zero()
        return self._record(t.choose(a, b), (self, v_pos, v_neg),
                            (lambda g: g.mult(0.0),
                             lambda g, m=mask: g.mult(m),
                             lambda g, m=mask: g.mult(m.bus(1.0))))

    def ge_zero(self):
        """Indicator (no derivative, like the choose trigger)."""
        return self._record(self._values.ge_zero(), (self,),
                            ((lambda g: g.mult(0.0)),))

    def is_nan(self):
        return RandomVariableDifferentiable(self._values.is_nan())

    def cache(self):
        self._values.cache()
        return self

    def get(self, index: int) -> float:
        return self._values.get(index)

    def average(self):
        n = self.size()
        out = RandomVariableTorch(self.get_filtration_time(),
                                  self._values.get_average())
        return self._record(out, (self,),
                            ((lambda g, nn=n: g.mult(1.0 / nn)),))

    def expectation(self):
        return self.average()

    def get_conditional_expectation(self, estimator):
        """The regression enters the tape as the identity (the standard
        Longstaff-Schwartz AAD approximation)."""
        fitted = estimator.get_conditional_expectation(self._values)
        return self._record(fitted, (self,), ((lambda g: g),))

    # operator sugar ----------------------------------------------------
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

    def __pow__(self, e):
        return self.pow(e)

    def __neg__(self):
        return self.mult(-1.0)

    # ------------------------------------------------------------------
    # reverse sweep
    # ------------------------------------------------------------------
    def get_gradient(self, independents: Optional[
            Sequence["RandomVariableDifferentiable"]] = None
            ) -> Dict[int, RandomVariableTorch]:
        """Adjoints of this (scalar or vector) variable with respect to
        tape nodes: {node id: adjoint RandomVariableTorch}. With
        ``independents``, only their ids are returned (the whole sweep
        runs); without, the leaves'."""
        # topological order by an iterative depth-first search
        order: List[RandomVariableDifferentiable] = []
        seen = set()
        stack = [(self, False)]
        while stack:
            n, processed = stack.pop()
            if processed:
                order.append(n)
                continue
            if n._id in seen:
                continue
            seen.add(n._id)
            stack.append((n, True))
            for p in n._parents:
                if p._id not in seen:
                    stack.append((p, False))

        adjoint: Dict[int, RandomVariableTorch] = {
            self._id: RandomVariableTorch(self.get_filtration_time(), 1.0)}
        for n in reversed(order):
            g = adjoint.get(n._id)
            if g is None:
                continue
            for parent, vjp in zip(n._parents, n._vjps):
                contrib = vjp(g)
                # a deterministic operand was broadcast across paths in the
                # forward pass: its adjoint is the sum over the paths
                if parent.is_deterministic() and not contrib.is_deterministic():
                    total = contrib.get_average() * contrib.size()
                    contrib = RandomVariableTorch(
                        contrib.get_filtration_time(), total)
                acc = adjoint.get(parent._id)
                adjoint[parent._id] = contrib if acc is None else acc.add(contrib)

        if independents is not None:
            wanted = {n._id for n in independents}
            return {i: v for i, v in adjoint.items() if i in wanted}
        leaf_ids = {n._id for n in order if not n._parents}
        return {i: v for i, v in adjoint.items() if i in leaf_ids}

    getGradient = get_gradient


def _wrap(x, like: RandomVariableTorch = None) -> RandomVariableDifferentiable:
    if isinstance(x, RandomVariableDifferentiable):
        return x
    return RandomVariableDifferentiable(_torch(x, like))


class RandomVariableDifferentiableFactory:
    """Factory of differentiable random variables: inject it to make a
    whole valuation differentiable. Host values go to ``device`` (default
    ``select_device()``)."""

    def __init__(self, device=None):
        self.device = device

    def create_random_variable(self, time: float, values) -> RandomVariableDifferentiable:
        return RandomVariableDifferentiable(
            RandomVariableTorch(time, values, device=self.device))

    createRandomVariable = create_random_variable


install_camel_aliases(RandomVariableDifferentiable)
