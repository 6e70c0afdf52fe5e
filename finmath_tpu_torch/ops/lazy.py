"""Lazy execution for the RandomVariable API: record operations, flush one
program.

Counterpart of ``finmath_tpu.ops.lazy``. Every operation on a
:class:`RandomVariableTorchLazy` records a node of an expression DAG
instead of launching kernels; the DAG is flushed where a concrete value is
needed: reductions (``get_average``...), ``get_realizations``, ``get(i)``,
``equals``, ``cache()``, pickling, the ``values`` property, or
:func:`flush` / :func:`averages` on many variables at once.

A flush on the card runs one CUDA graph per DAG structure. Programs are
cached by structure: the node functions, the wiring, the leaves' shapes,
dtypes and device. Scalars are runtime inputs, so ``x.mult(2).add(1)`` and
``x.mult(3).add(7)`` replay one graph. A graph is captured on a side
stream after one warm-up run, reads static leaf and scalar tensors that
each flush copies into, keeps the float64 reductions inside, and its
outputs are copied out after the replay (the host reads a reduction's
float then). Device memory stays bounded however many structures a
valuation records: all graphs share one memory pool, all read one set of
static input tensors (one per leaf slot, shape and dtype, since each flush
copies its inputs in before the replay), and at most ``MAX_LIVE_GRAPHS``
graphs hold a capture; the least recently replayed one beyond that is
released and captured again at its next use. If the capture fails the
flush raises: there is no quiet eager replay on the card. On the CPU there
is no graph; the DAG is evaluated in one pass.

Numerical contract: a flush runs the eager type's own array functions
(``RandomVariableTorch``'s lambdas, ``_exp_rounded``, ``_minimum``...),
so lazy and eager agree bit for bit on every chain. A runtime scalar on
the card is a float32 device tensor wrapped in :class:`_Scalar`, which
reproduces the eager kernels' handling of a host scalar: PyTorch divides a
CUDA tensor by a host scalar as a product with the float32 reciprocal, and
a host scalar by a tensor as the tensor's reciprocal times the scalar.

Type priority: LAZY (25) sits between the device type (20) and AAD (30);
one lazy operand makes a mixed expression lazy, AAD outranks both. The JAX
package's pytree registration has no counterpart: where a lazy variable
meets code that needs a tensor, ``values`` flushes.
"""

from __future__ import annotations

import operator
import threading
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from ._api import install_camel_aliases
from .random_variable import (ACC_DTYPE, FLOAT_DTYPE, RandomVariable,
                              RandomVariableTorch)

TYPE_PRIORITY_LAZY = 25

#: captures and replays of flush graphs on the card (a check can tell that
#: a flush went through a graph)
GRAPH_COUNTS = {"captures": 0, "replays": 0}

#: most flush graphs that hold a capture (and their outputs in the pool)
MAX_LIVE_GRAPHS = 64


# ---------------------------------------------------------------------------
# expression DAG
# ---------------------------------------------------------------------------

class LazyArray:
    """One deferred elementwise computation producing a [paths] float32
    tensor (or a reduction of one).

    ``args`` holds child nodes, concrete tensors (leaves) and Python floats
    (runtime scalars). ``fn`` is the array function applied at flush time;
    the program cache keys on its code object and closure constants, so the
    class-level lambdas of ``RandomVariableTorch`` (fresh objects, shared
    code) hit the same entry."""

    __slots__ = ("fn", "args", "shape", "device", "value")

    def __init__(self, fn: Callable, args: tuple, shape: tuple, device):
        self.fn = fn
        self.args = args
        self.shape = shape
        self.device = device
        self.value = None          # set once materialized

    # operator sugar, so that the eager type's inline expressions
    # (accrue, discount, add_product, ...) stay lazy unchanged
    def __add__(self, o):
        return node(operator.add, self, o)

    def __radd__(self, o):
        return node(operator.add, o, self)

    def __sub__(self, o):
        return node(operator.sub, self, o)

    def __rsub__(self, o):
        return node(operator.sub, o, self)

    def __mul__(self, o):
        return node(operator.mul, self, o)

    def __rmul__(self, o):
        return node(operator.mul, o, self)

    def __truediv__(self, o):
        return node(operator.truediv, self, o)

    def __rtruediv__(self, o):
        return node(operator.truediv, o, self)

    def __neg__(self):
        return node(operator.neg, self)


def node(fn: Callable, *args) -> LazyArray:
    """A DAG node; its shape and device are those of the first array
    argument (every operation of the API is elementwise over paths)."""
    for a in args:
        if isinstance(a, LazyArray):
            return LazyArray(fn, args, a.shape, a.device)
        if isinstance(a, torch.Tensor):
            return LazyArray(fn, args, tuple(a.shape), a.device)
    return LazyArray(fn, args, (), None)


def _fn_key(fn: Callable):
    """Structural identity of an array function: code object and closure
    constants for Python functions (closures carry floats like the pow
    exponent), the object itself for builtins."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn
    cells = fn.__closure__ or ()
    try:
        key = (code, tuple(c.cell_contents for c in cells))
        hash(key)
        return key
    except TypeError:          # unhashable closure
        return (code, id(fn))


class _Scalar:
    """A runtime scalar of a flush graph: a float32 device tensor ``t`` and
    its float32 reciprocal ``inv``, standing in for a Python float with the
    same arithmetic as PyTorch's CUDA kernels give a host scalar."""

    __slots__ = ("t", "inv")

    _DIV = {"div", "divide", "true_divide", "__truediv__", "__div__"}
    _RDIV = {"__rtruediv__", "__rdiv__"}

    def __init__(self, t: torch.Tensor, inv: torch.Tensor):
        self.t, self.inv = t, inv

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if (len(args) == 2 and isinstance(args[1], _Scalar)
                and isinstance(args[0], torch.Tensor) and not kwargs):
            if name in cls._DIV:          # tensor / scalar
                return args[0] * args[1].inv
            if name in cls._RDIV:         # scalar / tensor
                return args[0].reciprocal() * args[1].t
        args = [a.t if isinstance(a, _Scalar) else a for a in args]
        return func(*args, **kwargs)

    # the scalar on the left of a Python operator, a tensor on the right
    # (the eager type's expressions put no scalar on the right of another)
    def __add__(self, o):
        return o + self.t

    def __mul__(self, o):
        return o * self.t

    def __sub__(self, o):
        return torch.sub(self.t, o)

    def __truediv__(self, o):
        return o.reciprocal() * self.t


def _evaluate(plan, root_sig, leaf_vals, scalar_vals) -> list:
    """Run a program's nodes in post-order; the roots' values."""
    vals = []
    for f, arg_plan in plan:
        vals.append(f(*(vals[i] if t == "n" else
                        leaf_vals[i] if t == "l" else scalar_vals[i]
                        for (t, i) in arg_plan)))
    return [vals[i] if isinstance(i, int) else None for i in root_sig]


class _HostProgram:
    """A flush program on the CPU: one pass over the DAG."""

    def __init__(self, plan, root_sig):
        self.plan, self.root_sig = plan, root_sig

    def __call__(self, leaves, scalars):
        return _evaluate(self.plan, self.root_sig, leaves, scalars)


_POOLS: dict = {}
_STATIC: dict = {}                 # (device, shape, dtype, slot) -> tensor
_LIVE: OrderedDict = OrderedDict()  # captured programs, least recent first


def _static_input(device, shape, dtype, slot) -> torch.Tensor:
    """The graphs' shared input tensor of one leaf (or scalar) slot."""
    key = (str(device), tuple(shape), dtype, slot)
    buf = _STATIC.get(key)
    if buf is None:
        buf = _STATIC[key] = torch.empty(shape, dtype=dtype, device=device)
    return buf


class _GraphProgram:
    """A flush program on the card: one CUDA graph over static inputs."""

    def __init__(self, plan, root_sig, leaves, n_scalars, device):
        self.plan, self.root_sig = plan, root_sig
        self.leaves = [_static_input(device, v.shape, v.dtype, j)
                       for j, v in enumerate(leaves)]
        self.n = n_scalars
        buf = _static_input(device, (max(2 * n_scalars, 1),), FLOAT_DTYPE,
                            "scalars")
        self.scalar_buf = buf
        self.scalars = [_Scalar(buf[i], buf[n_scalars + i])
                        for i in range(n_scalars)]
        self.device = device
        self.graph = None
        self.outs = None

    def _load(self, leaves, scalars):
        for dst, src in zip(self.leaves, leaves):
            dst.copy_(src)
        if self.n:
            s = np.asarray(scalars, dtype=np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = np.float32(1.0) / s
            self.scalar_buf.copy_(torch.from_numpy(np.concatenate([s, inv])))

    def _capture(self):
        while len(_LIVE) >= MAX_LIVE_GRAPHS:
            _LIVE.popitem(last=False)[1].release()
        run = lambda: _evaluate(self.plan, self.root_sig, self.leaves,  # noqa: E731
                                self.scalars)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            run()                                      # warm-up
        current.wait_stream(side)
        pool = _POOLS.get(self.device)
        if pool is None:
            pool = _POOLS[self.device] = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            self.outs = run()
        self.graph = graph
        _LIVE[id(self)] = self
        GRAPH_COUNTS["captures"] += 1

    def release(self):
        """Drop the capture; its outputs' blocks go back to the pool."""
        self.graph = self.outs = None

    def __call__(self, leaves, scalars):
        self._load(leaves, scalars)
        if self.graph is None:
            self._capture()
        else:
            _LIVE.move_to_end(id(self))
        self.graph.replay()
        GRAPH_COUNTS["replays"] += 1
        return [None if o is None else o.clone() for o in self.outs]


_PROGRAM_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()


def _flush(roots) -> list:
    """Materialize every root with one program (cached by DAG structure).
    Materialized nodes act as leaves, so a later flush reuses earlier
    results instead of recomputing the prefix."""
    post: list = []
    index: dict = {}

    # iterative post-order (deep Euler chains overflow the recursion limit)
    for root in roots:
        if not isinstance(root, LazyArray) or root.value is not None:
            continue
        stack = [(root, False)]
        while stack:
            n, expanded = stack.pop()
            if id(n) in index:
                continue
            if expanded:
                index[id(n)] = len(post)
                post.append(n)
            else:
                stack.append((n, True))
                for a in n.args:
                    if isinstance(a, LazyArray) and a.value is None \
                            and id(a) not in index:
                        stack.append((a, False))

    if not post:
        return [r.value if isinstance(r, LazyArray) else r for r in roots]

    leaves: list = []
    leaf_ids: dict = {}
    scalars: list = []
    sig = []
    plan = []
    for n in post:
        arg_sig = []
        for a in n.args:
            if isinstance(a, LazyArray) and a.value is None:
                arg_sig.append(("n", index[id(a)]))
            elif isinstance(a, (LazyArray, torch.Tensor)):
                v = a.value if isinstance(a, LazyArray) else a
                j = leaf_ids.setdefault(id(v), len(leaves))
                if j == len(leaves):
                    leaves.append(v)
                arg_sig.append(("l", j))
            else:
                scalars.append(float(a))
                arg_sig.append(("s", len(scalars) - 1))
        arg_sig = tuple(arg_sig)
        sig.append((_fn_key(n.fn), arg_sig))
        plan.append((n.fn, arg_sig))
    root_sig = tuple(
        index[id(r)] if isinstance(r, LazyArray) and r.value is None
        else ("done", k)
        for k, r in enumerate(roots))
    device = leaves[0].device
    key = (tuple(sig), root_sig, str(device),
           tuple((tuple(v.shape), str(v.dtype)) for v in leaves))

    with _CACHE_LOCK:
        prog = _PROGRAM_CACHE.get(key)
        if prog is None:
            prog = (_GraphProgram(plan, root_sig, leaves, len(scalars), device)
                    if device.type == "cuda" else _HostProgram(plan, root_sig))
            _PROGRAM_CACHE[key] = prog
        outs = prog(leaves, scalars)

    results = []
    for r, out in zip(roots, outs):
        if isinstance(r, LazyArray):
            if r.value is None:
                r.value = out
            results.append(r.value)
        else:
            results.append(r)
    return results


def program_cache_size() -> int:
    """Number of cached flush programs (graphs on the card)."""
    return len(_PROGRAM_CACHE)


def _pending(rv) -> bool:
    return isinstance(rv, RandomVariableTorchLazy) and isinstance(
        rv._values, LazyArray)


def averages(*random_variables) -> list:
    """Float64-accumulated means of many random variables with one flush:
    every pending chain and every reduction run in one program, the sums
    stacked into one [K] vector that one host read brings back.
    Variables with nothing pending use their own ``get_average``."""
    pend = [node(_avg_reduce, rv._values) if _pending(rv) else None
            for rv in random_variables]
    live = [n for n in pend if n is not None]
    if len(live) > 1:
        sums = _flush([node(_stack_scalars, *live)])[0].cpu().numpy()
    elif live:
        sums = [float(_flush(live)[0])]
    result, i = [], 0
    for rv, n in zip(random_variables, pend):
        if n is None:
            result.append(rv.get_average())
        else:
            result.append(float(sums[i]) / rv.size())
            i += 1
    return result


def flush(*random_variables):
    """Materialize any number of lazy random variables with one program
    (one graph replay for everything pending). Others pass through."""
    pending = [rv for rv in random_variables if _pending(rv)]
    if pending:
        for rv, value in zip(pending, _flush([rv._values for rv in pending])):
            rv._values = value
    return random_variables


# ---------------------------------------------------------------------------
# the lazy RandomVariable
# ---------------------------------------------------------------------------

def _avg_reduce(v):
    return torch.sum(v, dtype=ACC_DTYPE)


def _stack_scalars(*vs):
    return torch.stack(vs)


def _weighted_sum(v, p):
    return torch.sum(v.to(ACC_DTYPE) * p.to(ACC_DTYPE))


def _choose_where(t, a, b):
    return torch.where(t >= 0, a, b).to(FLOAT_DTYPE)


def _leaf(v):
    """A concrete tensor as a DAG node (no computation)."""
    return v


def _strict_of(rv):
    """A lazy variable as its materialized strict view; others as given."""
    return rv._strict() if isinstance(rv, RandomVariableTorchLazy) else rv


def _min(v):
    return torch.min(v)


def _max(v):
    return torch.max(v)


class RandomVariableTorchLazy(RandomVariableTorch):
    """``RandomVariableTorch`` with recorded (deferred) stochastic
    execution.

    The deterministic fast path is inherited (host float arithmetic, no
    device work either way). Stochastic values are ``LazyArray`` nodes;
    a strict ``RandomVariableTorch`` operand defers here through type
    priority (LAZY 25 > device 20), making the combined expression lazy."""

    __slots__ = ()

    _TYPE_PRIORITY = TYPE_PRIORITY_LAZY

    # -- representation ------------------------------------------------
    def __init__(self, time: float = 0.0, values=None, value: float = None,
                 device=None):
        if isinstance(values, LazyArray):
            self._time = float(time)
            self._values = values
            self._device = None
            return
        super().__init__(time, values, value, device)

    def is_deterministic(self) -> bool:
        return not isinstance(self._values, (torch.Tensor, LazyArray))

    @property
    def device(self) -> torch.device:
        if isinstance(self._values, LazyArray):
            return self._values.device
        return super().device

    def size(self) -> int:
        if isinstance(self._values, LazyArray):
            return int(self._values.shape[0]) if self._values.shape else 1
        return super().size()

    def _materialize(self):
        """Flush pending work into this variable; its tensor (or float)."""
        if isinstance(self._values, LazyArray):
            self._values = _flush([self._values])[0]
        return self._values

    @property
    def values(self):
        """The realizations as a tensor (flushing pending work), or the
        float of a deterministic variable."""
        return self._materialize()

    def _strict(self) -> RandomVariableTorch:
        return RandomVariableTorch.of(self._time, self._materialize(),
                                      self._device)

    def _recording(self) -> "RandomVariableTorchLazy":
        """Self with concrete realizations wrapped as a DAG node, so that
        the eager type's inline expressions record instead of launching."""
        if isinstance(self._values, torch.Tensor):
            return self._of(self._time, node(_leaf, self._values))
        return self

    # -- node builders instead of kernel launches ----------------------
    def _dev(self, other):
        det, v = super()._dev(other)
        return det, node(_leaf, v) if isinstance(v, torch.Tensor) else v

    def accrue(self, rate, period_length: float):
        return RandomVariableTorch.accrue(self._recording(), rate,
                                          period_length)

    def discount(self, rate, period_length: float):
        return RandomVariableTorch.discount(self._recording(), rate,
                                            period_length)

    def add_product(self, factor1, factor2):
        return RandomVariableTorch.add_product(self._recording(), factor1,
                                               factor2)

    def _ratio(self, numerator, denominator, sign: float):
        return RandomVariableTorch._ratio(self._recording(), numerator,
                                          denominator, sign)

    def _unary(self, scalar_fn, array_fn):
        if self.is_deterministic():
            return super()._unary(scalar_fn, array_fn)
        return self._of(self._time, node(array_fn, self._values))

    def _scalar_op(self, value, scalar_fn, array_fn):
        if self.is_deterministic():
            return super()._scalar_op(value, scalar_fn, array_fn)
        return self._of(self._time, node(array_fn, self._values, float(value)))

    def _binary(self, other, scalar_fn, array_fn, name):
        if self._defer(other):
            return getattr(other, self._FLIP[name])(self)
        o_det, o_vals = self._dev(other)
        if self.is_deterministic() and o_det:
            return super()._binary(other, scalar_fn, array_fn, name)
        a = float(self._values) if self.is_deterministic() else self._values
        b = float(o_vals) if o_det else o_vals
        return self._of(self._new_time(other), node(array_fn, a, b))

    def choose(self, value_if_nonneg, value_if_neg):
        if self._defer(value_if_nonneg) or self._defer(value_if_neg):
            return value_if_nonneg.mult(self.ge_zero()).add_product(
                value_if_neg, self.ge_zero().bus(1.0))
        new_time = max(self._time, value_if_nonneg.get_filtration_time(),
                       value_if_neg.get_filtration_time())
        if self.is_deterministic():
            chosen = value_if_nonneg if float(self._values) >= 0 else value_if_neg
            return self._of(new_time, self._dev(chosen)[1])
        a_det, a = self._dev(value_if_nonneg)
        b_det, b = self._dev(value_if_neg)
        return self._of(new_time, node(
            _choose_where, self._values, float(a) if a_det else a,
            float(b) if b_det else b))

    def apply(self, function, *args):
        """An arbitrary function may not be elementwise: materialize, then
        run it strict."""
        strict_args = [a._strict() if isinstance(a, RandomVariableTorchLazy)
                       else a for a in args]
        out = self._strict().apply(function, *strict_args)
        return self._of(out.get_filtration_time(), out.values)

    # -- flush points --------------------------------------------------
    def cache(self):
        """The flush point (materializes the recorded program)."""
        self._materialize()
        return super().cache()

    def get_realizations(self):
        self._materialize()
        return super().get_realizations()

    def get(self, index):
        self._materialize()
        return super().get(index)

    def get_realizations_stream(self):
        self._materialize()
        return super().get_realizations_stream()

    def equals(self, other):
        self._materialize()
        return super().equals(other)

    # -- reductions fused into the flushed program (the host reads the
    # scalar, not the path vector) --------------------------------------
    def get_average(self, probabilities=None) -> float:
        if not isinstance(self._values, LazyArray):
            return self._strict().get_average(_strict_of(probabilities))
        if probabilities is None:
            return float(_flush([node(_avg_reduce, self._values)])[0]) \
                / self.size()
        if isinstance(probabilities, RandomVariable):
            p_det, p = self._dev(probabilities)
        else:
            p_det, p = True, float(probabilities)
        if p_det:
            return float(p) * float(_flush([node(_avg_reduce, self._values)])[0])
        return float(_flush([node(_weighted_sum, self._values, p)])[0])

    # the other reductions run on the materialized values, strict
    def get_variance(self, probabilities=None) -> float:
        return self._strict().get_variance(_strict_of(probabilities))

    def get_min(self) -> float:
        if isinstance(self._values, LazyArray):
            return float(_flush([node(_min, self._values)])[0])
        return super().get_min()

    def get_max(self) -> float:
        if isinstance(self._values, LazyArray):
            return float(_flush([node(_max, self._values)])[0])
        return super().get_max()

    def get_quantile(self, quantile, probabilities=None) -> float:
        return self._strict().get_quantile(quantile,
                                           _strict_of(probabilities))

    def get_quantile_expectation(self, q_start, q_end) -> float:
        return self._strict().get_quantile_expectation(q_start, q_end)

    def get_histogram(self, interval_points=None, number_of_points=None,
                      standard_deviations=None):
        return self._strict().get_histogram(interval_points, number_of_points,
                                            standard_deviations)

    def __repr__(self):
        if isinstance(self._values, LazyArray):
            return (f"RandomVariableTorchLazy(time={self._time}, "
                    f"size={self.size()}, pending)")
        return super().__repr__().replace("RandomVariableTorch",
                                          "RandomVariableTorchLazy", 1)

    def __getstate__(self):
        self._materialize()
        return super().__getstate__()


install_camel_aliases(RandomVariableTorchLazy)


class RandomVariableTorchLazyFactory:
    """Factory for the lazy implementation: inject it where a model takes
    a ``RandomVariableTorchFactory`` and its per-path arithmetic runs as
    one flushed program per reduction or realization read."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None

    def create_random_variable(self, time: float, values) -> RandomVariableTorchLazy:
        return RandomVariableTorchLazy(time, values, device=self.device)

    createRandomVariable = create_random_variable
    create_random_variable_from_array = create_random_variable

    def __repr__(self):
        return f"RandomVariableTorchLazyFactory(device={self.device})"
