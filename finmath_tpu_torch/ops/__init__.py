from .lazy import (RandomVariableTorchLazy, RandomVariableTorchLazyFactory,
                   averages, flush)
from .random_variable import (RandomVariable, RandomVariableTorch,
                              RandomVariableTorchFactory)
from .random_variable_float import RandomVariableFloat, RandomVariableFloatFactory
from .tridiagonal import tridiagonal_matvec, tridiagonal_solve

__all__ = [
    "RandomVariable",
    "RandomVariableTorch",
    "RandomVariableTorchFactory",
    "RandomVariableTorchLazy",
    "RandomVariableTorchLazyFactory",
    "RandomVariableFloat",
    "RandomVariableFloatFactory",
    "averages",
    "flush",
    "tridiagonal_matvec",
    "tridiagonal_solve",
]
