from .lazy import (RandomVariableTorchLazy, RandomVariableTorchLazyFactory,
                   averages, flush)
from .random_variable import (RandomVariable, RandomVariableTorch,
                              RandomVariableTorchFactory)
from .random_variable_float import RandomVariableFloat, RandomVariableFloatFactory

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
]
