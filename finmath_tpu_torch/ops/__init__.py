from .random_variable import (RandomVariable, RandomVariableTorch,
                              RandomVariableTorchFactory)
from .random_variable_float import RandomVariableFloat, RandomVariableFloatFactory

__all__ = [
    "RandomVariable",
    "RandomVariableTorch",
    "RandomVariableTorchFactory",
    "RandomVariableFloat",
    "RandomVariableFloatFactory",
]
