from .time_discretization import TimeDiscretization
from .brownian_motion import (
    BrownianMotion,
    BrownianMotionHostRandom,
    BrownianMotionTorchWithHostRandomVariable,
    BrownianMotionView,
)
from .calibration import (
    LevenbergMarquardt,
    LMResult,
)

__all__ = [
    "TimeDiscretization",
    "BrownianMotion",
    "BrownianMotionHostRandom",
    "BrownianMotionTorchWithHostRandomVariable",
    "BrownianMotionView",
    "LevenbergMarquardt",
    "LMResult",
]
