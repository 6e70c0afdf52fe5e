from .time_discretization import TimeDiscretization
from .brownian_motion import (
    BrownianMotion,
    BrownianMotionHostRandom,
    BrownianMotionTorchWithHostRandomVariable,
    BrownianMotionView,
)
from .calibration import (
    BatchedLevenbergMarquardt,
    LevenbergMarquardt,
    LMResult,
)

__all__ = [
    "TimeDiscretization",
    "BrownianMotion",
    "BrownianMotionHostRandom",
    "BrownianMotionTorchWithHostRandomVariable",
    "BrownianMotionView",
    "BatchedLevenbergMarquardt",
    "LevenbergMarquardt",
    "LMResult",
]
