from .covariance import (
    DisplacedLocalVolatilityModel,
    LIBORCorrelationModelExponentialDecay,
    LIBORCovarianceModelFromVolatilityAndCorrelation,
    LIBORVolatilityModelPiecewiseConstant,
)
from .model import LIBORMarketModelTorch, LMMValuationEngine, SwaptionProduct
from .atm_calibration import ATMCalibrationSetup, build_atm_calibration
from .analytic_approximation import LMMAnalyticSwaptionEngine
from .kernel_backend import ATMKernelCalibration

__all__ = [
    "LIBORVolatilityModelPiecewiseConstant",
    "LIBORCorrelationModelExponentialDecay",
    "LIBORCovarianceModelFromVolatilityAndCorrelation",
    "DisplacedLocalVolatilityModel",
    "LIBORMarketModelTorch",
    "LMMValuationEngine",
    "SwaptionProduct",
    "ATMCalibrationSetup",
    "build_atm_calibration",
    "LMMAnalyticSwaptionEngine",
    "ATMKernelCalibration",
]
