from .covariance import (
    BlendedLocalVolatilityModel,
    DisplacedLocalVolatilityModel,
    LIBORCorrelationModelExponentialDecay,
    LIBORCovarianceModelExponentialForm5Param,
    LIBORCovarianceModelFromVolatilityAndCorrelation,
    LIBORCovarianceModelStochasticVolatility,
    LIBORVolatilityModelPiecewiseConstant,
)
from .model import LIBORMarketModelTorch, LMMValuationEngine, SwaptionProduct
from .atm_calibration import ATMCalibrationSetup, build_atm_calibration
from .benchmark_calibration import (
    BenchmarkCalibrationSetup,
    build_benchmark_calibration,
)
from .analytic_approximation import LMMAnalyticSwaptionEngine
from .kernel_backend import ATMKernelCalibration, StochVolKernelCalibration

__all__ = [
    "LIBORVolatilityModelPiecewiseConstant",
    "LIBORCorrelationModelExponentialDecay",
    "LIBORCovarianceModelFromVolatilityAndCorrelation",
    "DisplacedLocalVolatilityModel",
    "BlendedLocalVolatilityModel",
    "LIBORCovarianceModelExponentialForm5Param",
    "LIBORCovarianceModelStochasticVolatility",
    "LIBORMarketModelTorch",
    "LMMValuationEngine",
    "SwaptionProduct",
    "ATMCalibrationSetup",
    "build_atm_calibration",
    "BenchmarkCalibrationSetup",
    "build_benchmark_calibration",
    "LMMAnalyticSwaptionEngine",
    "ATMKernelCalibration",
    "StochVolKernelCalibration",
]
