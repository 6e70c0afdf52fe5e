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
from .bermudan import BermudanSwaption, BermudanSwaptionPricer
from .products import CapFloor
from .exposure import (
    CSA,
    BermudanSwaptionTrade,
    ExposureProfile,
    IMProfile,
    NettingSetExposureEngine,
    SwapExposureEngine,
    SwapTrade,
    SwaptionExposureEngine,
    SwaptionTrade,
    bilateral_cva_from_profile,
    cva_from_profile,
    dva_from_profile,
    fva_from_profile,
    mva_from_im_profile,
)
from .eager import eager_swaption_valuation
from .hybrid import (
    EquityForwardTrade,
    EquityOptionTrade,
    HybridAssetLMM,
    HybridAutocallableNote,
    HybridExposureEngine,
)

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
    "BermudanSwaption",
    "BermudanSwaptionPricer",
    "CapFloor",
    "CSA",
    "ExposureProfile",
    "IMProfile",
    "NettingSetExposureEngine",
    "SwapExposureEngine",
    "SwapTrade",
    "SwaptionExposureEngine",
    "SwaptionTrade",
    "BermudanSwaptionTrade",
    "bilateral_cva_from_profile",
    "cva_from_profile",
    "dva_from_profile",
    "fva_from_profile",
    "mva_from_im_profile",
    "eager_swaption_valuation",
    "EquityForwardTrade",
    "EquityOptionTrade",
    "HybridAssetLMM",
    "HybridAutocallableNote",
    "HybridExposureEngine",
]
