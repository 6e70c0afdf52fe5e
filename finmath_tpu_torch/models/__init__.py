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
from .american import (
    BermudanOption,
    crr_american_price,
)
from .equity_products import (
    AsianOption,
    BarrierOption,
    DigitalOption,
    LookbackOption,
    price_portfolio,
)
from .structured_products import (
    AutocallableNote,
    ChooserOption,
    CliquetOption,
    CompoundOption,
    ForwardStartOption,
    autocallable_value_single_observation,
)
from .mlmc import (
    MLMCResult,
    mlmc_lookback_call,
)
from .importance_sampling import (
    mc_european_price_importance_sampled,
)
from .hedging import (
    DeltaHedgedPortfolio,
    VarianceSwap,
)
from .multi_asset import (
    BasketOption,
    ExchangeOption,
    MonteCarloMultiAssetBlackScholesModel,
    MultiAssetBlackScholesModel,
    RainbowOption,
    SpreadOption,
)
from .sabr import (
    SABRCalibrationResult,
    SABRParams,
    calibrate_sabr,
    mc_sabr_implied_vols,
    mc_sabr_option_prices,
    sabr_lognormal_implied_volatility,
    sabr_normal_implied_volatility,
)
from .caps import (
    CapletVolatilityCurve,
    LIBORVolatilityModelFromCapletCurve,
    cap_value,
    implied_flat_cap_volatility,
    make_cap_schedule,
    strip_caplet_surface,
    strip_caplet_volatilities,
)
from .cube import (
    CMSReplicationPricer,
    LinearTSRAnnuityMapping,
    SwaptionCube,
    SwaptionSmile,
)
from .hull_white import (
    HullWhiteCalibrationResult,
    HullWhiteModel,
    HullWhiteSimulation,
    calibrate_hull_white,
)
from .hw_bermudan import (
    BermudanSwaption,
    hw_bermudan_swaption_pde,
)
from .tarn import (
    TargetRedemptionNote,
    inverse_floater_value,
)
from .cross_currency import (
    CCSTrade,
    CrossCurrencyExposureEngine,
    CrossCurrencyModel,
    CrossCurrencySimulation,
    FXForwardTrade,
)
from .credit import (
    CIRPPIntensityModel,
    CIRPPSimulation,
    SurvivalCurve,
    WrongWayRiskCVAEngine,
    WWRCVAResult,
    bootstrap_survival_curve,
    cds_legs,
    cds_par_spread,
    cds_value,
    par_swap_rate,
)
from .inflation import (
    JarrowYildirimModel,
    JarrowYildirimSimulation,
)

from .fourier import (
    black_scholes_cf,
    european_call_from_cf,
    heston_cf,
    merton_cf,
    variance_gamma_cf,
)
from .heston import (
    HestonCalibrationResult,
    HestonModel,
    HestonParams,
    MonteCarloHestonModel,
    calibrate_heston,
    heston_characteristic_prices,
    mc_heston_european_prices,
)
from .merton import (
    MertonCalibrationResult,
    MertonParams,
    MonteCarloMertonModel,
    calibrate_merton,
    mc_merton_european_prices,
    merton_series_prices,
)
from .variance_gamma import (
    VarianceGammaCalibrationResult,
    VarianceGammaParams,
    calibrate_variance_gamma,
    mc_vg_european_prices,
    vg_analytic_prices,
)
from .bates import (
    BatesParams,
    MonteCarloBatesModel,
    bates_cf,
    bates_characteristic_prices,
    mc_bates_european_prices,
)
from .bachelier import (
    BachelierParams,
    DisplacedLognormalParams,
    bachelier_analytic_price,
    displaced_analytic_price,
    mc_bachelier_european_prices,
    mc_displaced_european_prices,
)
from .local_vol import (
    DupireLocalVolSurface,
    LocalVolatilityModel,
    MonteCarloLocalVolModel,
    SSVISurface,
    local_variance,
)
from .slv import (
    HestonSLVModel,
    MonteCarloHestonSLVModel,
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
    "BermudanOption",
    "crr_american_price",
    "AsianOption",
    "BarrierOption",
    "DigitalOption",
    "LookbackOption",
    "price_portfolio",
    "AutocallableNote",
    "ChooserOption",
    "CliquetOption",
    "CompoundOption",
    "ForwardStartOption",
    "autocallable_value_single_observation",
    "MLMCResult",
    "mlmc_lookback_call",
    "mc_european_price_importance_sampled",
    "DeltaHedgedPortfolio",
    "VarianceSwap",
    "BasketOption",
    "ExchangeOption",
    "MonteCarloMultiAssetBlackScholesModel",
    "MultiAssetBlackScholesModel",
    "RainbowOption",
    "SpreadOption",
    "SABRCalibrationResult",
    "SABRParams",
    "calibrate_sabr",
    "mc_sabr_implied_vols",
    "mc_sabr_option_prices",
    "sabr_lognormal_implied_volatility",
    "sabr_normal_implied_volatility",
    "CapletVolatilityCurve",
    "LIBORVolatilityModelFromCapletCurve",
    "cap_value",
    "implied_flat_cap_volatility",
    "make_cap_schedule",
    "strip_caplet_surface",
    "strip_caplet_volatilities",
    "CMSReplicationPricer",
    "LinearTSRAnnuityMapping",
    "SwaptionCube",
    "SwaptionSmile",
    "HullWhiteCalibrationResult",
    "HullWhiteModel",
    "HullWhiteSimulation",
    "calibrate_hull_white",
    "BermudanSwaption",
    "hw_bermudan_swaption_pde",
    "TargetRedemptionNote",
    "inverse_floater_value",
    "CCSTrade",
    "CrossCurrencyExposureEngine",
    "CrossCurrencyModel",
    "CrossCurrencySimulation",
    "FXForwardTrade",
    "CIRPPIntensityModel",
    "CIRPPSimulation",
    "SurvivalCurve",
    "WrongWayRiskCVAEngine",
    "WWRCVAResult",
    "bootstrap_survival_curve",
    "cds_legs",
    "cds_par_spread",
    "cds_value",
    "par_swap_rate",
    "JarrowYildirimModel",
    "JarrowYildirimSimulation",
    "black_scholes_cf",
    "european_call_from_cf",
    "heston_cf",
    "merton_cf",
    "variance_gamma_cf",
    "HestonCalibrationResult",
    "HestonModel",
    "HestonParams",
    "MonteCarloHestonModel",
    "calibrate_heston",
    "heston_characteristic_prices",
    "mc_heston_european_prices",
    "MertonCalibrationResult",
    "MertonParams",
    "MonteCarloMertonModel",
    "calibrate_merton",
    "mc_merton_european_prices",
    "merton_series_prices",
    "VarianceGammaCalibrationResult",
    "VarianceGammaParams",
    "calibrate_variance_gamma",
    "mc_vg_european_prices",
    "vg_analytic_prices",
    "BatesParams",
    "MonteCarloBatesModel",
    "bates_cf",
    "bates_characteristic_prices",
    "mc_bates_european_prices",
    "BachelierParams",
    "DisplacedLognormalParams",
    "bachelier_analytic_price",
    "displaced_analytic_price",
    "mc_bachelier_european_prices",
    "mc_displaced_european_prices",
    "DupireLocalVolSurface",
    "LocalVolatilityModel",
    "MonteCarloLocalVolModel",
    "SSVISurface",
    "local_variance",
    "HestonSLVModel",
    "MonteCarloHestonSLVModel",
]
