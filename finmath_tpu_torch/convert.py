"""State carried over from the JAX package, as NumPy arrays.

The JAX package's "weights" for the LMM calibration are the covariance
parameter vector and the Brownian realization. A parameter vector that
``finmath_tpu`` calibrated revalues in the port through
``params_from_numpy``; a realization in the JAX engine's injected format
(``[steps, factors, paths]``, already scaled by sqrt(dt)) drives the
port's engine through ``increments_from_numpy``, so both packages price
the same paths; a path kernel's block of normals becomes such increments
through ``increments_from_normals``. A vector-engine random variable crosses as its filtration
time and realizations: ``random_variable_from_numpy`` and
``random_variable_to_numpy``. A Bermudan policy fitted by the JAX pricer
(its tuple of float64 beta vectors) applies in the port through
``betas_from_numpy``, a JAX ``BermudanSwaption`` becomes the port's
through ``bermudan_swaption_from_jax``, and a (calibrated) JAX
``HullWhiteModel`` the port's through ``hull_white_model_from_jax``,
and a survival curve (bootstrapped there), a CIR++ intensity, a
cross-currency and a Jarrow-Yildirim model through
``survival_curve_from_jax``, ``cirpp_intensity_model_from_jax``,
``cross_currency_model_from_jax`` and ``jarrow_yildirim_model_from_jax``;
a Black-Scholes and a multi-asset Black-Scholes model through
``black_scholes_model_from_jax`` and ``multi_asset_model_from_jax``, and
an equity product (the exotics, rainbows, Bermudan, structured products,
hedge and variance swap) through ``equity_product_from_jax``; a copula
portfolio, a Schwartz-Smith model, an option book, an SA-CCR trade and the
three FDM models through ``copula_portfolio_from_jax``,
``schwartz_smith_model_from_jax``, ``option_book_from_jax``,
``saccr_trade_from_jax`` and ``fdm_model_from_jax`` (all read by
attribute, without importing the JAX package). Path-axis sharding carries
nothing new across: a JAX ``Mesh`` has no counterpart to convert (the port
builds its ``parallel.PathMesh`` from its own process group), and a meshed
engine takes the same global realization as an unsharded one.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(x, device=None) -> torch.Tensor:
    """A parameter vector as a float64 tensor (on ``device``, default CPU)."""
    return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
        device if device is not None else "cpu").clone()


def params_to_numpy(x) -> np.ndarray:
    """A parameter tensor (any device) as a float64 NumPy vector."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=np.float64)


def increments_from_numpy(inc, device) -> torch.Tensor:
    """Injected Brownian increments ``[S, F, paths]`` (sqrt(dt)-scaled, the
    JAX engine's format) as a float32 tensor on ``device``."""
    inc = np.asarray(getattr(inc, "increments", inc))
    if inc.ndim != 3:
        raise ValueError(f"increments must be [steps, factors, paths], got "
                         f"shape {inc.shape}")
    return torch.as_tensor(inc.astype(np.float32, copy=False)).to(device)


def increments_from_normals(z, rows_per_step: int, dt: float):
    """A path kernel's block of standard normals ``[S * k, paths]`` (rows
    step-major, ``k = rows_per_step``) as the engine's injected increments
    ``[S, k, paths]``, each normal times sqrt(dt) in float32 (sqrt(dt) taken
    in float64, then rounded), as ``bench.py:1104`` builds them: the same
    realization then drives a kernel and either package's engine. A tensor
    stays a tensor on its device; anything else becomes a NumPy array."""
    scale = np.float32(np.sqrt(dt))
    rows, paths = z.shape
    k = int(rows_per_step)
    if k < 1 or rows % k:
        raise ValueError(f"{rows} rows are not whole steps of {k}")
    if isinstance(z, torch.Tensor):
        return z.to(torch.float32).reshape(rows // k, k, paths) * float(scale)
    return np.asarray(z, np.float32).reshape(rows // k, k, paths) * scale


def random_variable_from_numpy(time, values, device):
    """A ``RandomVariableTorch`` on ``device`` from a filtration time and
    realizations (a NumPy vector, e.g. a JAX ``RandomVariableTPU``'s
    ``get_realizations()``) or a scalar (the deterministic fast path)."""
    from .ops.random_variable import RandomVariableTorch

    values = np.asarray(values)
    if values.ndim > 1:
        raise ValueError(f"realizations must be a vector, got shape "
                         f"{values.shape}")
    return RandomVariableTorch(float(time), values, device=device)


def random_variable_to_numpy(rv):
    """``(time, values)`` of a random variable: its filtration time and its
    float32 realizations as NumPy, or its float value if deterministic."""
    if rv.is_deterministic():
        return rv.get_filtration_time(), rv.double_value()
    return rv.get_filtration_time(), np.asarray(rv.get_realizations(),
                                                dtype=np.float32)


def betas_from_numpy(betas, device=None) -> tuple:
    """A Longstaff-Schwartz policy (one coefficient vector per exercise
    date but the last, in date order; e.g. the JAX pricer's tuple of
    float64 arrays) as the port's tuple of float64 tensors on ``device``
    (default CPU)."""
    return tuple(params_from_numpy(np.array(b, dtype=np.float64), device)
                 for b in betas)


def bermudan_swaption_from_jax(product):
    """The port's ``BermudanSwaption`` with the exercise dates, maturity
    and strike of another package's (any object with those attributes)."""
    from .models.lmm.bermudan import BermudanSwaption

    return BermudanSwaption(
        tuple(int(e) for e in product.exercise_indices),
        int(product.maturity_index), float(product.strike))


def hull_white_model_from_jax(model):
    """The port's ``HullWhiteModel`` with the mean reversion, volatility
    segments and discount curve (rebuilt from its pillars and discount
    factors) of another package's (any object with ``.curve``, ``.a``,
    ``.sigmas`` and ``.vol_times``; the curve with ``.times`` and
    ``.factors``): a model calibrated there prices the same here."""
    from .models.curves import DiscountCurve
    from .models.hull_white import HullWhiteModel

    curve = DiscountCurve(np.array(model.curve.times, dtype=np.float64),
                          np.array(model.curve.factors, dtype=np.float64),
                          name=getattr(model.curve, "name", "discountCurve"))
    return HullWhiteModel(curve, float(model.a),
                          np.array(model.sigmas, dtype=np.float64),
                          np.array(model.vol_times, dtype=np.float64))


def survival_curve_from_jax(curve):
    """The port's ``SurvivalCurve`` with the hazard segments of another
    package's (any object with ``.times``, ``.hazards`` and ``.name``)."""
    from .models.credit import SurvivalCurve

    return SurvivalCurve(np.array(curve.times, dtype=np.float64),
                         np.array(curve.hazards, dtype=np.float64),
                         name=getattr(curve, "name", "survivalCurve"))


def cirpp_intensity_model_from_jax(model):
    """The port's ``CIRPPIntensityModel`` with the survival curve and the
    CIR parameters (``.curve``, ``.kappa``, ``.theta``, ``.sigma``,
    ``.y0``) of another package's."""
    from .models.credit import CIRPPIntensityModel

    return CIRPPIntensityModel(survival_curve_from_jax(model.curve),
                               float(model.kappa), float(model.theta),
                               float(model.sigma), float(model.y0))


def cross_currency_model_from_jax(model):
    """The port's ``CrossCurrencyModel`` with the two Hull-White economies
    (``.domestic``, ``.foreign``), the FX spot, volatility segments
    (``.fx_spot``, ``.fx_vols``, ``.fx_vol_times``) and correlations
    (``.rho_df``, ``.rho_dx``, ``.rho_fx``) of another package's."""
    from .models.cross_currency import CrossCurrencyModel

    return CrossCurrencyModel(
        hull_white_model_from_jax(model.domestic),
        hull_white_model_from_jax(model.foreign), float(model.fx_spot),
        np.array(model.fx_vols, dtype=np.float64), float(model.rho_df),
        float(model.rho_dx), float(model.rho_fx),
        fx_vol_times=np.array(model.fx_vol_times, dtype=np.float64))


def jarrow_yildirim_model_from_jax(model):
    """The port's ``JarrowYildirimModel`` of another package's (its
    cross-currency form ``.xccy``, the real economy as foreign and the CPI
    as the FX rate, and ``.cpi0``)."""
    from .models.inflation import JarrowYildirimModel

    x = cross_currency_model_from_jax(model.xccy)
    return JarrowYildirimModel(x.domestic, x.foreign, float(model.cpi0),
                               x.fx_vols, x.rho_df, x.rho_dx, x.rho_fx,
                               cpi_vol_times=x.fx_vol_times)


def black_scholes_model_from_jax(model):
    """The port's ``BlackScholesModel`` with the spot, rate and volatility
    (``.initial_value``, ``.risk_free_rate``, ``.volatility``) of another
    package's."""
    from .models.black_scholes import BlackScholesModel

    return BlackScholesModel(float(model.initial_value),
                             float(model.risk_free_rate),
                             float(model.volatility))


def multi_asset_model_from_jax(model):
    """The port's ``MultiAssetBlackScholesModel`` with the spots, rate,
    volatilities and correlation matrix of another package's."""
    from .models.multi_asset import MultiAssetBlackScholesModel

    return MultiAssetBlackScholesModel(
        [float(s) for s in model.initial_values], float(model.risk_free_rate),
        [float(v) for v in model.volatilities],
        np.array(model.correlation, dtype=np.float64))


#: the equity products ``equity_product_from_jax`` maps, by class name
_EQUITY_PRODUCTS = {
    "equity_products": ("DigitalOption", "AsianOption", "BarrierOption",
                        "LookbackOption"),
    "multi_asset": ("ExchangeOption", "RainbowOption", "BasketOption",
                    "SpreadOption"),
    "american": ("BermudanOption",),
    "structured_products": ("ForwardStartOption", "CliquetOption",
                            "CompoundOption", "ChooserOption",
                            "AutocallableNote"),
    "hedging": ("DeltaHedgedPortfolio", "VarianceSwap"),
    "black_scholes": ("EuropeanOption",),
}


def equity_product_from_jax(product):
    """The port's product of the same class name with the same attributes
    as another package's (its terms: floats, lists, flags and names)."""
    import importlib

    name = type(product).__name__
    for module, names in _EQUITY_PRODUCTS.items():
        if name in names:
            cls = getattr(importlib.import_module(
                f"{__package__}.models.{module}"), name)
            break
    else:
        raise ValueError(f"no equity product of the port is named {name!r}")
    out = cls.__new__(cls)
    out.__dict__.update({k: list(v) if isinstance(v, list) else v
                         for k, v in vars(product).items()})
    return out


#: the slice's parameter dataclasses ``equity_model_from_jax`` maps, by
#: class name, to their module in the port
_EQUITY_PARAMS = {
    "HestonParams": "heston", "MertonParams": "merton",
    "VarianceGammaParams": "variance_gamma", "BatesParams": "bates",
    "BachelierParams": "bachelier", "DisplacedLognormalParams": "bachelier",
    "SSVISurface": "local_vol",
}


def equity_model_from_jax(obj):
    """The port's counterpart of another package's stochastic-volatility,
    jump, Gaussian or local-volatility object with the same fields: the
    parameter dataclasses (``HestonParams``, ``MertonParams``,
    ``VarianceGammaParams``, ``BatesParams``, ``BachelierParams``,
    ``DisplacedLognormalParams``), ``SSVISurface``, and the models
    ``HestonModel``, ``LocalVolatilityModel`` and ``HestonSLVModel`` (their
    coefficient times and hat nodes copied as they are). A
    ``DupireLocalVolSurface`` wraps a function of the other package and
    raises."""
    import dataclasses
    import importlib

    from .models import local_vol, slv
    from .models.heston import HestonModel

    name = type(obj).__name__
    if name in _EQUITY_PARAMS:
        cls = getattr(importlib.import_module(
            f"{__package__}.models.{_EQUITY_PARAMS[name]}"), name)
        return cls(**{f.name: float(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if name == "HestonModel":
        return HestonModel(equity_model_from_jax(obj.params))
    if name not in ("LocalVolatilityModel", "HestonSLVModel"):
        raise ValueError(f"no equity model of the port is named {name!r}")
    surface = equity_model_from_jax(obj.surface)
    coeff_times = np.asarray(obj._coeff_times, dtype=np.float32)
    cls = getattr(local_vol if name == "LocalVolatilityModel" else slv, name)
    out = cls.__new__(cls)
    fields = ("dividend_yield", "min_vol", "max_vol", "denominator_floor",
              "t_floor")
    out.__dict__.update({k: float(getattr(obj, k)) for k in fields})
    out.surface = surface
    out._coeff_times = coeff_times
    out._cache = local_vol._StepCache()
    times = tuple(float(t) for t in coeff_times)
    if name == "LocalVolatilityModel":
        out.initial_value = float(obj.initial_value)
        out.risk_free_rate = float(obj.risk_free_rate)
        out._static_key = (
            out.initial_value, out.risk_free_rate, out.dividend_yield,
            surface, out.min_vol, out.max_vol, out.denominator_floor,
            out.t_floor, times)
        return out
    out.params = equity_model_from_jax(obj.params)
    out.mixing = float(obj.mixing)
    out.leverage_min = float(obj.leverage_min)
    out.leverage_max = float(obj.leverage_max)
    # a named axis stays a name: the meshed EulerScheme that simulates
    # the model binds it to its mesh (HestonSLVModel.on_mesh)
    out.axis_name = None if obj.axis_name is None else str(obj.axis_name)
    out.mesh = None
    out._nodes_np = np.asarray(obj._nodes, dtype=np.float32)
    out._nodes_by_device = {}
    out._static_key = (
        out.params, surface, out.dividend_yield, out.mixing,
        int(out._nodes_np.size), float(out._nodes_np[-1]),
        out.leverage_min, out.leverage_max, out.min_vol, out.max_vol,
        out.t_floor, out.denominator_floor, out.axis_name, times)
    return out


def copula_portfolio_from_jax(portfolio):
    """The port's ``GaussianCopulaPortfolio`` with the survival curves,
    betas, recoveries and notionals (``.curves``, ``.betas``,
    ``.recoveries``, ``.notionals``) of another package's."""
    from .models.portfolio_credit import GaussianCopulaPortfolio

    return GaussianCopulaPortfolio(
        [survival_curve_from_jax(c) for c in portfolio.curves],
        np.array(portfolio.betas, dtype=np.float64),
        recoveries=np.array(portfolio.recoveries, dtype=np.float64),
        notionals=np.array(portfolio.notionals, dtype=np.float64))


def schwartz_smith_model_from_jax(model):
    """The port's ``SchwartzSmithModel`` with the factors and parameters
    (``.chi0``, ``.xi0``, ``.kappa``, ``.s_chi``, ``.s_xi``, ``.rho``,
    ``.mu_star``, ``.lam``) of another package's."""
    from .models.commodity import SchwartzSmithModel

    return SchwartzSmithModel(
        float(model.chi0), float(model.xi0), float(model.kappa),
        float(model.s_chi), float(model.s_xi), float(model.rho),
        mu_star=float(model.mu_star), lambda_chi=float(model.lam))


def option_book_from_jax(book):
    """The port's ``OptionBook`` with the spots, rate and instrument
    arrays (``.spots``, ``.rate``, ``.idx``, ``.strikes``, ``.expiries``,
    ``.vols``, ``.notionals``, ``.is_call``) of another package's."""
    from .models.risk import OptionBook

    return OptionBook(
        np.array(book.spots, dtype=np.float64), float(book.rate),
        np.array(book.idx, dtype=np.int64),
        np.array(book.strikes, dtype=np.float64),
        np.array(book.expiries, dtype=np.float64),
        np.array(book.vols, dtype=np.float64),
        np.array(book.notionals, dtype=np.float64),
        is_call=np.array(book.is_call) != 0)


def saccr_trade_from_jax(trade):
    """The port's ``SACCRTrade`` with the notional, start, end, delta and
    hedging set of another package's."""
    from .models.regulatory import SACCRTrade

    return SACCRTrade(float(trade.notional), float(trade.start),
                      float(trade.end), float(trade.delta),
                      str(trade.hedging_set))


#: the FDM models ``fdm_model_from_jax`` maps, by class name
_FDM_MODELS = ("FDMBlackScholesModel", "FDMConstantElasticityOfVarianceModel",
               "FDMLocalVolatilityModel")


def fdm_model_from_jax(model):
    """The port's FDM model of the same class name with the same fields as
    another package's (``FDMBlackScholesModel``,
    ``FDMConstantElasticityOfVarianceModel``, ``FDMLocalVolatilityModel``;
    the local-vol model's surface through ``equity_model_from_jax``)."""
    import dataclasses

    from .models import pde

    name = type(model).__name__
    if name not in _FDM_MODELS:
        raise ValueError(f"no FDM model of the port is named {name!r}")
    fields = {}
    for f in dataclasses.fields(model):
        value = getattr(model, f.name)
        if f.name == "surface":
            value = equity_model_from_jax(value)
        elif isinstance(value, (int, np.integer)):
            value = int(value)
        else:
            value = float(value)
        fields[f.name] = value
    return getattr(pde, name)(**fields)
