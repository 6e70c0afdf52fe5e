"""The port's netting-set exposure engine under the stoch-vol benchmark
model (``build_benchmark_calibration``: 40 libors, 5 factors, blended
local vol, stochastic vol, at its curated basin), against the benchmark's
plain reference ``portbench/reference/xva.py`` (plain NumPy and PyTorch,
written from the exposure module's published conventions), loaded by
path.

At 4,096 paths, 15 dates and seven trades (four swaps, one forward-
starting; a long and a short European payer swaption; a Bermudan with
three exercise dates), the engine on injected increments against the
reference on the same standard normals, with and without a CSA with a
minimum transfer amount:

* the float64 (parity) engine: every row, the PFE's and the CVA within
  1e-6 of its peak over the dates (measured 7.6e-8: the reference solves
  its normal equations by another route);
* the float32 engine: within 2e-6 (measured 2.0e-7: float32 forwards
  over 15 steps, and the regressions' float32 feature).

Besides: ``reseed`` gives bit for bit the profile of an engine built with
that seed; one profile under ``recording()`` opens each of the six spans
once (``finmath.xva.collect`` once a date) and counts the regressions the
trades need."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models.lmm import build_benchmark_calibration  # noqa: E402
from finmath_tpu_torch.models.lmm.benchmark_calibration import (  # noqa: E402
    CURATED_BASINS)
from finmath_tpu_torch.models.lmm.exposure import (  # noqa: E402
    CSA,
    BermudanSwaptionTrade,
    NettingSetExposureEngine,
    SwapTrade,
    SwaptionTrade,
    SwaptionExposureEngine,
    cva_from_profile,
)
from finmath_tpu_torch.utils import profiling  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "portbench_reference_xva", Path(__file__).resolve().parents[1]
    / "portbench" / "reference" / "xva.py")
plain_xva = sys.modules[_spec.name] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain_xva)

PATHS, SEED, DATES = 4096, 20241018, 15
OBS = list(range(1, DATES + 1))
X = np.asarray(CURATED_BASINS[0])
TRADES = {
    "swaps": [dict(first=1, last=16, strike=0.025, payer=True, notional=1.0),
              dict(first=1, last=9, strike=0.018, payer=False,
                   notional=0.7),
              dict(first=1, last=12, strike=0.021, payer=False,
                   notional=1.3),
              dict(first=5, last=14, strike=0.026, payer=True,
                   notional=0.9)],
    "europeans": [dict(exercise=6, periods=8, strike=0.024, notional=1.5),
                  dict(exercise=4, periods=6, strike=0.02, notional=-0.8)],
    "bermudans": [dict(exercises=[4, 6, 8], last=14, strike=0.023,
                       notional=1.2)],
}
CSA_TERMS = dict(threshold=0.0, threshold_own=0.0, mta=0.01,
                 independent_amount=0.0, margin_lag=1)
ROWS = ("ee", "ene", "forward_value", "ee_standalone", "ee_gross",
        "ene_gross")


def _trades():
    t = TRADES
    return ([SwapTrade(s["first"], s["last"], s["strike"], s["payer"],
                       s["notional"]) for s in t["swaps"]]
            + [SwaptionTrade(e["exercise"], e["periods"], e["strike"],
                             e["notional"]) for e in t["europeans"]]
            + [BermudanSwaptionTrade(tuple(b["exercises"]), b["last"],
                                     b["strike"], b["notional"])
               for b in t["bermudans"]])


@pytest.fixture(scope="module")
def setup():
    model = build_benchmark_calibration(num_paths=256, device="cpu").model
    cov = model.covariance
    prep = cov.prepare(torch.as_tensor(X))
    nu, rho = (float(v) for v in cov.stoch_vol_params(prep))
    mk = plain_xva.Market(
        vol=cov.vol_table(prep).double().numpy(),
        factors=cov.factor_matrix(prep).double().numpy(),
        L0=np.asarray(model.initial_forwards, np.float64),
        deltas=np.asarray(model.deltas, np.float64), blend=float(X[5]),
        nu=nu, rho=rho, dt=0.5)
    z = plain_xva.normals(SEED, DATES, 6, PATHS, "cpu")
    inc = (z * torch.tensor(0.5, dtype=torch.float32).sqrt()).numpy()
    return model, mk, z, inc


def _engine(model, dtype, csa, **kw):
    return NettingSetExposureEngine(
        model, _trades(), num_paths=PATHS, num_factors=5,
        observation_indices=OBS, csa=CSA(**csa) if csa else None,
        dtype=dtype, device="cpu", **kw)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-6),
                                       (torch.float32, 2e-6)])
@pytest.mark.parametrize("csa", [None, CSA_TERMS], ids=["no_csa", "csa"])
def test_profile_matches_plain_reference(setup, dtype, tol, csa):
    model, mk, z, inc = setup
    prof = _engine(model, dtype, csa, increments=inc).profile(X)
    ref = plain_xva.profile(mk, TRADES, OBS, z, csa=csa)
    got = {name: getattr(prof, name) for name in ROWS}
    names = ROWS if csa else ROWS[:4]
    for name in names:
        peak = np.max(np.abs(ref[name]))
        assert np.max(np.abs(got[name] - ref[name])) <= tol * peak, name
    for q in (0.95, 0.99):
        peak = np.max(np.abs(ref["pfe"][q]))
        assert np.max(np.abs(prof.pfe[q] - ref["pfe"][q])) <= tol * peak, q
    ref_cva = cva_from_profile(prof.__class__(
        prof.times, ref["ee"], ref["ene"], ref["forward_value"], {}), 0.01)
    assert abs(cva_from_profile(prof, 0.01) - ref_cva) <= tol * ref_cva


def test_reseed_gives_a_fresh_engines_paths(setup):
    model = setup[0]
    engine = _engine(model, torch.float32, CSA_TERMS, seed=1)
    engine.reseed(SEED + 1)
    fresh = _engine(model, torch.float32, CSA_TERMS, seed=SEED + 1)
    assert torch.equal(engine.engine.increments, fresh.engine.increments)
    a, b = engine.profile(X), fresh.profile(X)
    for name in ROWS:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for q in (0.95, 0.99):
        assert np.array_equal(a.pfe[q], b.pfe[q])
    injected = _engine(model, torch.float32, None, increments=setup[3])
    with pytest.raises(ValueError, match="set_increments"):
        injected.reseed(3)


def _regressions_from_trades():
    """A European fits at each date before its expiry; a Bermudan once an
    exercise date but the last (backward induction) and at each date
    before its last exercise that is not an exercise date."""
    n = sum(sum(1 for e in OBS if e < t["exercise"])
            for t in TRADES["europeans"])
    for t in TRADES["bermudans"]:
        xs = t["exercises"]
        n += len(xs) - 1 + sum(1 for e in OBS if e < xs[-1] and e not in xs)
    return n


def test_one_profile_opens_each_span_once(setup):
    engine = _engine(setup[0], torch.float32, CSA_TERMS, increments=setup[3])
    profiling.clear()
    with profiling.recording():
        engine.profile(X)
    spans = profiling.spans()
    names = [s.name for s in spans]
    for part in ("profile", "simulate", "regress", "margin", "reduce"):
        assert names.count(f"finmath.xva.{part}") == 1, part
    assert names.count("finmath.xva.collect") == DATES
    root = next(s for s in spans if s.name == "finmath.xva.profile")
    assert {s.root for s in spans} == {root.id} and root.parent == 0
    sim = next(s for s in spans if s.name == "finmath.xva.simulate")
    assert all(s.parent == sim.id for s in spans
               if s.name == "finmath.xva.collect")
    assert root.attrs == dict(trades=7, swaptions=2, bermudans=1,
                              dates=DATES, paths=PATHS,
                              regressions=_regressions_from_trades())
    # the single-swaption engine shares the root
    single = SwaptionExposureEngine(setup[0], 6, 8, 0.024, num_paths=512,
                                    num_factors=5, device="cpu")
    profiling.clear()
    with profiling.recording():
        single.profile(X)
    root = next(s for s in profiling.spans()
                if s.name == "finmath.xva.profile")
    assert root.attrs["regressions"] == 5 and root.attrs["dates"] == 13
    profiling.clear()
