"""The port's TARN (``finmath_tpu_torch/models/tarn.py``) against
finmath_tpu's, on ``tests/test_tarn.py``'s set-up (a = 0.10, sigma 1.1%,
semiannual fixings 0.5 .. 4.0, strike 4.5%, multiplier 2, the 9-step
grid).

Both simulations run on the JAX stream (``_hw_scan``'s normals drawn in
the test and injected into the port), 20,000 antithetic paths.
Tolerances against the JAX package:
* ``packed_value_and_error``, both ``cap_mode``s at a finite and an
  infinite target: the value within 1e-9 relative, the standard error
  within 1e-6 (measured at most 3.0e-11 and 2.0e-9; the libor and
  the coupon logic are float64 from float32 states a few ulps apart, and
  the error's sum of squares magnifies those gaps);
* ``inverse_floater_value``: 1e-12 relative (the same host NumPy float64
  code; measured equal).
Then the JAX test's own limits on the port's stream: the infinite target
against the floorlet portfolio, a tiny target against the first payment's
zero bond."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models import (TargetRedemptionNote,  # noqa: E402
                                      inverse_floater_value)
from finmath_tpu_torch.models.curves import DiscountCurve  # noqa: E402
from finmath_tpu_torch.models.hull_white import (  # noqa: E402
    HullWhiteModel, HullWhiteSimulation)
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

from test_torch_hull_white import jax_normals  # noqa: E402

CPU = "cpu"
PILLARS = [0.5, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0]
ZEROS = [0.012, 0.014, 0.017, 0.019, 0.022, 0.024, 0.026]
DFS = list(np.exp(-np.array(ZEROS) * np.array(PILLARS)))
FIXINGS = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0]
PAYMENTS = [1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5]
STRIKE, MULT, STEPS, PATHS, SEED = 0.045, 2.0, 9, 20_000, 13
NOTES = {(mode, target): dict(cap_mode=mode, target=target)
         for mode in ("exact", "full") for target in (0.04, float("inf"))}


def _model():
    return HullWhiteModel(DiscountCurve(PILLARS, DFS), 0.10, 0.011)


def _note(mod, cap_mode, target, **kw):
    return mod.TargetRedemptionNote(FIXINGS, PAYMENTS, STRIKE, target=target,
                                    multiplier=MULT, cap_mode=cap_mode, **kw)


@pytest.fixture(scope="module")
def jax_side():
    from finmath_tpu.models import tarn as jtarn
    from finmath_tpu.models.curves import DiscountCurve as JDC
    from finmath_tpu.models.hull_white import (HullWhiteModel as JHW,
                                               HullWhiteSimulation as JSim)
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    hw = JHW(JDC(PILLARS, DFS), 0.10, 0.011)
    sim = JSim(hw, JTD(initial=0.0, num_steps=STEPS, step=0.5),
               num_paths=PATHS, seed=SEED, antithetic=True)
    values = {key: np.asarray(_note(jtarn, *key, notional=1.5)
                              .packed_value_and_error(sim))
              for key in NOTES}
    floater = jtarn.inverse_floater_value(hw, FIXINGS, PAYMENTS, STRIKE,
                                          multiplier=MULT, notional=1.5)
    return dict(values=values, floater=floater)


@pytest.fixture(scope="module")
def sim():
    return HullWhiteSimulation(
        _model(), TimeDiscretization(initial=0.0, num_steps=STEPS, step=0.5),
        num_paths=PATHS, seed=SEED, device=CPU,
        normals=jax_normals(SEED, STEPS, PATHS))


class TestParity:
    @pytest.mark.parametrize("key", sorted(NOTES, key=str))
    def test_value_and_error_match_jax(self, jax_side, sim, key):
        import finmath_tpu_torch.models.tarn as ttarn

        got = _note(ttarn, *key, notional=1.5).packed_value_and_error(sim)
        assert got.dtype == torch.float64 and got.shape == (2,)
        want = jax_side["values"][key]
        np.testing.assert_allclose(got[0].item(), want[0], rtol=1e-9)
        np.testing.assert_allclose(got[1].item(), want[1], rtol=1e-6)

    def test_inverse_floater_matches_jax(self, jax_side):
        got = inverse_floater_value(_model(), FIXINGS, PAYMENTS, STRIKE,
                                    multiplier=MULT, notional=1.5)
        np.testing.assert_allclose(got, jax_side["floater"], rtol=1e-12)


class TestLimitsOnOwnStream:
    @pytest.fixture(scope="class")
    def own(self):
        return HullWhiteSimulation(
            _model(), TimeDiscretization(initial=0.0, num_steps=STEPS,
                                         step=0.5),
            num_paths=200_000, seed=13, antithetic=True, device=CPU)

    def test_target_inf_is_floorlet_portfolio(self, own):
        note = TargetRedemptionNote(FIXINGS, PAYMENTS, STRIKE,
                                    target=float("inf"), multiplier=MULT)
        v, e = note.get_value_and_error(own)
        an = inverse_floater_value(_model(), FIXINGS, PAYMENTS, STRIKE,
                                   multiplier=MULT)
        assert abs(v - an) < 4 * e + 2e-4 * an

    def test_tiny_target_and_cap_order(self, own):
        note = TargetRedemptionNote(FIXINGS, PAYMENTS, strike=0.5,
                                    target=1e-9, multiplier=1.0)
        assert abs(note.getValue(own)
                   - float(_model().df(PAYMENTS[0]))) < 1e-5
        kw = dict(fixing_times=FIXINGS, payment_times=PAYMENTS,
                  strike=STRIKE, target=0.04, multiplier=MULT)
        full = TargetRedemptionNote(cap_mode="full", **kw).get_value(own)
        exact = TargetRedemptionNote(cap_mode="exact", **kw).get_value(own)
        assert full >= exact - 1e-12


class TestValidation:
    def test_note_errors(self, sim):
        with pytest.raises(ValueError, match="cap_mode"):
            TargetRedemptionNote(FIXINGS, PAYMENTS, STRIKE, 0.1,
                                 cap_mode="soft")
        with pytest.raises(ValueError, match="matching"):
            TargetRedemptionNote(FIXINGS[:-1], PAYMENTS, STRIKE, 0.1)
        with pytest.raises(ValueError, match="matching"):
            TargetRedemptionNote([], [], STRIKE, 0.1)
        with pytest.raises(ValueError, match="precede"):
            TargetRedemptionNote([1.0], [1.0], STRIKE, 0.1)
        with pytest.raises(ValueError, match="ascending"):
            TargetRedemptionNote([1.0, 0.5], [1.5, 2.0], STRIKE, 0.1)
        with pytest.raises(ValueError, match="grid"):
            TargetRedemptionNote([0.25], [1.0], STRIKE, 0.1).get_value(sim)
