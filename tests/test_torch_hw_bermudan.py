"""The port's Hull-White Bermudan swaption
(``finmath_tpu_torch/models/hw_bermudan.py``) against finmath_tpu's, on
``tests/test_hw_bermudan.py``'s set-up (flat 2.2% curve, a = 0.1, sigma
1%, exercises 2.0 .. 6.5, maturity 7, strike 2.5%, the 14-step grid).

Both simulations run on the JAX stream (``_hw_scan``'s normals drawn in
the test and injected into the port through ``normals=``), 20,000
antithetic paths. Tolerances against the JAX package:
* ``packed_value_and_error``, the value and the standard error within
  5e-5 relative, payer and receiver, ``split`` and ``insample``
  (measured at most 1.6e-9 and 2.4e-9): the float32
  histories differ by a few ulps and the float32 Gram sums over the paths
  in another order, so the exercise decision can flip on a near-tie path;
* ``hw_bermudan_swaption_pde``: 1e-12 relative (the same host NumPy
  float64 code; measured equal).
Then the JAX test's own orderings on the port's stream."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from finmath_tpu_torch.models import BermudanSwaption  # noqa: E402
from finmath_tpu_torch.models.curves import DiscountCurve  # noqa: E402
from finmath_tpu_torch.models.hull_white import (  # noqa: E402
    HullWhiteModel, HullWhiteSimulation)
from finmath_tpu_torch.models.hw_bermudan import (  # noqa: E402
    _hw_ls_kernel, hw_bermudan_swaption_pde)
from finmath_tpu_torch.models.time_discretization import (  # noqa: E402
    TimeDiscretization)

from test_torch_hull_white import jax_normals  # noqa: E402

CPU = "cpu"
TS = np.arange(0.5, 20.1, 0.5)
DFS = list(np.exp(-0.022 * TS))
K, FIN, STEPS, PATHS, SEED = 0.025, 7.0, 14, 20_000, 11
EX = [2.0 + 0.5 * i for i in range(10)]      # 2.0 .. 6.5
PRODUCTS = {(payer, bias): dict(payer=payer, foresight_bias=bias)
            for payer in (True, False) for bias in ("split", "insample")}
PDE = dict(nx=201, steps_per_year=40)


def _model():
    return HullWhiteModel(DiscountCurve(list(TS), DFS), 0.1, [0.01])


@pytest.fixture(scope="module")
def jax_side():
    from finmath_tpu.models.curves import DiscountCurve as JDC
    from finmath_tpu.models.hull_white import (HullWhiteModel as JHW,
                                               HullWhiteSimulation as JSim)
    from finmath_tpu.models.hw_bermudan import (
        BermudanSwaption as JBerm, hw_bermudan_swaption_pde as jpde)
    from finmath_tpu.models.time_discretization import (
        TimeDiscretization as JTD)

    hw = JHW(JDC(list(TS), DFS), 0.1, [0.01])
    sim = JSim(hw, JTD(initial=0.0, num_steps=STEPS, step=0.5),
               num_paths=PATHS, seed=SEED, antithetic=True)
    values = {key: np.asarray(JBerm(EX, FIN, K, **kw)
                              .packed_value_and_error(sim))
              for key, kw in PRODUCTS.items()}
    pde = {payer: jpde(hw, EX[::3], FIN, K, payer=payer, **PDE)
           for payer in (True, False)}
    return dict(values=values, pde=pde)


@pytest.fixture(scope="module")
def sim():
    return HullWhiteSimulation(
        _model(), TimeDiscretization(initial=0.0, num_steps=STEPS, step=0.5),
        num_paths=PATHS, seed=SEED, device=CPU,
        normals=jax_normals(SEED, STEPS, PATHS))


class TestParity:
    @pytest.mark.parametrize("key", sorted(PRODUCTS))
    def test_value_and_error_match_jax(self, jax_side, sim, key):
        got = BermudanSwaption(EX, FIN, K, **PRODUCTS[key]) \
            .packed_value_and_error(sim)
        assert got.dtype == torch.float64 and got.shape == (2,)
        np.testing.assert_allclose(got.numpy(), jax_side["values"][key],
                                   rtol=5e-5)

    @pytest.mark.parametrize("payer", [True, False])
    def test_pde_matches_jax(self, jax_side, payer):
        got = hw_bermudan_swaption_pde(_model(), EX[::3], FIN, K,
                                       payer=payer, **PDE)
        np.testing.assert_allclose(got, jax_side["pde"][payer], rtol=1e-12)

    def test_kernel_error_is_over_n(self, sim):
        """One exercise date: the value is the mean of the positive
        exercise values and the error their std over n, / sqrt(n)."""
        x, y = sim._xs[[6]], sim._ys[[6]]
        cl = torch.tensor([[1.0]], dtype=torch.float64)
        bb = torch.tensor([[0.0]], dtype=torch.float64)
        a_int = torch.tensor([0.0], dtype=torch.float64)
        out = _hw_ls_kernel(x, y, a_int, 0.9 * cl, bb, 1.0, 3, False)
        ev = np.maximum(0.1 * np.exp(-y[0].double().numpy()), 0.0)
        np.testing.assert_allclose(out.numpy(),
                                   [ev.mean(), ev.std() / np.sqrt(PATHS)],
                                   rtol=1e-12)


class TestOrderings:
    def test_dominates_european_and_receiver_positive(self, sim):
        model = _model()
        v, e = BermudanSwaption(EX, FIN, K).get_value_and_error(sim)
        prod = BermudanSwaption(EX, FIN, K)
        best = max(model.swaption(t, list(prod.remaining_payments(i)), K)
                   for i, t in enumerate(EX))
        assert v >= best - 4 * e
        assert BermudanSwaption(EX, FIN, K, payer=False).get_value(sim) > 0.0
        assert prod.getValue(sim) == v


class TestValidation:
    def test_product_errors(self, sim):
        with pytest.raises(ValueError, match="ascending"):
            BermudanSwaption([3.0, 2.0], FIN, K)
        with pytest.raises(ValueError, match="ascending"):
            BermudanSwaption([], FIN, K)
        with pytest.raises(ValueError, match="final_maturity"):
            BermudanSwaption(EX, 6.0, K)
        with pytest.raises(ValueError, match="foresight_bias"):
            BermudanSwaption(EX, FIN, K, foresight_bias="none")
        with pytest.raises(ValueError, match="grid"):
            BermudanSwaption([2.25, 3.0], FIN, K).get_value(sim)
