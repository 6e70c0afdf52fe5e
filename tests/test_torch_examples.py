"""The port's examples (``finmath_tpu_torch/examples/01-04``), each imported
with ``importlib`` from its file path and its ``main`` run in this process
on ``device="cpu"`` at a small size; example 04 starts one world of four
gloo CPU ranks for the file (``parallel.launch``), as ``main`` does.

* 01: the vector chain equals the float oracle (the script's assert) and
  the JAX package's ``RandomVariableTPU`` chain on the same input within
  1e-6 relative.
* 02: the object API and the fused pricer within the script's 0.005 of
  the analytic price, the autograd delta within 0.02 of the tape's (the
  script's asserts), and within 0.02 of the analytic delta, the vega
  within 0.05 of the analytic vega.
* 03: the ATM calibration's |mean deviation| < 2e-4 and the bit-exact
  round trip (the script's asserts); the checkpoint it writes to the given
  path loads in the JAX package bit for bit; the 144 x 43 Jacobian.
* 04: every rank returns the same residuals, gradient and ladder (the
  script's assert), the gradient is finite, the ladder has 80 buckets.
* Each of the 16 scripts imports only the standard library, numpy, torch
  and the port, and runs on the card unless it is given ``device="cpu"``
  (without a card, the default raises: checked for 01, 04, 05 and 16).
  Examples 05-16 run in ``tests/test_torch_examples_lmm.py`` and
  ``tests/test_torch_examples_models.py``."""

import ast
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "finmath_tpu_torch" / \
    "examples"
NAMES = ["01_random_variables", "02_black_scholes_greeks",
         "03_lmm_calibration", "04_multichip_sharding",
         "05_pallas_kernels_and_bermudan",
         "06_lazy_qmc_and_reference_stream", "07_risk_ladders",
         "08_exposure_cva", "09_model_zoo", "10_exotics_and_rainbows",
         "11_rates_cube_cms_bermudan", "12_localvol_structured_caps_hybrid",
         "13_credit_xccy_portfolio", "14_inflation_commodity_risk",
         "15_bermudan_exposure_kva", "16_kernel_calibration_and_portfolio"]
CPU = "cpu"


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"port_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(name, **kw):
    """``main(device="cpu", **kw)`` of example ``name``: its result and
    what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = load(name).main(device=CPU, **kw)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def sharding_run():
    """Example 04 on one world of four gloo CPU ranks, with its output."""
    return run(NAMES[3], num_ranks=4, num_paths=800)


def test_01_random_variables(capsys):
    from finmath_tpu.ops.random_variable import RandomVariableTPU

    out = load(NAMES[0]).main(num_paths=20_000, device=CPU)
    printed = capsys.readouterr().out
    for head in ("average ", "standard error ", "5%/95% quantiles ",
                 "oracle average ",
                 "mixed-priority op promotes to the device type: OK"):
        assert head in printed
    paths = np.random.default_rng(0).uniform(0.5, 2.0, 20_000).astype(
        np.float32)
    x = RandomVariableTPU(0.0, paths)
    y = x.mult(1.01).add(0.02).exp().log().discount(x, 0.5)
    y = y.add_product(x, x).cap(3.0).floor(0.1).sqrt()
    assert out["average"] == pytest.approx(y.get_average(), rel=1e-6)
    assert out["oracle_average"] == pytest.approx(out["average"], abs=1e-5)


def test_02_black_scholes_greeks(capsys):
    from finmath_tpu_torch.models.analytic import black_scholes_option_value

    ex = load(NAMES[1])
    out = ex.main(object_paths=20_000, fused_paths=20_000,
                  greek_paths=20_000, device=CPU)
    printed = capsys.readouterr().out
    assert "| object API " in printed and "| fused " in printed
    assert "autograd:  delta " in printed and "AAD tape:  delta " in printed
    s0, r, sig, t, k = ex.S0, ex.R, ex.SIGMA, ex.T, ex.K
    assert out["analytic"] == black_scholes_option_value(s0, r, sig, t, k)
    d1 = (math.log(s0 / k) + (r + 0.5 * sig * sig) * t) / (sig * math.sqrt(t))
    delta = 0.5 * (1.0 + math.erf(d1 / math.sqrt(2.0)))
    vega = s0 * math.sqrt(t) * math.exp(-0.5 * d1 * d1) / math.sqrt(
        2.0 * math.pi)
    assert abs(out["delta"] - delta) < 0.02
    assert abs(out["vega"] - vega) < 0.05
    assert abs(out["delta_aad"] - out["delta"]) < 0.02


def test_03_lmm_calibration(tmp_path, capsys):
    from finmath_tpu.utils.serialization import load_checkpoint

    path = tmp_path / "ckpt" / "lmm_calibrated.npz"
    out = load(NAMES[2]).main(str(path), num_paths=1_000,
                              jacobian_paths=500, device=CPU)
    printed = capsys.readouterr().out
    assert "144 calibration products on the 40Y grid" in printed
    assert "checkpoint round-trip: revaluation bit-exact" in printed
    assert abs(out["deviations"].mean()) < 2e-4
    assert out["jacobian_shape"] == (144, 43)
    params, meta = load_checkpoint(str(path))
    np.testing.assert_array_equal(params, out["parameters"])
    assert meta == out["metadata"] and meta["paths"] == 1_000


def test_04_multichip_sharding(sharding_run):
    out, printed = sharding_run
    assert out["world_size"] == 4 and out["backend"] == "gloo"
    assert out["device"] == CPU
    assert out["residuals"].shape == (70,)
    assert np.all(np.isfinite(out["residuals"]))
    assert out["gradient"].shape == (43,)
    assert np.all(np.isfinite(out["gradient"])) and np.any(out["gradient"])
    assert out["ladder"].shape[0] == 80
    assert out["dates"] > 0 and out["cva"] > 0 and out["peak_ee"] > 0
    assert out["collectives"] > 0
    for line in ("4 ranks: gloo on cpu",
                 "sharded residuals over 4 ranks: 70 products",
                 "loss gradient through the collective: 43 params, finite",
                 "sharded exposure profile: ", "sharded CVA "):
        assert line in printed


@pytest.mark.parametrize("name", NAMES)
def test_imports_only_the_port(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert roots <= {"os", "sys", "math", "tempfile", "time", "numpy",
                     "torch", "finmath_tpu_torch"}, roots


def test_default_device_is_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(NAMES[0]).main(num_paths=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(NAMES[3]).main(num_ranks=1)
    for name in (NAMES[4], NAMES[15]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(name).main()
