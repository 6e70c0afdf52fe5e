"""The port's utilities (``finmath_tpu_torch/utils/memory.py``,
``profiling.py``, ``logging_config.py``, ``serialization.py``) against the
JAX package's contracts: the counterparts of
``tests/test_memory_and_aux.py:42-46, :128-140`` and
``tests/test_products_and_utils.py:54-79``.

* Memory info on the CPU: every field None and ``free_fraction`` None (the
  JAX package's virtual CPU devices); no device means ``select_device()``,
  which raises without a card. ``live_device_arrays`` rises by one for a
  new tensor and falls back after ``del``.
* ``configure_logging`` stops propagation, prints DEBUG to stderr, and the
  test restores the shared logger.
* ``trace`` logs its label at INFO on the ``finmath_tpu_torch`` logger;
  ``capture_trace`` writes a non-empty Chrome trace on the CPU, also when
  its body raises.
* Checkpoints: a file written by the JAX package's ``save_checkpoint``
  loads in the port bit for bit, and the reverse; the ``.npz`` suffix rule
  (a dotted name keeps its segment).
* The port's ATM engine (512 paths of its own seeded stream, the size of
  ``tests/test_torch_atm_calibration.py``'s engine) gives bit-equal
  residuals after a round trip."""

import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from finmath_tpu_torch.utils import logging_config, memory  # noqa: E402
from finmath_tpu_torch.utils import profiling, serialization  # noqa: E402

CPU = "cpu"


def test_memory_info_on_the_cpu():
    info = memory.get_device_memory_info(CPU)
    assert info.bytes_in_use is None and info.bytes_limit is None
    assert info.peak_bytes_in_use is None
    assert info.free_fraction is None
    assert repr(info) == "DeviceMemoryInfo(unavailable)"
    full = memory.DeviceMemoryInfo(bytes_in_use=2 ** 30,
                                   bytes_limit=4 * 2 ** 30,
                                   peak_bytes_in_use=2 ** 31)
    assert full.free_fraction == 0.75
    assert repr(full) == ("DeviceMemoryInfo(in_use=1024.0MiB, "
                          "limit=4096.0MiB, free=75.0%)")


def test_live_device_arrays_counts_tensors():
    before = memory.live_device_arrays(CPU)
    x = torch.arange(7.0)
    assert memory.live_device_arrays(CPU) == before + 1
    assert memory.live_device_arrays("meta") == 0
    del x
    assert memory.live_device_arrays(CPU) == before


def test_entry_points_default_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.delenv("FINMATH_TPU_DEVICE_INDEX", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memory.get_device_memory_info()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memory.live_device_arrays()


def test_configure_console(capsys):
    logger = logging_config.configure_logging(console_level=logging.DEBUG)
    try:
        assert logger.name == logging_config.ROOT_LOGGER == \
            "finmath_tpu_torch"
        assert logger.propagate is False
        assert len(logger.handlers) == 1
        logging.getLogger("finmath_tpu_torch.calibration").debug(
            "pool trace message")
        captured = capsys.readouterr()
        assert "pool trace message" in captured.err
        assert "finmath_tpu_torch.calibration DEBUG" in captured.err
        # a second call replaces the handlers instead of adding to them
        logging_config.configure_logging(console_level=logging.INFO)
        assert len(logger.handlers) == 1
        assert logger.handlers[0].level == logging.INFO
    finally:
        logger.handlers.clear()
        logger.propagate = True
        logger.setLevel(logging.NOTSET)


def test_trace_logs_its_label(caplog):
    with caplog.at_level(logging.INFO, logger="finmath_tpu_torch"):
        with profiling.trace("unit-test-region"):
            torch.ones(4).sum()
    assert any("unit-test-region" in r.message
               and r.name == "finmath_tpu_torch" for r in caplog.records)


def test_capture_trace_writes_a_chrome_trace(tmp_path):
    with profiling.capture_trace(str(tmp_path / "a")):
        with profiling.trace("captured-region"):
            torch.ones(1000).cumsum(0)
    files = list((tmp_path / "a").glob("trace.*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "captured-region" for e in events)
    # the trace is written when the body raises, too
    with pytest.raises(ZeroDivisionError):
        with profiling.capture_trace(str(tmp_path / "b")):
            torch.ones(3).sum()
            1 / 0
    files = list((tmp_path / "b").glob("trace.*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


@pytest.mark.parametrize("name", ["ckpt", "model.v2", "done.npz"])
def test_checkpoints_cross_the_packages(tmp_path, name):
    from finmath_tpu.utils import serialization as jser

    params = np.random.default_rng(3).standard_normal(43) * 1e-3
    meta = {"workload": "atm", "paths": 4000, "rms": 1.25e-4}
    jser.save_checkpoint(str(tmp_path / "jax" / name), params, meta)
    got, got_meta = serialization.load_checkpoint(str(tmp_path / "jax" / name))
    assert got.dtype == np.float64 and got_meta == meta
    np.testing.assert_array_equal(got, params)
    serialization.save_checkpoint(str(tmp_path / "port" / name), params,
                                  meta)
    back, back_meta = jser.load_checkpoint(str(tmp_path / "port" / name))
    assert back_meta == meta
    np.testing.assert_array_equal(back, params)
    assert (tmp_path / "port" / (name if name.endswith(".npz")
                                 else name + ".npz")).exists()
    # the same bytes of the two arrays
    a = np.load(tmp_path / "jax" / (name if name.endswith(".npz")
                                    else name + ".npz"))
    b = np.load(tmp_path / "port" / (name if name.endswith(".npz")
                                     else name + ".npz"))
    assert sorted(a.files) == sorted(b.files) == ["metadata", "parameters"]
    assert a["parameters"].tobytes() == b["parameters"].tobytes()
    assert str(a["metadata"]) == str(b["metadata"])


def test_atm_residuals_after_a_round_trip(tmp_path):
    from finmath_tpu_torch.models.lmm import atm_calibration as tatm

    setup = tatm.build_atm_calibration(num_paths=512, num_factors=1, seed=1,
                                       device=CPU)
    engine = setup.engine
    params = np.asarray(setup.covariance.initial_parameters) * 1.07
    before = engine.residuals(params)
    path = str(tmp_path / "model_ckpt")
    serialization.save_checkpoint(path, params, {"workload": "atm",
                                                 "paths": 512})
    restored, meta = serialization.load_checkpoint(path)
    assert meta == {"workload": "atm", "paths": 512}
    np.testing.assert_array_equal(restored, params)
    np.testing.assert_array_equal(engine.residuals(restored), before)
