"""CPU tests of the readers of the program's own spans
(``program_spans.py`` and the metrics that use it): idle device time
goes to the innermost span open at each of its nanoseconds, by overlap;
per request by the root spans, which have to be one per traced request;
and every reader returns nothing for a program without ``spans`` (the
parent of the change that added them), for a trace without device
operations, and for spans outside the window.

    python -m pytest portbench/test_portbench_program_spans.py -q
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import harness  # noqa: E402
import program_spans  # noqa: E402
import trace as trace_mod  # noqa: E402
from finmath_tpu_torch.utils import profiling  # noqa: E402

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
# the metrics that read the program's spans
READERS = [m["name"] for m in SPEC["per_layer"] if "program_spans" in (
    BENCH / "metrics" / f"{m['name']}.py").read_text()]


def _span(name, start, end, id_, parent=0, root=None, **attrs):
    return profiling.SpanRecord(name, start, end, id_, parent,
                                root if root is not None else id_, 1, attrs)


def _price(base, id_):
    """One price at ``base``: inputs, upload, launch under the root."""
    return [_span("finmath.pricer.inputs", base + 10, base + 100, id_ + 1,
                  id_, id_),
            _span("finmath.pricer.upload", base + 100, base + 120, id_ + 2,
                  id_, id_),
            _span("finmath.pricer.launch", base + 120, base + 150, id_ + 3,
                  id_, id_),
            _span("finmath.pricer.price", base, base + 400, id_,
                  kernel="k", paths=8)]


def _ctx(spans, busy, window=(0, 1000), requests=2):
    tr = trace_mod.Trace(window=window, device_ops=[
        ("kernel", a, b - a) for a, b in busy])
    return SimpleNamespace(trace=tr, traced_requests=requests), spans


def test_idle_goes_to_the_innermost_span_by_overlap():
    spans = _price(0, 1) + _price(500, 11)
    # the device busy from each launch's end for 300 ns
    ctx, spans = _ctx(spans, [(150, 450), (650, 950)])
    by = program_spans.idle_under(ctx, "finmath.pricer.price", spans)
    # per price: 0-10 under the root, 10-100 inputs, 100-120 upload,
    # 120-150 launch; 450-500 and 950-1000 outside every span
    assert by == {"finmath.pricer.price": 10.0, "finmath.pricer.inputs": 90.0,
                  "finmath.pricer.upload": 20.0, "finmath.pricer.launch": 30.0}
    # one gap across several spans is split, not given to its middle
    gaps = [(0, 1000)]
    assert program_spans.attribute(gaps, _price(0, 1)) == {
        "finmath.pricer.price": 260, "finmath.pricer.inputs": 90,
        "finmath.pricer.upload": 20, "finmath.pricer.launch": 30}


def test_roots_must_be_one_per_traced_request():
    spans = _price(0, 1) + _price(500, 11)
    ctx, _ = _ctx(spans, [(150, 450)], requests=3)
    assert program_spans.idle_under(ctx, "finmath.pricer.price", spans) is None
    # a span that leaves the window is not read
    ctx, _ = _ctx(spans, [(150, 450)], window=(0, 700), requests=2)
    assert program_spans.records(ctx, "finmath.pricer.price", spans) is None


def _readers_on(monkeypatch, spans, busy, requests):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    ctx, _ = _ctx(spans, busy, requests=requests)
    return {name: harness.load_module(
        BENCH / "metrics" / f"{name}.py").read(ctx) for name in READERS}


def test_the_readers_read_per_request(monkeypatch):
    run = _span("finmath.lm.run", 0, 900, 1, rejected_steps=3,
                residual_calls=6, jacobian_calls=2, iterations=2)
    call = _span("finmath.backend.jacobian", 100, 800, 2, 1, 1, sets=17)
    parts = [_span("finmath.lm.solve", 10, 100, 3, 1, 1),
             _span("finmath.backend.pack", 100, 300, 4, 2, 1),
             _span("finmath.backend.launch", 300, 350, 5, 2, 1),
             _span("finmath.backend.reduce", 400, 420, 6, 2, 1),
             _span("finmath.backend.implied_vol", 420, 700, 7, 2, 1)]
    got = _readers_on(monkeypatch, parts + [call, run], [(350, 400)], 1)
    assert got["lm_rejected_steps"] == 3.0
    assert got["lm_idle_ms.solve"] == pytest.approx(90e-6)
    assert got["backend_idle_ms.pack"] == pytest.approx(200e-6)
    assert got["backend_idle_ms.launch"] == pytest.approx(50e-6)
    assert got["backend_idle_ms.reduce"] == pytest.approx(20e-6)
    assert got["backend_idle_ms.implied_vol"] == pytest.approx(280e-6)
    assert got["backend_idle_ms.self"] == pytest.approx(100e-6)
    assert got["pricer_idle_us.inputs"] is None          # no price roots
    spans = _price(0, 1) + _price(500, 11)
    got = _readers_on(monkeypatch, spans, [(150, 450), (650, 950)], 2)
    assert got["pricer_idle_us.inputs"] == pytest.approx(0.09)
    assert got["pricer_idle_us.upload"] == pytest.approx(0.02)
    assert got["pricer_idle_us.launch"] == pytest.approx(0.03)
    assert got["lm_rejected_steps"] is None


def test_no_reading_without_the_programs_spans_or_the_device(monkeypatch):
    spans = _price(0, 1) + _price(500, 11)
    # a trace with no device operation (a run on the CPU)
    assert all(v is None for v in
               _readers_on(monkeypatch, spans, [], 2).values())
    # the parent: a profiling module without spans
    monkeypatch.delattr(profiling, "spans")
    ctx, _ = _ctx(spans, [(150, 450), (650, 950)])
    for name in READERS:
        reader = harness.load_module(BENCH / "metrics" / f"{name}.py")
        assert reader.read(ctx) is None, name
