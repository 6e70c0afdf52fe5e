"""CPU tests of the exposure cell's files: the cell resolves by name with
its metrics, its readers return nothing on a trace without the program's
exposure spans (and read the spans per profile where they are), the
reference's path blocks sum as one block, the
configuration holds the stoch-vol model's fields and the trades its seed
draws, and the roofline counts the regressions the engine fits.

    python -m pytest portbench/test_portbench_xva.py -q
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402
import trace as trace_mod  # noqa: E402
from finmath_tpu_torch.utils import profiling  # noqa: E402
from reference import lmm, xva  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "xva_sv_5f.profile_1024k"
CFG = json.loads((BENCH / "configs" / "xva_sv_5f.json").read_text())
NEW = ["xva_idle_ms.simulate", "xva_idle_ms.collect", "xva_idle_ms.regress",
       "xva_idle_ms.margin", "xva_idle_ms.reduce", "xva_regressions",
       "xva_profile_roofline"]
PARTS = ("simulate", "collect", "regress", "margin", "reduce")


def test_the_cell_resolves_with_its_metrics():
    c = harness.resolve(SPEC, CELL)
    assert c.target.is_file() and c.loop.name == "price.py"
    assert {m["name"] for m in c.end_to_end} == {"price_ms", "price_p95_ms",
                                                 "setup_s"}
    assert set(c.metric_files) == set(NEW) | {"device_idle_pct.price"}
    assert c.traffic["paths"] == 1 << 20 and c.cell["chips"] == 1
    assert set(c.limits) == {"profile_gap", "pfe_gap", "cva_gap"}


def _span(name, start, end, id_, parent=0, root=None, **attrs):
    return profiling.SpanRecord(name, start, end, id_, parent,
                                root if root is not None else id_, 1, attrs)


def _profile(base, id_, regressions=7):
    """One profile at ``base``: its six parts under the root."""
    spans = [_span("finmath.xva.simulate", base + 10, base + 200, id_ + 1,
                   id_, id_),
             _span("finmath.xva.collect", base + 50, base + 100, id_ + 2,
                   id_ + 1, id_)]
    for k, part in enumerate(PARTS[2:]):
        spans.append(_span(f"finmath.xva.{part}", base + 200 + 50 * k,
                           base + 250 + 50 * k, id_ + 3 + k, id_, id_))
    return spans + [_span("finmath.xva.profile", base, base + 400, id_,
                          trades=3, regressions=regressions)]


def _read(monkeypatch, spans, busy, requests=2, shape=None):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    tr = trace_mod.Trace(window=(0, 1000), device_ops=[
        ("kernel", a, b - a) for a, b in busy])
    ctx = SimpleNamespace(
        trace=tr, traced_requests=requests, kind="price",
        shape=shape or {}, peaks=harness.load_json(BENCH / "peaks.json"),
        load_module=harness.load_module, bench=BENCH)
    return {name: harness.load_module(
        BENCH / "metrics" / f"{name}.py").read(ctx) for name in NEW}


def test_the_readers_read_per_profile(monkeypatch):
    spans = _profile(0, 1) + _profile(500, 11, regressions=9)
    # busy 100-150 in each profile: of its idle, 10-50 and 150-200 under
    # simulate, 50-100 under collect, 50 under each later part
    got = _read(monkeypatch, spans, [(100, 150), (600, 650)],
                shape=_shape())
    assert got["xva_idle_ms.simulate"] == pytest.approx(90e-6)
    assert got["xva_idle_ms.collect"] == pytest.approx(50e-6)
    for part in PARTS[2:]:
        assert got[f"xva_idle_ms.{part}"] == pytest.approx(50e-6)
    assert got["xva_regressions"] == 8.0
    from roofline import xva_profile
    least = xva_profile.least_seconds(_shape(), harness.load_json(
        BENCH / "peaks.json"))
    assert got["xva_profile_roofline"] == pytest.approx(
        100.0 * least / 50e-9)


def test_no_reading_without_the_exposure_spans(monkeypatch):
    # another program's spans, a trace without device operations, and a
    # program without spans (the parent) all read as nothing
    other = [_span("finmath.pricer.price", 0, 400, 1),
             _span("finmath.pricer.price", 500, 900, 2)]
    assert all(v is None for v in _read(monkeypatch, other,
                                        [(100, 150)]).values())
    spans = _profile(0, 1) + _profile(500, 11)
    assert all(v is None for v in _read(monkeypatch, spans, []).values())
    assert all(v is None for v in _read(monkeypatch, spans, [(100, 150)],
                                        requests=3).values())
    monkeypatch.delattr(profiling, "spans")
    tr = trace_mod.Trace(window=(0, 1000), device_ops=[("k", 100, 50)])
    ctx = SimpleNamespace(trace=tr, traced_requests=2, kind="price",
                          shape=_shape())
    for name in NEW:
        assert harness.load_module(
            BENCH / "metrics" / f"{name}.py").read(ctx) is None, name


def _shape(paths=1 << 20):
    systems = harness.load_module(BENCH / "systems" / "xva" / "price.py")
    return systems.work_shape(CFG, paths)


def _market(cfg):
    model = lmm.Model(cfg)
    x = np.asarray(cfg["parameters"])
    b, nu, rho = model.scalars(x)
    return xva.Market(vol=model.vol_table(x), factors=model.factors(x),
                      L0=model.L0, deltas=model.deltas, blend=b, nu=nu,
                      rho=rho, dt=model.dt)


def test_the_references_blocks_sum_as_one():
    """The reference's path blocks (its regressions' normal equations
    summed over them) give one block's profile."""
    t = CFG["trades"]
    trades = {"swaps": t["swaps"][:6], "europeans": t["europeans"][:2],
              "bermudans": t["bermudans"][:2]}
    obs = list(range(1, max(s["last"] for s in trades["swaps"])))
    z = xva.normals(2 ** 63 + 5, max(obs), 6, 512, "cpu")
    a = xva.profile(_market(CFG), trades, obs, z, csa=CFG["csa"], block=200)
    b = xva.profile(_market(CFG), trades, obs, z, csa=CFG["csa"])
    for name in a:
        if name == "pfe":
            for q in a[name]:
                assert np.allclose(a[name][q], b[name][q], rtol=1e-12,
                                   atol=0.0)
        else:
            assert np.allclose(a[name], b[name], rtol=1e-12, atol=1e-15)


def test_the_configuration_holds_the_model_and_its_trades():
    sv = json.loads((BENCH / "configs" / "lmm_sv_5f.json").read_text())
    for key in ("num_libors", "dt", "last_time", "num_factors", "measure",
                "state_space", "numeraire_adjustment", "factor_signs",
                "market", "kind"):
        assert CFG[key] == sv[key], key
    model = lmm.Model(CFG)
    assert CFG["trades"] == xva.draw_trades(model.L0, model.deltas,
                                            CFG["trade_seed"])
    t = CFG["trades"]
    assert (len(t["swaps"]), len(t["europeans"]), len(t["bermudans"])) \
        == (160, 24, 16)
    assert CFG["observation_indices"] == list(range(1, 40))
    assert CFG["reduced"] == [] and len(CFG["parameters"]) == 8


def test_the_roofline_counts_the_engines_regressions():
    from finmath_tpu_torch.utils import profiling as prof
    systems = harness.load_module(BENCH / "systems" / "xva" / "price.py")
    traffic = dict(json.loads((BENCH / "traffic" / "profile_1024k.json")
                              .read_text()), paths=64)
    target = systems.Target(CFG, traffic, 3, torch.device("cpu"),
                            harness.spans.Recorder())
    prof.clear()
    with prof.recording():
        out = target.request(2 ** 64 - 1)
    root = next(s for s in prof.spans() if s.name == "finmath.xva.profile")
    from roofline import xva_profile
    assert root.attrs["regressions"] == xva_profile.regressions(_shape())
    assert root.attrs["trades"] == 200 and root.attrs["dates"] == 39
    assert out["ok"] and np.isfinite(out["cva"])
    prof.clear()
