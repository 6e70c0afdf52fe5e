"""CPU tests of the benchmark's files: every cell resolves by name, a cell
added as data alone is found, names and units are well formed, every
per-layer metric's end-to-end metric is reported where it is, the kernel
counts are ``chip_smoke.py``'s, the harness loads no JAX, the reference
none of the program, and the measurement path refuses to run without a
card.

    python -m pytest portbench -q
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.resolve(SPEC, cell)
    assert c.loop.is_file() and c.target.is_file()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for path in c.metric_files.values():
        assert path.is_file(), path
    assert c.cfg["name"] == c.cell["config"]
    for name in c.limits:
        assert NAME.match(name)


def test_a_new_cell_is_data_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    traffic = json.loads((BENCH / "traffic" / "price_4096k.json").read_text())
    traffic["paths"] = 409600
    (tmp_path / "portbench" / "traffic" / "price_409600.json").write_text(
        json.dumps(traffic))
    spec["workloads"].append({"name": "lmm_atm_1f.price_409600",
                              "config": "lmm_atm_1f",
                              "traffic": "price_409600", "chips": 1,
                              "why": "a data-only cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "lmm_atm_1f.price_4096k" in m.get("workloads", []):
            m["workloads"].append("lmm_atm_1f.price_409600")
    c = harness.resolve(spec, "lmm_atm_1f.price_409600",
                        tmp_path / "portbench")
    assert c.traffic["paths"] == 409600
    assert {m["name"] for m in c.end_to_end} == {
        "price_ms", "price_p95_ms", "setup_s"}
    assert "swaption_paths_roofline" in c.metric_files


# a new kind of traffic on a new system, added as new files only: its
# loop, its target with the check, its configuration, its mix and a
# per-layer metric's reader
_TOY = {
    "loops/sum.py": '''
from seeds import ORDER, seed_words


class Loop:
    def __init__(self, target, traffic, seed):
        self.target = target
        self.base = seed_words(seed)[ORDER] % 1000

    def request(self, k):
        return self.target.request(self.base + k)

    def ends_window(self, k):
        return True

    @staticmethod
    def end_to_end(window_s, latencies):
        return {"sum_ms": (1e3 * window_s / len(latencies), "ms")}
''',
    "systems/toy/sum.py": '''
import numpy as np
import torch

from seeds import sample


class Target:
    def __init__(self, cfg, traffic, seed, device, rec):
        self.n, self.traffic = int(traffic["n"]), traffic
        self.shape = {}
        x = torch.arange(self.n, dtype=torch.float64, device=device)
        self._sum = rec.timed("toy", lambda k: float((x + k).sum()))

    def request(self, k):
        return dict(k=k, value=self._sum(k), ok=True)

    def close(self):
        self._sum = None

    def check(self, records, rng, control=False):
        gap = 0.0
        for i in sample(len(records), self.traffic["check_requests"], rng):
            k, got = records[i]["k"], records[i]["value"]
            ref = float(np.arange(self.n, dtype=np.float64).sum() + k * self.n)
            if control:
                got = float(np.arange(self.n, dtype=np.float16).sum()
                            + np.float16(k) * self.n)
            gap = max(gap, abs(got - ref) / ref)
        return {"sum_gap": gap}
''',
    "metrics/toy_calls.py": '''
def read(ctx):
    return ctx.spans.calls.get("toy", 0) / ctx.requests
''',
    "configs/toy.json": json.dumps({"name": "toy", "system": "toy",
                                    "limits": {"sum": {"sum_gap": 1e-12}},
                                    "reduced": []}),
    "traffic/sum_small.json": json.dumps({
        "kind": "sum", "n": 4096, "warmup_requests": 1, "trace_seconds": 0.1,
        "check_requests": 3}),
}


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_kind_of_traffic_is_new_files_alone(tmp_path, trace):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    for name, text in _TOY.items():
        (bench / name).parent.mkdir(parents=True, exist_ok=True)
        (bench / name).write_text(text)
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "toy", "source": "https://example.org",
                            "file": "portbench/configs/toy.json",
                            "reduced": [], "why": "a toy"})
    spec["workloads"].append({"name": "toy.sum_small", "config": "toy",
                              "traffic": "sum_small", "chips": 1,
                              "why": "a new kind as files alone"})
    spec["end_to_end"].insert(0, {
        "name": "sum_ms", "unit": "ms", "better": "lower", "bound": 0.1,
        "source": "host_clock", "workloads": ["toy.sum_small"]})
    spec["per_layer"].append({
        "name": "toy_calls", "unit": "calls", "better": "lower",
        "source": "program_counter", "layer": "toy", "moves": "sum_ms",
        "workloads": ["toy.sum_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(bench)!r}, {str(ROOT)!r}]\n"
        "import harness\n"
        f"r = harness.run('toy.sum_small', 2**40 + 7, 0.3, {trace}, "
        "t_start=time.perf_counter(), device='cpu', control=True)\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["control"]["correct"] is False
    assert r["checks"]["sum_gap"]["value"] == 0.0
    if trace:
        assert r["metrics"]["toy_calls"]["value"] == 1.0
        assert r["device"]["window_s"] > 0.0
    else:
        assert set(r["metrics"]) == {"sum_ms", "setup_s"}
    assert r["attempted"] > 10 and r["failed"] == 0


def test_names_units_and_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in SPEC[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(1 <= len(layer) <= 200 for layer in layers)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["portbench"]


def test_each_metric_moves_what_its_cells_report():
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in SPEC["end_to_end"]
                        if cell in e.get("workloads", [cell])}
            assert m["moves"] in reported, (m["name"], cell)
    for cell in CELLS:
        c = harness.resolve(SPEC, cell)
        assert any(m["name"] != "setup_s" for m in c.end_to_end)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_pricer_counts_equal_chip_smoke():
    cs = _chip_smoke()
    from roofline import swaption_paths, sv_swaption_paths
    shape = dict(num_factors=1, steps=10, exercise=10, periods=20,
                 paths=409_600, num_libors=80)
    ops = swaption_paths.operations(shape, 1)
    assert ops == 1_250_918_400
    assert ops == cs._pricer_operations(1, 10, 10, 20, 409_600,
                                        stoch_vol=False) \
        + 3 * cs.DRAW_OPERATIONS * 409_600
    shape.update(num_factors=5, num_libors=40)
    assert sv_swaption_paths.operations(shape, 1) == cs._pricer_operations(
        5, 10, 10, 20, 409_600, stoch_vol=True) \
        + 15 * cs.DRAW_OPERATIONS * 409_600


@pytest.mark.parametrize("config,kernel,paths,batches", [
    ("lmm_atm_1f", "atm_products", 100_000, (1, 87)),
    ("lmm_sv_5f", "sv_products", 81_920, (1, 17)),
])
def test_sweep_counts_equal_chip_smoke(config, kernel, paths, batches):
    cs = _chip_smoke()
    from reference.lmm import Model
    from roofline import atm_products, sv_products
    module = {"atm_products": atm_products, "sv_products": sv_products}[kernel]
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    products = [(e, m, k) for e, m, k, _ in Model(cfg).products]
    sv = cfg["kind"] != "atm"
    shape = dict(num_libors=cfg["num_libors"], num_factors=cfg["num_factors"],
                 products=products, paths=paths, stoch_vol=sv,
                 displaced=False)
    for b in batches:
        assert module.operations(shape, b) == cs._sweep_operations(
            cfg["num_libors"], cfg["num_factors"], products, paths, b,
            stoch_vol=sv)


def test_configs_hold_the_programs_published_data():
    from finmath_tpu_torch.models import curves
    from finmath_tpu_torch.models.lmm import atm_calibration as atm
    from finmath_tpu_torch.models.lmm import benchmark_calibration as sv
    a = json.loads((BENCH / "configs" / "lmm_atm_1f.json").read_text())
    b = json.loads((BENCH / "configs" / "lmm_sv_5f.json").read_text())
    assert a["market"]["swap_rates"] == list(curves.EUR_SWAP_RATES)
    assert a["market"]["atm_normal_vols"] == list(atm.ATM_NORMAL_VOLS)
    assert b["market"]["forwards"] == list(sv.FORWARD_RATES)
    assert b["start"] == list(sv.CURATED_BASINS[0])


def test_reference_draws_the_kernels_normals():
    from finmath_tpu_torch.ops.kernels import normal_pairs
    from reference import philox
    seed = (1 << 63) + 12345
    want = normal_pairs(seed, 1000, 15)
    got = philox.normals(seed, 0, 1000, 60)
    # float32 draws against float64 ones: a few ulps of |z| <= 6
    assert float((got - want.double()).abs().max()) < 1e-5
    assert philox.normals(seed, 400, 1000, 7).shape == (7, 600)
    assert np.allclose(philox.normals(seed, 400, 1000, 7).numpy(),
                       got[:7, 400:].numpy())


def _modules_after(imports: str) -> set:
    code = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
            f"{imports}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    top = _modules_after(
        "import harness, host, seeds, spans, trace, rooflines\n"
        "import reference.lmm, reference.philox\n"
        "for d in ('metrics', 'loops', 'systems', 'roofline'):\n"
        "    for p in sorted((harness.BENCH / d).rglob('*.py')):\n"
        "        harness.load_module(p)\n"
        "import finmath_tpu_torch.models.lmm, finmath_tpu_torch.ops")
    assert not top & {"jax", "jaxlib", "flax", "finmath_tpu"}, top
    assert "finmath_tpu_torch" in top


def test_reference_loads_none_of_the_program():
    top = _modules_after("import reference.lmm, reference.philox")
    assert not top & {"jax", "finmath_tpu", "finmath_tpu_torch"}, top


def test_measurement_refuses_to_run_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
