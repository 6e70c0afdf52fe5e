"""On the card, at each cell's own size: the program's answers pass the
limits and the control (the reference in the program's place, one
precision below the configuration's: bfloat16 paths, float32 sums) comes
out not correct by the harness's own judgement, on three seeds a cell. Every calibration result of a short window
is checked (all path sets), and four prices of each seed's window. Skips
without a card; run on the card with

    python -m pytest portbench/test_portbench_control.py -q -s
"""

import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import harness  # noqa: E402

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (2_147_483_659, 3_000_000_019, 4_000_000_007)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only "
                    "there, and the control is read at the cell's size")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(card, cell):
    kind = harness.resolve(SPEC, cell).kind
    overrides = {"check_requests": 8 if kind == "calibrate" else 4}
    for seed in SEEDS:
        r = harness.run(cell, seed, 0.0 if kind == "calibrate" else 2.0,
                        False, t_start=time.perf_counter(), control=True,
                        traffic_overrides=overrides)
        print(json.dumps({"cell": cell, "seed": seed, "checks": r["checks"],
                          "control": r["control"]}), flush=True)
        assert r["correct"], r["checks"]
        assert r["control"]["correct"] is False, r["control"]
