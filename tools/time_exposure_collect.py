"""Time the netting-set exposure collector on one card, its kernel against
its plain version, at the exposure cell's shapes
(``portbench/configs/xva_sv_5f.json``: 200 trades, 39 dates, float64
paths), and check the two against each other.

    python3 tools/time_exposure_collect.py [--paths 1048576] [--repeats 5]
        [--profiles 2] [--out FILE]

Run it from the repository root. One simulation keeps each date's live
forwards and numeraire; each date is then collected by both versions into
buffers of its own: the kernel's launch alone and the plain version's
composition with its buffer writes, each timed with CUDA events (the
median of ``--repeats``), and their outputs compared (the broken paths
must be the same; the largest gaps over the largest values). Then
``--profiles`` whole profiles on fresh paths (the kernel: the engine
takes it on the card), their walls on the host clock and their launches.
The parent commit's profiles, through the plain version, are the
benchmark's to compare. Prints the card's line,
the kernel's ``-Xptxas -v`` report and one JSON line, also written to
``--out`` when given. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _one_date(plan, ev):
    """The plan of date ``ev`` alone (buffers of one row)."""
    sl = slice(ev, ev + 1)
    und = plan.und_tables is not None
    return dataclasses.replace(
        plan, dates=(plan.dates[ev],), swap_tables=[plan.swap_tables[ev]],
        swap_coefs=plan.swap_coefs[sl],
        und_tables=[plan.und_tables[ev]] if und else None,
        und_alive=plan.und_alive[sl] if und else None,
        rows=plan.rows[sl], reals=plan.reals[sl],
        counts=(plan.counts[ev],))


def _events_ms(torch, fn, repeats):
    """Median device milliseconds of ``fn()`` over ``repeats`` runs."""
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _gap(torch, a, b, ok):
    """Largest |a - b| over the finite paths, over the largest |b|."""
    a = a.to(torch.float64)[..., ok]
    b = b.to(torch.float64)[..., ok]
    peak = float(b.abs().max())
    return float((a - b).abs().max()) / (peak if peak > 0 else 1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", type=int, default=1 << 20)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--profiles", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2500000001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from finmath_tpu_torch.models.lmm import build_benchmark_calibration
    from finmath_tpu_torch.models.lmm.exposure import (
        CSA, BermudanSwaptionTrade, NettingSetExposureEngine, SwapTrade,
        SwaptionTrade)
    from finmath_tpu_torch.ops import _cuda_build
    from finmath_tpu_torch.ops import exposure_collect as xc

    if not torch.cuda.is_available():
        raise SystemExit("time_exposure_collect: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    xc.load_kernel()
    build_s = time.perf_counter() - t0
    log = _cuda_build.library_path(xc.SOURCE, (), xc.FLAGS).with_suffix(
        ".log")
    print(log.read_text() if log.is_file() else "(no ptxas log)",
          flush=True)

    # is the card's cumprod a running product in the tensor's own type?
    dev = "cuda"
    r = 0.5 + torch.rand((39, 4099), device=dev, dtype=torch.float64)
    cumprod_in_type = {}
    for dt in (torch.float32, torch.float64):
        rr, c = r.to(dt), torch.ones(4099, device=dev, dtype=dt)
        rows = []
        for k in range(rr.shape[0]):
            c = c * rr[k]
            rows.append(c)
        cumprod_in_type[str(dt)] = bool(torch.equal(
            torch.cumprod(rr, dim=0), torch.stack(rows)))
    print("cumprod is a running product in its type:", cumprod_in_type,
          flush=True)

    cfg = json.loads(Path("portbench/configs/xva_sv_5f.json").read_text())
    t = cfg["trades"]
    trades = (
        [SwapTrade(s["first"], s["last"], s["strike"], s["payer"],
                   s["notional"]) for s in t["swaps"]]
        + [SwaptionTrade(e["exercise"], e["periods"], e["strike"],
                         e["notional"]) for e in t["europeans"]]
        + [BermudanSwaptionTrade(tuple(b["exercises"]), b["last"],
                                 b["strike"], b["notional"])
           for b in t["bermudans"]])
    F = int(cfg["num_factors"])
    model = build_benchmark_calibration(num_paths=256, num_factors=F,
                                        device=dev).model
    eng = NettingSetExposureEngine(
        model, trades, num_paths=args.paths, num_factors=F, seed=args.seed,
        observation_indices=cfg["observation_indices"],
        quantiles=cfg["quantiles"], csa=CSA(**cfg["csa"]),
        dtype=getattr(torch, cfg["precision"]["paths"]), device=dev)
    x = np.asarray(cfg["parameters"], dtype=np.float64)
    plan = eng._collect_plan

    blocks = []
    with torch.no_grad():
        eng.engine._simulate_collect(
            eng.engine._params(x),
            lambda e, ev, L, N: blocks.append((L.clone(), N.clone())))
    torch.cuda.synchronize()

    dates = []
    with torch.no_grad():
        for ev, (L, N) in enumerate(blocks):
            one = _one_date(plan, ev)
            got = xc.collect_buffers(one, args.paths, dev)
            ref = xc.collect_buffers(one, args.paths, dev)
            k_ms = _events_ms(torch, lambda: xc.exposure_collect(
                L, N, one, 0, got), args.repeats)
            p_ms = _events_ms(torch, lambda: xc.write_rows(
                ref, 0, xc.exposure_collect_reference(L, N, one, 0)),
                args.repeats)
            ok_g = (torch.isfinite(got.net) & torch.isfinite(got.inv)
                    & torch.isfinite(got.plus) & got.und_finite)[0]
            ok_r = (torch.isfinite(ref.net) & torch.isfinite(ref.inv)
                    & torch.isfinite(ref.plus) & ref.und_finite)[0]
            row = dict(
                e=plan.dates[ev], kernel_ms=k_ms, plain_ms=p_ms,
                rows=plan.counts[ev], broken=int((~ok_r).sum()),
                same_broken=bool(torch.equal(ok_g, ok_r)),
                inv_equal=bool(torch.equal(got.inv[0][ok_r],
                                           ref.inv[0][ok_r])),
                net_gap=_gap(torch, got.net[0], ref.net[0], ok_r),
                plus_gap=_gap(torch, got.plus[0], ref.plus[0], ok_r),
                und_gap=_gap(torch, got.und[0], ref.und[0], ok_r),
                rate_gap=_gap(torch, got.rates[0], ref.rates[0], ok_r))
            dates.append(row)
            print(json.dumps(row), flush=True)
            del got, ref
    del blocks
    torch.cuda.empty_cache()

    walls, launches = [], []
    for i in range(args.profiles):
        eng.reseed(args.seed + 1 + i)
        torch.cuda.synchronize()
        before = xc.LAUNCHES
        t0 = time.perf_counter()
        eng.profile(x)
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(xc.LAUNCHES - before)
        print(f"profile {i}: wall {walls[-1]:.1f} ms, {launches[-1]} "
              f"launches", flush=True)

    result = dict(
        card=smi, torch=torch.__version__, paths=args.paths,
        build_s=build_s, cumprod_in_type=cumprod_in_type,
        kernel_ms_profile=sum(r["kernel_ms"] for r in dates),
        plain_ms_profile=sum(r["plain_ms"] for r in dates),
        kernel_ms_date_max=max(r["kernel_ms"] for r in dates),
        same_broken=all(r["same_broken"] for r in dates),
        inv_equal=all(r["inv_equal"] for r in dates),
        broken=sum(r["broken"] for r in dates),
        net_gap=max(r["net_gap"] for r in dates),
        plus_gap=max(r["plus_gap"] for r in dates),
        und_gap=max(r["und_gap"] for r in dates),
        rate_gap=max(r["rate_gap"] for r in dates),
        profile_ms=walls, launches_a_profile=launches)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
