"""Time the Monte-Carlo path kernels (European and Asian) against an earlier
commit's on one card.

    python3 tools/compare_mc_kernels.py --parent DIR

``DIR`` holds the earlier ``mc_paths.cu`` and ``philox.cuh`` (e.g. ``git
show <commit>:finmath_tpu_torch/csrc/<name>`` of each); the launchers
``mc_bs_paths_launch`` and ``mc_asian_paths_launch`` keep their interface.
The script builds the earlier source with the build's flags and the
current one as ``ops/kernels.py`` builds it. At 1,000,000 x 100 (the main
path, ``chip_smoke.py`` phase 14's seed), 1,000,003 x 99, 8,192 x 1, and
at 100 steps on the paths that fill four whole waves of the new build's
resident blocks (what the partial last wave of 1M paths costs), it checks
every path of each build against the earlier kernel's (``torch.equal`` of
the float32 bits) and times the launch alone (median of 5, CUDA events, a
spin kernel ahead, a preallocated output) in turns: earlier, new, new,
earlier, three times.
While the earlier and the new European kernel run for about a second each
at 1M x 100 it reads the SM clock (``nvidia-smi``). It prints, and writes
to ``chiprun_out/compare_mc.json``, the times, their spread, the share of
``chip_smoke.py``'s bound, ``ptxas``' registers, stack frame and spills
per kernel, the blocks an SM that those allow and the waves of each launch
on the card's SMs, and the SASS of one draw of four normals from
``cuobjdump``: the instructions on the path through the kernel's innermost
loop that holds a draw's two square roots (``MUFU.RSQ``) when no special
case occurs, over the loop's draws, by kind. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from compare_pricer_kernels import (  # noqa: E402
    _blocks_per_sm, _ptxas_by_kernel, _sass_functions)
from finmath_tpu_torch.ops import _cuda_build, kernels  # noqa: E402

SHAPES = ((cs.BS_PATHS, cs.BS_STEPS), (1_000_003, 99), (8_192, 1))
THREADS = 256                 # both builds' block: one path a thread
KERNELS = {"bs_paths": "bs_paths_kernel", "asian_paths": "asian_paths_kernel"}
ROUNDS = 3                    # rounds of earlier, new, new, earlier a shape

#: SASS opcodes by kind (the first word of the opcode, before any '.')
KINDS = {
    "IMAD": ("IMAD",),
    "integer ALU": ("LOP3", "IADD3", "SHF", "ISETP", "SEL", "LEA", "IABS",
                    "PRMT", "IMNMX", "FLO", "POPC"),
    "FFMA": ("FFMA",),
    "float, no FMA": ("FMUL", "FADD", "FSETP", "FSEL", "FMNMX", "FCHK",
                      "FSWZADD"),
    "MUFU": ("MUFU",),
    "conversion": ("I2F", "F2I", "I2FP", "F2F", "FRND", "F2FP"),
    "branch": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
               "BREAK", "JMP"),
}


def _opcode(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def _kind(opcode: str) -> str:
    root = opcode.split(".")[0]
    return next((k for k, roots in KINDS.items() if root in roots), "other")


COLD = ("CALL", "LDG", "LDL", "STL", "DMUL", "I2F.F64")


def _hot_path(ins, first: int, last: int):
    """The instructions that one pass of the loop ``ins[first:last + 1]``
    (``last`` its backward branch) issues when no special case occurs: a
    conditional forward branch is taken when the code it jumps over holds
    a library function's rare path (a call, a local or global load, a
    double-precision step: the reductions of large arguments and the
    square root's special inputs), and falls through otherwise; an
    unconditional branch is followed."""
    where = {addr: j for j, (addr, _) in enumerate(ins)}
    path, j = [], first
    while j < last:
        text = ins[j][1]
        path.append(text)
        m = re.search(r"\bBRA\s.*?(0x[0-9a-f]+)", text)
        if m:
            target = where[int(m.group(1), 16)]
            if not text.startswith("@"):
                j = target
                continue
            if target > j and any(_opcode(t).startswith(COLD)
                                  for _, t in ins[j + 1:target]):
                j = target
                continue
        j += 1
        if len(path) > 4 * len(ins):
            raise RuntimeError("no pass through the loop")
    return path + [ins[last][1]]


def _draw_sass(ins):
    """SASS of one draw of four normals: the innermost loop (a backward
    branch's body) holding a draw's two ``MUFU.RSQ``; the instructions of
    its hot path (``_hot_path``) over its draws, in total and by kind, and
    the loop's static size."""
    where = {addr: j for j, (addr, _) in enumerate(ins)}
    loops = []
    for j, (_, text) in enumerate(ins):
        m = re.search(r"\bBRA\s.*?(0x[0-9a-f]+)", text)
        if m and where.get(int(m.group(1), 16), j + 1) <= j:
            loops.append((where[int(m.group(1), 16)], j))
    for first, last in sorted(loops, key=lambda fl: fl[1] - fl[0]):
        path = _hot_path(ins, first, last)
        ops = [_opcode(t) for t in path]
        rsq = sum(op == "MUFU.RSQ" for op in ops)
        if rsq >= 2:
            draws = rsq / 2
            kinds = Counter(_kind(op) for op in ops)
            return {"per_draw": len(path) / draws, "draws_a_loop": draws,
                    "loop_static": last + 1 - first,
                    "by_kind": {k: kinds[k] / draws for k in
                                (*KINDS, "other") if kinds[k]},
                    "by_opcode": {op: n / draws for op, n in
                                  Counter(ops).most_common()}}
    return None


def _build_parent(src: Path, out_dir: Path):
    out = out_dir / f"old_{src.stem}.so"
    proc = subprocess.run(
        [_cuda_build.nvcc_path(), *_cuda_build.NVCC_FLAGS, "-o", str(out),
         str(src)], capture_output=True, text=True, check=True)
    return out, proc.stdout + proc.stderr


def _launchers(path: Path):
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in KERNELS:
        fn = getattr(lib, f"mc_{name}_launch")
        fn.argtypes = [ptr, i32, i32, ctypes.c_ulonglong, f32, f32, f32, f32,
                       ptr]
        fn.restype = i32
    return lib


def _sm_clock(run, seconds=1.2):
    """nvidia-smi's SM clock and its maximum (MHz), read three times while
    ``run`` (which enqueues one launch) is called in a loop on another
    thread."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            for _ in range(50):
                run()
            torch.cuda.synchronize()

    worker = threading.Thread(target=spin)
    worker.start()
    reads = []
    try:
        time.sleep(seconds / 3)
        for _ in range(3):
            reads.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw", "--format=csv,noheader"], capture_output=True,
                text=True, check=True).stdout.strip().splitlines()[0])
            time.sleep(seconds / 6)
    finally:
        stop.set()
        worker.join(timeout=60)
    return reads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" /
                                         "compare_mc.json"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_mc_kernels: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{smi}; {sms} SMs", flush=True)

    out_dir = _cuda_build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(1) as pool:
        old = pool.submit(_build_parent, opts.parent / kernels.SOURCE,
                          out_dir)
        kernels.load_kernel()
        old = old.result()
    new_so = _cuda_build.library_path(kernels.SOURCE, (), kernels.FLAGS)
    builds = {"earlier": old,
              "new": (new_so, new_so.with_suffix(".log").read_text())}
    libs = {b: _launchers(so) for b, (so, _) in builds.items()}
    stream = torch.cuda.current_stream().cuda_stream

    report = {"card": smi, "sms": sms, "kernels": {}}
    static = {}
    for b, (so, log) in builds.items():
        regs, funcs = _ptxas_by_kernel(log), _sass_functions(so)
        for name, entry in KERNELS.items():
            key = next(e for e in regs if entry in e)
            fkey = next(f for f in funcs if entry in f)
            static[b, name] = {
                **regs[key],
                "blocks_per_sm": _blocks_per_sm(regs[key]["registers"],
                                                THREADS, 0),
                "sass_function": len(funcs[fkey]),
                "sass_draw": _draw_sass(funcs[fkey])}

    bad = []
    for name in KERNELS:
        rows = []
        # and the main path's steps on whole waves of the new build (four
        # rounds of its resident blocks), to see what the partial last wave
        # of 1M paths costs
        whole = 4 * sms * static["new", name]["blocks_per_sm"] * THREADS
        for paths, steps in (*SHAPES, (whole, cs.BS_STEPS)):
            params = kernels.path_params(steps, *cs.BS_PARAMS)
            p4 = [float(v) for v in params[:4].tolist()]
            outs = {}
            runs = {}
            for b, lib in libs.items():
                out = torch.empty(paths, dtype=torch.float32, device="cuda")
                fn = getattr(lib, f"mc_{name}_launch")

                def run(fn=fn, out=out, paths=paths, steps=steps, p4=p4):
                    err = fn(out.data_ptr(), paths, steps, cs.BS_SEED, *p4,
                             stream)
                    if err != 0:
                        raise RuntimeError(f"{name} launch failed ({err})")

                run()
                outs[b], runs[b] = out, run
            torch.cuda.synchronize()
            equal = {b: bool(torch.equal(out.view(torch.int32),
                                         outs["earlier"].view(torch.int32)))
                     for b, out in outs.items()}
            bad += [f"{name} {b} {paths} x {steps}"
                    for b, ok in equal.items() if not ok]
            times = {b: [] for b in runs}
            for _ in range(ROUNDS):
                for b in ("earlier", "new", "new", "earlier"):
                    times[b].append(cs._launch_ms(torch, runs[b]))
            bound_ms, bound_by = cs._mc_bound(paths, steps,
                                              name == "asian_paths")
            row = {"paths": paths, "steps": steps,
                   "equal_to_earlier": all(equal.values()),
                   "price": float(outs["new"].sum(dtype=torch.float64))
                   / paths, "bound_ms": bound_ms, "bound_by": bound_by}
            for b, t in times.items():
                blocks = -(-paths // THREADS)
                per_sm = static[b, name]["blocks_per_sm"]
                row[b] = {"ms": t, "median_ms": statistics.median(t),
                          "spread_ms": max(t) - min(t),
                          "share_of_bound": bound_ms / statistics.median(t),
                          "blocks": blocks,
                          "waves": blocks / (per_sm * sms)}
            row["faster_by_more_than_spread"] = (
                max(times["new"]) < min(times["earlier"]))
            if (paths, steps) == SHAPES[0]:
                for b in ("earlier", "new"):
                    row[b]["sm_clock"] = _sm_clock(runs[b])
            rows.append(row)
            print(json.dumps({"kernel": name, **row}), flush=True)
            del outs, runs
        report["kernels"][name] = {
            "static": {b: static[b, name] for b in builds}, "shapes": rows}
        for b in builds:
            print(f"{name} {b}: " + json.dumps(static[b, name]), flush=True)
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(json.dumps(report, indent=1))
    if bad:
        raise SystemExit(f"compare_mc_kernels: differs from the earlier "
                         f"kernel: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
