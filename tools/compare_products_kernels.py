"""Time the two LMM products kernels against the parent commit's on one card.

    python3 tools/compare_products_kernels.py --parent DIR

``DIR`` holds the earlier ``lmm_atm_products.cu`` and
``lmm_stochvol_products.cu`` (e.g. ``git show
<commit>:finmath_tpu_torch/csrc/<name>`` of each). The script builds them
and the instantiations of the current sources at the four launch shapes
of the calibrations (ATM B=1 and B=87 at 100,000 paths, stoch-vol B=1 and
B=17 at 81,920 Mersenne paths), the ones the wrappers launch. It checks
each new kernel against its plain version (B=1) or the earlier kernel (the
FD batches) within rtol 1e-5, atol 1e-7 * paths, with a bitwise repeat,
and times the launch alone (median of 5, CUDA events, a spin kernel
ahead) in turns: earlier, new, new, earlier. It prints, and writes
to ``chiprun_out/compare_products.json``, the times, the share of the
operations bound of ``chip_smoke.py``, ``ptxas``' registers and spills, and
SASS counts from ``cuobjdump`` / ``nvdisasm``: for the earlier kernels the
instructions of one iteration of the libor loop and of the collection's
period loop, for the new ones the instructions of one unrolled row of the
drift sweep and of the collection (a ``-lineinfo`` build, instructions
attributed to those source lines and to the helpers they inline, over K).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from finmath_tpu_torch.models.lmm import (  # noqa: E402
    ATMKernelCalibration, StochVolKernelCalibration, build_atm_calibration,
    build_benchmark_calibration)
from finmath_tpu_torch.ops import (_cuda_build, lmm_kernel,  # noqa: E402
                                   lmm_stochvol_kernel)
from finmath_tpu_torch.ops._products import (THREADS,  # noqa: E402
                                             product_tables, sweep_defines,
                                             sweep_variant)

OLD_TILE = 128


def _ptxas(log: str):
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return {"registers": max(regs), "spill_bytes": max(spills)}


def _build_old(src: Path, out_dir: Path):
    out = out_dir / f"old_{src.stem}.so"
    proc = subprocess.run(
        [_cuda_build.nvcc_path(), *_cuda_build.NVCC_FLAGS, "-o", str(out),
         str(src)], capture_output=True, text=True, check=True)
    return out, _ptxas(proc.stdout + proc.stderr)


def _sass(lib: Path):
    """The kernel's SASS instructions as (label-or-None, text) lines."""
    tool = Path(_cuda_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    lines = []
    for ln in text.splitlines():
        ln = ln.strip()
        m = re.match(r"^(\.L_x_\d+):", ln)
        if m:
            lines.append((m.group(1), None))
            continue
        m = re.match(r"^/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m:
            # a label for every address too, for branches that name one
            lines.append((hex(int(m.group(1), 16)), None))
            lines.append((None, m.group(2)))
    return lines


def _body_lines(text: str, start: str, end: str):
    """The 1-based source lines after the first line holding ``start`` up
    to the line after the next one holding ``end``."""
    lines = text.splitlines()
    first = next(j for j, ln in enumerate(lines) if start in ln)
    last = next(j for j in range(first, len(lines)) if end in lines[j])
    return set(range(first + 2, last + 3))


def _function_lines(text: str, name: str):
    """The 1-based source lines of the body of the device function
    ``name``."""
    lines = text.splitlines()
    first = next(j for j, ln in enumerate(lines)
                 if f" {name}(" in ln and "__device__" in ln)
    last = next(j for j in range(first, len(lines)) if lines[j] == "}")
    return set(range(first + 1, last + 2))


def _row_instructions(source: str, defines, out_dir: Path):
    """Instructions of one unrolled row of the drift sweep and of the
    collection in the ``defines`` instantiation of ``csrc/<source>``: a
    ``-lineinfo`` cubin's SASS (``nvdisasm -g``), each instruction counted
    under its source line, summed over the row's lines and its inlined
    helpers' and divided by the K rows (and by the copies of the sweep)."""
    src = _cuda_build.CSRC_DIR / source
    tag = "-".join(f"{k}{v}" for k, v in defines)
    cubin = out_dir / f"{src.stem}-{tag}.cubin"
    subprocess.run([_cuda_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-lineinfo", "-cubin",
                    *(f"-D{k}={v}" for k, v in defines), "-o", str(cubin),
                    str(src)], capture_output=True, text=True, check=True)
    tool = Path(_cuda_build.nvcc_path()).parent / "nvdisasm"
    text = subprocess.run([str(tool), "-g", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    counts, where = {}, None
    for ln in text.splitlines():
        m = re.search(r'//## File "([^"]+)", line (\d+)', ln)
        if m:
            where = (Path(m.group(1)).name, int(m.group(2)))
        elif re.match(r"^\s*/\*[0-9a-f]{4,}\*/\s+\S", ln) and where:
            counts[where] = counts.get(where, 0) + 1
    cu = src.read_text()
    cuh = (_cuda_build.CSRC_DIR / "lmm_sweep.cuh").read_text()
    drift = {(src.name, j) for j in _body_lines(
        cu, "for (int r = r0; r < r0 + kRows", "L[r] = clamp_keep_nan(")}
    drift |= {("lmm_sweep.cuh", j) for name in
              ("load_loadings", "clamp_keep_nan")
              for j in _function_lines(cuh, name)}
    collect = {(src.name, j) for j in _body_lines(
        cu, "for (int r = 0; r < K; ++r) {", "ann = ann + cp * d;")}
    K = dict(defines)["LMM_K"]
    # the compiler may emit the sweep more than once (a copy for each value
    # of a uniform flag, such as the ATM kernel's `displaced`): count the
    # copies by the clamp's first instruction, one a row
    clamp = next(j for j in sorted(_function_lines(cuh, "clamp_keep_nan"))
                 if "max.NaN" in cuh.splitlines()[j - 1])
    copies = max(1, round(counts.get(("lmm_sweep.cuh", clamp), 0) / K))
    return {"drift_row": sum(counts.get(key, 0) for key in drift)
            / (K * copies), "drift_copies": copies,
            "collection_row": sum(counts.get(key, 0) for key in collect) / K}


def _loops(lines):
    """(first, last, body) of each backward branch's loop, innermost first."""
    where, count, ins = {}, 0, []
    for label, text in lines:
        if label is not None:
            where[label] = count
        else:
            ins.append(text)
            count += 1
    loops = []
    for j, text in enumerate(ins):
        m = re.search(r"BRA\s+`?\(?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if m and where.get(m.group(1), j + 1) <= j:
            loops.append((where[m.group(1)], j, ins[where[m.group(1)]:j + 1]))
    return sorted(loops, key=lambda t: t[1] - t[0])


def _opcode(text: str) -> str:
    """A SASS instruction's opcode, without its predicate."""
    parts = text.split()
    return parts[1] if parts[0].startswith("@") else parts[0]


def _old_loop_sizes(lib: Path):
    """Instructions per iteration of the earlier kernels' libor loop (one
    shared store of L_i an iteration) and collection period loop (one
    reciprocal a period), from the innermost loops that hold them (the
    compiler may unroll either)."""
    loops = [(b - a + 1, [_opcode(t) for t in body])
             for a, b, body in _loops(_sass(lib))]

    def per_iteration(pred, marker):
        for size, ops in loops:
            if pred(ops):
                return size / max(1, sum(o.startswith(marker) for o in ops))
        return None

    return {
        "libor_loop": per_iteration(
            lambda ops: "MUFU.RCP" in ops
            and any(o.startswith("STS") for o in ops), "STS"),
        "collection_loop": per_iteration(
            lambda ops: "MUFU.RCP" in ops
            and not any(o.startswith(("STS", "SHFL")) for o in ops),
            "MUFU.RCP"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" /
                                         "compare_products.json"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_products_kernels: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    atm = build_atm_calibration(num_paths=cs.PATHS, num_factors=1,
                                seed=cs.SEED, device="cuda")
    akb = ATMKernelCalibration(atm.engine)
    ax = akb.params(atm.covariance.initial_parameters)
    sv = build_benchmark_calibration(num_paths=cs.SV_PATHS, seed=cs.SV_SEED,
                                     brownian="finmath_mersenne",
                                     device="cuda")
    skb = StochVolKernelCalibration(sv.engine)
    sx = skb.params(sv.covariance.initial_parameters)
    shapes = []
    for name, kb, x, mod, paths in (("atm", akb, ax, lmm_kernel, cs.PATHS),
                                    ("stochvol", skb, sx,
                                     lmm_stochvol_kernel, cs.SV_PATHS)):
        for fd in (False, True):
            X = kb.fd_parameter_sets(x)[0] if fd else x[None, :]
            args, kwargs = kb.kernel_arguments(X)
            shapes.append({"name": f"{name} B={X.shape[0]}", "kind": name,
                           "mod": mod, "args": args, "kwargs": kwargs,
                           "B": X.shape[0], "paths": paths})

    # -- builds: the earlier sources and every instantiation, in parallel --
    out_dir = _cuda_build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for sh in shapes:
        sh["variant"] = sweep_variant(sh["kwargs"]["num_libors"],
                                      sh["kwargs"]["num_factors"])
        jobs[(sh["mod"].SOURCE, *sh["variant"])] = None
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        old = dict(zip(("atm", "stochvol"), pool.map(
            lambda src: _build_old(opts.parent / src, out_dir),
            ("lmm_atm_products.cu", "lmm_stochvol_products.cu"))))
        built = list(pool.map(
            lambda key: _cuda_build.build(key[0], sweep_defines(*key[1:])),
            jobs))
        rows_sass = dict(zip(jobs, pool.map(
            lambda key: _row_instructions(key[0], sweep_defines(*key[1:]),
                                          out_dir), jobs)))
    for key, lib in zip(jobs, built):
        jobs[key] = lib

    report = {"card": smi, "shapes": []}
    for sh in shapes:
        mod, args, kwargs, B, paths = (sh["mod"], sh["args"], sh["kwargs"],
                                       sh["B"], sh["paths"])
        n, F = kwargs["num_libors"], kwargs["num_factors"]
        atm_kind = sh["kind"] == "atm"
        z, volT_b, scal_b, l0, deltas = args
        products = tuple((int(e), int(m), float(k))
                         for e, m, k in kwargs["products"])
        S = products[-1][0]
        tables = product_tables(products, z.device)
        out_rows = len(products) + (len(kwargs["events"]) if atm_kind else 0)

        # the earlier kernel, on the same inputs
        old_lib = ctypes.CDLL(str(old[sh["kind"]][0]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        old_partials = torch.empty((B, -(-paths // OLD_TILE), out_rows),
                                   dtype=torch.float64, device="cuda")
        if atm_kind:
            fn = old_lib.lmm_atm_products_launch
            fn.argtypes = [ptr, ctypes.c_longlong] + [ptr] * 9 + [i32] * 8 \
                + [ptr]
            step_event = lmm_kernel._step_events(tuple(kwargs["events"]),
                                                 z.device)
            E = len(kwargs["events"])
            old_args = (z.data_ptr(), paths, volT_b.data_ptr(),
                        scal_b.data_ptr(), l0.data_ptr(), deltas.data_ptr(),
                        step_event.data_ptr(), tables.step_first.data_ptr(),
                        tables.periods.data_ptr(), tables.strikes.data_ptr(),
                        old_partials.data_ptr(), n, F, S, len(products), E,
                        paths, B, int(kwargs["displaced"]), stream)
        else:
            fn = old_lib.lmm_stochvol_products_launch
            fn.argtypes = [ptr, ctypes.c_longlong] + [ptr] * 8 + [i32] * 6 \
                + [ptr]
            old_args = (z.data_ptr(), paths, volT_b.data_ptr(),
                        scal_b.data_ptr(), l0.data_ptr(), deltas.data_ptr(),
                        tables.step_first.data_ptr(),
                        tables.periods.data_ptr(), tables.strikes.data_ptr(),
                        old_partials.data_ptr(), n, F, S, len(products),
                        paths, B, stream)
        fn.restype = i32

        def run_old():
            err = fn(*old_args)
            if err != 0:
                raise RuntimeError(f"earlier kernel failed ({err})")

        run_old()
        torch.cuda.synchronize()
        old_sums = old_partials.sum(dim=1)

        packed = mod._packed(volT_b, scal_b, l0, deltas, F)
        partials = torch.empty((B, -(-paths // THREADS), out_rows),
                               dtype=torch.float64, device="cuda")
        v = sh["variant"]
        if atm_kind:
            def run_new():
                mod.launch(z, packed, tables, step_event, partials, n=n, S=S,
                           num_paths=paths, displaced=kwargs["displaced"],
                           variant=v)
        else:
            def run_new():
                mod.launch(z, packed, tables, partials, n=n, S=S,
                           num_paths=paths, variant=v)
        run_new()
        got = partials.sum(dim=1)
        run_new()
        again = partials.sum(dim=1)
        torch.cuda.synchronize()
        if B == 1:
            ref = (mod.lmm_atm_swaptions_batch_reference if atm_kind
                   else mod.lmm_stochvol_swaptions_batch_reference)(
                *args, **kwargs)
            against = "plain"
        else:
            ref, against = old_sums, "earlier kernel"
        err = (got - ref).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= cs.RTOL * ref.abs() + cs.ATOL_PER_PATH * paths).all())
        log = Path(jobs[(mod.SOURCE, *v)]).with_suffix(".log").read_text()
        new = {"K": v[0], "F": v[1], "R": v[2], "against": against,
               "max_abs_err": float(err.max()),
               "max_rel_err": float((err / ref.abs()).max()),
               "within": ok,
               "bitwise_repeat": bool(torch.equal(got, again)),
               "vs_earlier_max_rel": float(
                   ((got - old_sums).abs() / old_sums.abs()).max()),
               **_ptxas(log), **rows_sass[(mod.SOURCE, *v)]}
        print(f"{sh['name']} (K, F, R) = {v}: {json.dumps(new)}", flush=True)

        runs = {"earlier": run_old, "new": run_new}
        times = {key: [] for key in runs}
        for key in ("earlier", "new", "new", "earlier"):
            times[key].append(cs._launch_ms(torch, runs[key]))
        ops = cs._sweep_operations(n, F, products, paths, B,
                                   stoch_vol=not atm_kind,
                                   displaced=bool(kwargs.get("displaced")))
        bound_ms, bound_by = cs._bound(args, old_sums, ops)
        new["ms"] = times["new"]
        new["share_of_bound"] = bound_ms / statistics.mean(times["new"])
        entry = {"shape": sh["name"], "paths": paths, "B": B,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "earlier": {"ms": times["earlier"],
                             **old[sh["kind"]][1],
                             **_old_loop_sizes(old[sh["kind"]][0])},
                 "new": new}
        entry["earlier"]["share_of_bound"] = bound_ms / statistics.mean(
            times["earlier"])
        report["shapes"].append(entry)
        print(f"{sh['name']}: bound {bound_ms:.4f} ms ({bound_by}); "
              f"earlier {times['earlier']} ms; new {times['new']} ms",
              flush=True)
        del old_partials

    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(json.dumps(report, indent=1))
    bad = [e["shape"] for e in report["shapes"]
           if not (e["new"]["within"] and e["new"]["bitwise_repeat"])]
    if bad:
        raise SystemExit(f"compare_products_kernels: disagrees: {bad}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
