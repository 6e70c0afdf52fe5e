"""Time the two LMM products kernels against the parent commit's on one card.

    python3 tools/compare_products_kernels.py --parent DIR

``DIR`` holds the earlier ``lmm_atm_products.cu``,
``lmm_stochvol_products.cu`` and ``lmm_sweep.cuh`` (e.g. ``git show
<commit>:finmath_tpu_torch/csrc/<name>`` of each), sources with the
current launchers' interface. The script builds them as the earlier
commit built them (its flags: no ``-fmad=false``) and the current sources
as the wrappers build them, each at the instantiations of the four launch
shapes of the calibrations (ATM B=1 and B=87 at 100,000 paths, stoch-vol
B=1 and B=17 at 81,920 Mersenne paths). It checks each new kernel's
partials against the plain partials bit for bit (``torch.equal``, twice),
reports how far the earlier kernel's path sums lie from the new ones', and
times the launch alone (median of 5, CUDA events, a spin kernel ahead) in
turns: earlier, new, new, earlier. It prints, and writes to
``chiprun_out/compare_products.json``, the times, the share of the
operations bound of ``chip_smoke.py``, ``ptxas``' registers and spills,
and SASS counts of both builds from ``nvdisasm``: the instructions of one
unrolled row of the drift sweep and of the collection (a ``-lineinfo``
build, instructions attributed to those source lines and to the helpers
they inline, over K). Needs a CUDA device.
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
from finmath_tpu_torch.ops._products import (  # noqa: E402
    sweep_defines, sweep_variant)


def _ptxas(log: str):
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    return {"registers": max(regs), "spill_bytes": max(spills)}


def _build_parent(src_dir: Path, source: str, defines, out_dir: Path):
    """The earlier ``source`` of ``src_dir`` at ``defines``, built with the
    earlier flags (``NVCC_FLAGS`` alone); returns ``(library, ptxas)``."""
    name = "-".join(f"{k}{v}" for k, v in defines)
    out = out_dir / f"old_{Path(source).stem}-{name}.so"
    proc = subprocess.run(
        [_cuda_build.nvcc_path(), *_cuda_build.NVCC_FLAGS,
         *(f"-D{k}={v}" for k, v in defines), "-o", str(out),
         str(src_dir / source)], capture_output=True, text=True, check=True)
    return out, _ptxas(proc.stdout + proc.stderr)


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


def _row_instructions(csrc: Path, source: str, defines, flags,
                      out_dir: Path, tag: str):
    """Instructions of one unrolled row of the drift sweep and of the
    collection in the ``defines`` instantiation of ``csrc/source`` built
    with ``flags``: a ``-lineinfo`` cubin's SASS (``nvdisasm -g``), each
    instruction counted under its source line, summed over the row's lines
    and its inlined helpers' and divided by the K rows (and by the copies
    of the sweep)."""
    src = csrc / source
    name = "-".join(f"{k}{v}" for k, v in defines)
    cubin = out_dir / f"{tag}-{src.stem}-{name}.cubin"
    subprocess.run([_cuda_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    *flags, "-lineinfo", "-cubin",
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
    cuh = (csrc / "lmm_sweep.cuh").read_text()
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
    for name, kb, x, mod, plain, paths in (
            ("atm", akb, ax, lmm_kernel,
             lmm_kernel.lmm_atm_swaptions_partials_reference, cs.PATHS),
            ("stochvol", skb, sx, lmm_stochvol_kernel,
             lmm_stochvol_kernel.lmm_stochvol_swaptions_partials_reference,
             cs.SV_PATHS)):
        for fd in (False, True):
            X = kb.fd_parameter_sets(x)[0] if fd else x[None, :]
            args, kwargs = kb.kernel_arguments(X)
            shapes.append({"name": f"{name} B={X.shape[0]}", "kind": name,
                           "mod": mod, "plain": plain, "args": args,
                           "kwargs": kwargs, "B": X.shape[0], "paths": paths,
                           "variant": sweep_variant(kwargs["num_libors"],
                                                    kwargs["num_factors"])})

    # -- builds: the earlier and current sources at every instantiation ----
    out_dir = _cuda_build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    keys = sorted({(sh["mod"].SOURCE, sh["variant"]) for sh in shapes})
    flags = {sh["mod"].SOURCE: sh["mod"].FLAGS for sh in shapes}
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        old = dict(zip(keys, pool.map(
            lambda k: _build_parent(opts.parent, k[0], sweep_defines(*k[1]),
                                    out_dir), keys)))
        new = dict(zip(keys, pool.map(
            lambda k: _cuda_build.build(k[0], sweep_defines(*k[1]),
                                        flags[k[0]]), keys)))
        sass = {}
        for tag, csrc, fl in (("earlier", opts.parent, ()),
                              ("new", _cuda_build.CSRC_DIR, None)):
            sass[tag] = dict(zip(keys, pool.map(
                lambda k, csrc=csrc, fl=fl, tag=tag: _row_instructions(
                    csrc, k[0], sweep_defines(*k[1]),
                    flags[k[0]] if fl is None else fl, out_dir, tag),
                keys)))

    report = {"card": smi, "shapes": []}
    bad = []
    for sh in shapes:
        mod, args, kwargs, B, paths = (sh["mod"], sh["args"], sh["kwargs"],
                                       sh["B"], sh["paths"])
        key = (mod.SOURCE, sh["variant"])
        new_lib = mod._library(*sh["variant"])
        old_lib = ctypes.CDLL(str(old[key][0]))
        for fn in ("_launch", "_error_string", "_variant"):
            f_new = getattr(new_lib, f"{Path(mod.SOURCE).stem}{fn}")
            f_old = getattr(old_lib, f"{Path(mod.SOURCE).stem}{fn}")
            f_old.argtypes, f_old.restype = f_new.argtypes, f_new.restype
        go_new, partials = mod.prepare(*args, **kwargs)
        go_old_inner, old_partials = mod.prepare(*args, **kwargs)

        def go_old(inner=go_old_inner, lib=old_lib, mod=mod):
            # the same launch through the earlier library
            new_library, mod._library = mod._library, lambda *v: lib
            try:
                inner()
            finally:
                mod._library = new_library

        ref = sh["plain"](*args, **kwargs)
        equal = []
        for _ in range(2):
            go_new()
            torch.cuda.synchronize()
            equal.append(bool(torch.equal(partials, ref)))
        go_old()
        torch.cuda.synchronize()
        new_sums, old_sums = partials.sum(dim=1), old_partials.sum(dim=1)
        row = {"K": sh["variant"][0], "F": sh["variant"][1],
               "R": sh["variant"][2],
               "partials_equal_plain": all(equal),
               "max_abs_err_vs_plain": float((partials - ref).abs().max()),
               "earlier_vs_new_max_rel": float(
                   ((old_sums - new_sums).abs() / new_sums.abs()).max()),
               **_ptxas(Path(new[key]).with_suffix(".log").read_text()),
               **sass["new"][key]}
        if not all(equal):
            bad.append(sh["name"])
        print(f"{sh['name']} (K, F, R) = {sh['variant']}: {json.dumps(row)}",
              flush=True)
        runs = {"earlier": go_old, "new": go_new}
        times = {k: [] for k in runs}
        for k in ("earlier", "new", "new", "earlier"):
            times[k].append(cs._launch_ms(torch, runs[k]))
        ops = cs._sweep_operations(
            kwargs["num_libors"], kwargs["num_factors"], kwargs["products"],
            paths, B, stoch_vol=sh["kind"] == "stochvol",
            displaced=bool(kwargs.get("displaced")))
        bound_ms, bound_by = cs._bound(args, new_sums, ops)
        row["ms"] = times["new"]
        row["share_of_bound"] = bound_ms / statistics.mean(times["new"])
        earlier = {"ms": times["earlier"], **old[key][1],
                   **sass["earlier"][key],
                   "share_of_bound": bound_ms / statistics.mean(
                       times["earlier"])}
        report["shapes"].append({"shape": sh["name"], "paths": paths, "B": B,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "earlier": earlier, "new": row})
        print(f"{sh['name']}: bound {bound_ms:.4f} ms ({bound_by}); "
              f"earlier {times['earlier']} ms; new {times['new']} ms",
              flush=True)

    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(json.dumps(report, indent=1))
    if bad:
        raise SystemExit(f"compare_products_kernels: partials differ from "
                         f"the plain partials: {bad}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
