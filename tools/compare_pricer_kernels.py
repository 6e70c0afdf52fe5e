"""Time the four single-swaption pricer launchers against an earlier commit's
kernels on one card.

    python3 tools/compare_pricer_kernels.py --parent DIR

``DIR`` holds the earlier ``lmm_swaption_paths.cu`` and the headers it
includes (e.g. ``git show <commit>:finmath_tpu_torch/csrc/<name>`` of
``lmm_swaption_paths.cu`` and ``philox.cuh``); that source has the
launchers of its first design (the tables as separate tensors, the scalars
as arguments). The script builds it and, of the current source, the
instantiation (K, F) that ``pricer_variant`` picks for each configuration
of ``bench_lmm_pricer_kernels`` (``chip_smoke._pricer_setups``; the
libors that reach the payoff, ``swept_libors``, a launch argument), and
for comparison the instantiations at K = the swept libors (a library a
swaption shape) and at K = the model's libors (a library a model). It
runs the model's build also on every libor of the curve (swept = K: a
swap that ends on the curve's last libor), and the earlier kernel on the
whole curve and on the swept libors alone. At 409,600 paths it checks
every run's payoffs against the earlier kernel's on the whole curve, path
for path (``torch.equal``: the main path's prices the same to the bit), on
the main path's seed and on phase 16's normals, and times the launch alone
(median of 5, CUDA events, a spin kernel ahead) in turns: earlier, picked,
the others, the others again in reverse, picked, earlier. It prints, and
writes to ``chiprun_out/compare_pricers.json``, the times, the share of
``chip_smoke.py``'s bound, ``ptxas``' registers and spills per kernel, the
blocks an SM that those allow (registers, shared memory, threads) and the
waves at 409,600 paths on the card's SMs, and SASS sizes from
``cuobjdump``: instructions per iteration of a rolled libor loop (the
earlier kernels, the new 1-factor ones) and the new kernels' instructions
over K (the stoch-vol sweep and payoff unrolled over K, the set-up spread
over the rows). Needs a CUDA device.
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

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from finmath_tpu_torch.ops import _cuda_build  # noqa: E402
from finmath_tpu_torch.ops import _swaption_paths as sp  # noqa: E402

OLD_TILE = 128                # the earlier kernels' block, one path a thread
THREADS = 128                 # the current kernels' block (kThreads)
MAIN_SEED = 7                 # the PRNG seed of chip_smoke's phase 16

#: the model's build on every libor of the curve (no cut at the swap's end)
EVERY_LIBOR = "every libor"


def _ptxas_by_kernel(log: str):
    """{mangled entry: {"registers", "stack_bytes", "spill_bytes"}} from
    nvcc's -Xptxas -v report."""
    out, entry, props = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "stack_bytes": 0,
                          "spill_bytes": 0}
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and entry and props == entry:
            out[entry]["stack_bytes"] = int(m.group(1))
            out[entry]["spill_bytes"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def _entry(entries, stochvol: bool, injected: bool):
    """The one mangled kernel of ``entries`` for the kind and variant."""
    tag = "ILb1E" if injected else "ILb0E"
    names = [e for e in entries if tag in e
             and ("stochvol" in e) == stochvol]
    if len(names) != 1:
        raise RuntimeError(f"no single kernel entry for stochvol={stochvol} "
                           f"injected={injected} in {sorted(entries)}")
    return names[0]


def _blocks_per_sm(registers: int, threads: int, smem: int) -> int:
    """Resident blocks an SM on Hopper: 64K registers allocated 256 a warp,
    64 warps, 32 blocks, 227 KB of shared memory (1 KB reserved a
    block)."""
    warps = threads // 32
    per_warp = -(-registers * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 64 // warps, 32)


def _sass_functions(lib: Path):
    """{function: [SASS instruction text]} of a built library."""
    tool = Path(_cuda_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    return funcs


def _loop_per_iteration(ins):
    """Instructions per iteration of a rolled libor loop: the
    innermost backward branch's body holding a reciprocal and a shared
    store (one store of L_i an iteration, the loop maybe unrolled)."""
    where = {addr: j for j, (addr, _) in enumerate(ins)}
    loops = []
    for j, (_, text) in enumerate(ins):
        m = re.search(r"BRA\s.*?(0x[0-9a-f]+)", text)
        if m and where.get(int(m.group(1), 16), j + 1) <= j:
            first = where[int(m.group(1), 16)]
            loops.append([t for _, t in ins[first:j + 1]])
    for body in sorted(loops, key=len):
        ops = [t.split()[1] if t.split()[0].startswith("@") else t.split()[0]
               for t in body]
        if "MUFU.RCP" in ops and any(o.startswith("STS") for o in ops):
            return len(body) / sum(o.startswith("STS") for o in ops)
    return None


def _build_parent(src: Path, out_dir: Path):
    out = out_dir / f"old_{src.stem}.so"
    proc = subprocess.run(
        [_cuda_build.nvcc_path(), *_cuda_build.NVCC_FLAGS, "-o", str(out),
         str(src)], capture_output=True, text=True, check=True)
    return out, proc.stdout + proc.stderr


def _parent_library(path: Path):
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_ulonglong)
    tail = {"lmm_swaption_paths": [ptr] * 3 + [f32] * 3 + [i32] * 4 + [ptr],
            "lmm_stochvol_swaption_paths":
                [ptr] * 3 + [f32] * 7 + [i32] * 5 + [ptr]}
    for name, args in tail.items():
        getattr(lib, f"{name}_launch").argtypes = [ptr, i32, u64] + args
        getattr(lib, f"{name}_normals_launch").argtypes = [ptr, ptr, i32] + args
        getattr(lib, f"{name}_launch").restype = i32
        getattr(lib, f"{name}_normals_launch").restype = i32
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" /
                                         "compare_pricers.json"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_pricer_kernels: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{smi}; {sms} SMs", flush=True)
    cfg = cs._pricer_setups(torch)
    P, E, M = cs.PRICER_PATHS, cs.PRICER_E, cs.PRICER_M

    # -- builds: the earlier source and every instantiation, in parallel ----
    out_dir = _cuda_build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    swept = sp.swept_libors(E, E, M)
    runs_of = {}                 # kind -> {label: (K, swept)}
    for kind, c in cfg.kinds.items():
        K = cfg.kinds[kind]["packed"](*c["pack"](E), exercise=E,
                                      periods=M).variant[0]
        runs_of[kind] = {"picked": (K, swept)}
        for label, k in (("K = swept", swept), ("K = n", c["n"])):
            if k != K:
                runs_of[kind][label] = (k, swept)
        runs_of[kind][EVERY_LIBOR] = (c["n"], c["n"])
    builds = {(kind, label): (K, cfg.kinds[kind]["F"])
              for kind, r in runs_of.items() for label, (K, _) in r.items()}
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        parent = pool.submit(_build_parent,
                             opts.parent / "lmm_swaption_paths.cu", out_dir)
        variants = sorted(set(builds.values()))
        built = dict(zip(variants, pool.map(
            lambda v: _cuda_build.build(sp.SOURCE, sp.pricer_defines(*v),
                                        sp.FLAGS), variants)))
        libs = {key: built[v] for key, v in builds.items()}
        parent_lib, parent_log = parent.result()
    old = _parent_library(parent_lib)
    old_regs = _ptxas_by_kernel(parent_log)
    old_sass = _sass_functions(parent_lib)

    report = {"card": smi, "sms": sms, "paths": P, "kernels": []}
    bad = []
    rng = np.random.default_rng(123)                  # phase 16's normals
    normals = {"one_factor": rng.standard_normal((E, P)).astype(np.float32),
               "stochvol": rng.standard_normal(
                   (E * (cfg.F + 1), P)).astype(np.float32)}
    for kind, c in cfg.kinds.items():
        stochvol = kind == "stochvol"
        volT, l0, dl, scal = c["pack"](E)
        picked = c["packed"](volT, l0, dl, scal, exercise=E, periods=M)
        n = c["n"]
        tail = picked.ints[-3:]                           # (S, e, m)
        blend = picked.scalars[3] if stochvol else None

        def launch_at(K, swept_run):
            """The picked launch on a curve of K libors, swept_run swept."""
            return picked._replace(
                table=sp.pack_table(volT, l0, dl, num_factors=c["F"],
                                    libors=K, blend=blend),
                variant=(K, c["F"]),
                ints=(K, *picked.ints[1:-4], swept_run, *tail))

        args_of = {label: launch_at(*r) for label, r in runs_of[kind].items()}
        assert args_of["picked"].ints == picked.ints
        assert torch.equal(args_of["picked"].table, picked.table)
        # the earlier kernel on the whole curve and on the swept libors
        cut = (volT.view(c["F"], n, E)[:, :swept].reshape(-1, E)
               .contiguous(), l0[:swept].contiguous(),
               dl[:swept].contiguous())
        old_inputs = {"earlier": (volT, l0, dl),
                      "earlier, swept libors": cut}
        floats = [float(v) for v in scal[:7 if stochvol else 3].tolist()]
        rows = E * c["rows"]
        z = torch.from_numpy(normals[kind]).cuda()
        base = c["launchers"][0]
        for injected in (False, True):
            name = c["launchers"][int(injected)]
            head_old = (z.data_ptr(), P) if injected else (P, MAIN_SEED)
            fn_old = getattr(old, f"{name}_launch")
            stream = torch.cuda.current_stream().cuda_stream
            runs, rows_out, old_out = {}, {}, {}
            for label, (vt, l0_, dl_) in old_inputs.items():
                n_old = vt.shape[0] // c["F"]
                out_o = torch.empty(P, dtype=torch.float32, device="cuda")
                ints_o = ((n_old, c["F"]) if stochvol else (n_old,)) + tail

                def run_old(fn=fn_old, head=head_old, out=out_o, vt=vt,
                            l0_=l0_, dl_=dl_, ints_o=ints_o):
                    err = fn(out.data_ptr(), *head, vt.data_ptr(),
                             l0_.data_ptr(), dl_.data_ptr(), *floats,
                             *ints_o, stream)
                    if err != 0:
                        raise RuntimeError(f"earlier {name} failed ({err})")

                run_old()
                runs[label], old_out[label] = run_old, out_o
            torch.cuda.synchronize()
            out_old = old_out["earlier"]
            swept_equal = bool(torch.equal(old_out["earlier, swept libors"],
                                           out_old))
            if not swept_equal:
                bad.append(f"{name} earlier, swept libors")
            for (k, label), v in builds.items():
                if k != kind:
                    continue
                out = torch.empty(P, dtype=torch.float32, device="cuda")
                args = args_of[label]
                assert args.variant == v

                def run_new(out=out, args=args):
                    if injected:
                        sp.launch_injected(base, out, z, args)
                    else:
                        sp.launch_prng(base, out, MAIN_SEED, args)

                run_new()
                torch.cuda.synchronize()
                equal = bool(torch.equal(out, out_old))
                if not equal:
                    bad.append(f"{name} {label}")
                log = Path(libs[(kind, label)]).with_suffix(".log").read_text()
                regs = _ptxas_by_kernel(log)[_entry(
                    _ptxas_by_kernel(log), stochvol, injected)]
                funcs = _sass_functions(libs[(kind, label)])
                sass = funcs[_entry(funcs, stochvol, injected)]
                swept_run = args.ints[-4]
                # the 1-factor kernels keep the swept curve in shared memory
                smem = 16 + 4 * args.table.shape[0] + (
                    0 if stochvol else 4 * THREADS * swept_run)
                blocks = _blocks_per_sm(regs["registers"], THREADS, smem)
                rows_out[label] = {
                    "K": v[0], "swept": swept_run, **regs,
                    "equal_to_earlier": equal,
                    "price": float(out.sum(dtype=torch.float64)) / P,
                    "blocks_per_sm": blocks,
                    "waves": P / (THREADS * blocks * sms),
                    "libor_loop_per_iteration": _loop_per_iteration(sass),
                    "sass_over_K": len(sass) / v[0]}
                runs[label] = run_new
            labels = [lb for lb in runs if lb not in ("earlier", "picked")]
            order = (["earlier", "picked"] + labels + labels[::-1]
                     + ["picked", "earlier"])
            # the earlier kernel's time on the swept libors sits with the
            # candidates; "earlier" is the parent as the main path ran it
            times = {lb: [] for lb in runs}
            for lb in order:
                times[lb].append(cs._launch_ms(torch, runs[lb]))
            work = cs._pricer_operations(c["F"], E, E, M, P,
                                         stoch_vol=stochvol)
            if not injected:
                work += -(-rows // 4) * cs.DRAW_OPERATIONS * P
            bound_ms, bound_by = cs._bound(
                [volT, l0, dl] + ([z] if injected else []), out_old, work)
            old_entry = _entry(old_regs, stochvol, injected)
            earlier = {**old_regs[old_entry],
                       "blocks_per_sm": _blocks_per_sm(
                           old_regs[old_entry]["registers"], OLD_TILE,
                           4 * OLD_TILE * c["n"]),
                       "libor_loop_per_iteration": _loop_per_iteration(
                           old_sass[_entry(old_sass, stochvol, injected)]),
                       "price": float(out_old.sum(dtype=torch.float64)) / P,
                       "swept_libors_equal": swept_equal}
            earlier["waves"] = P / (OLD_TILE * earlier["blocks_per_sm"]
                                    * sms)
            rows_out["earlier, swept libors"] = {}
            for lb, t in times.items():
                (earlier if lb == "earlier" else rows_out[lb]).update(
                    ms=t, share_of_bound=bound_ms / statistics.mean(t))
            entry = {"launcher": name, "bound_ms": bound_ms,
                     "bound_by": bound_by, "earlier": earlier,
                     "new": rows_out}
            report["kernels"].append(entry)
            print(json.dumps(entry), flush=True)
            print(f"{name}: bound {bound_ms:.4f} ms; earlier "
                  f"{times['earlier']} ms; picked {times['picked']} ms",
                  flush=True)
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(json.dumps(report, indent=1))
    if bad:
        raise SystemExit(f"compare_pricer_kernels: differs from the earlier "
                         f"kernel: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
