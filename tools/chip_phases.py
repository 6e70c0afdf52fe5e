"""Run some of ``chip_smoke.py``'s phase functions alone on one card.

    python3 tools/chip_phases.py _path_mesh_f3 [_path_mesh_f2 ...]

Run it from the repository root: the meshed phases' ranks import
``chip_smoke`` by that name. Each name is a function of ``chip_smoke``
that takes ``(torch, smi)``, the module and the card's
``nvidia-smi --query-gpu=name,power.limit`` line; the phase builds what it
launches at first use, prints its results and raises ``SystemExit`` when
a gate fails. Prints the card's line first and each phase's seconds.
Needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


def main(names) -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("chip_phases: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    for name in names:
        t0 = time.perf_counter()
        getattr(chip_smoke, name)(torch, smi)
        print(f"chip_phases {name} seconds: {time.perf_counter() - t0:.1f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
