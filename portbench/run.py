"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up counts from the start of this
script."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one process, one thread for the host's math libraries: the host side of
# the program runs steadier
for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_name] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)        # the program, from the checkout
sys.path.insert(0, HERE)        # the benchmark's own modules

if __name__ == "__main__":
    import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
