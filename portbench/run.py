"""Run one cell of the benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds a CUDA card. Prints the result as
the last line of standard output; exits non-zero, with no result, when
there is no card.
"""

import time

START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # The checkout's root in place of this folder, whose module names
    # (trace, harness) must not shadow the standard library's.
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], start=START))
