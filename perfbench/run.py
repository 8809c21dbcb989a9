"""Run one cell of the benchmark on this machine's card and print its result
as the last line of standard output:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, the device's busy and traced seconds and a breakdown.
Exits non-zero, printing no result, without enough CUDA devices.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import os
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from perfbench import harness

    for var in harness.THREAD_VARS:           # before numpy or torch load
        os.environ[var] = str(harness.THREADS)
    from perfbench.harness import exit_now, main

    exit_now(main(t_start=T_START))
