"""Readings that the comparison's limits are set from: a cell run on each
of several seeds in one process, the program's numbers beside the
control's (the reference at the precision below the configuration's, put
in the program's place).  Not part of the benchmark's runs.

    python3 perfbench/calibrate.py --workload overlap.backlog \
        --seeds 11,12,13 --seconds 10 [--set key=value ...]

Prints one JSON line a seed.  ``--set`` overrides a traffic key (a JSON
value), as a sweep does with ``streams``; ``--fault`` plants one of
``faults.FAULTS`` under the timed path, to read what it does to the
numbers.
"""

import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    import os

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from perfbench import harness

    for var in harness.THREAD_VARS:           # before numpy or torch load
        os.environ[var] = str(harness.THREADS)

    import argparse

    import torch

    torch.set_num_threads(harness.THREADS)

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--fault", default=None,
                    help="plant one of faults.FAULTS under the timed path")
    a = ap.parse_args()
    from mmla_audio_torch import _build
    from mmla_audio_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(harness.CACHE)
    _build.cuda_libraries()
    _build.host_library()
    work, config, traffic = harness.cell(harness.manifest(), a.workload)
    for kv in a.set:
        k, v = kv.split("=", 1)
        traffic[k] = json.loads(v)
    if a.fault:
        from perfbench.faults import FAULTS, Patch

        FAULTS[a.fault](Patch())
    for seed in a.seeds.split(","):
        args = argparse.Namespace(workload=a.workload, seed=int(seed),
                                  seconds=a.seconds, trace=a.trace)
        out, _ = harness.run_cell(work, config, traffic, args,
                                  time.perf_counter(),
                                  torch.device("cuda", 0), control=True)
        out["seed"] = int(seed)
        out["fault"] = a.fault
        out.pop("breakdown", None)
        print(json.dumps(out), flush=True)
