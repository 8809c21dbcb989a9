"""Build report, checks, group sweep and ablation of the overlap featurizer
kernel on one CUDA card.

    env PYTHONPATH=. python3 scripts/feature_probe.py build
    env PYTHONPATH=. python3 scripts/feature_probe.py sweep [--batches 1 64 ...]
    env PYTHONPATH=. python3 scripts/feature_probe.py ablate [--batches 1 480]

``build``: compiles ``csrc/overlap_features.cu`` with ``-Xptxas -v`` and
prints each kernel's registers, shared memory and spills; then holds every
G of ``GROUPS`` against the plain version (``chip_smoke.check_budget``) and
against G=1 bit for bit: speech windows at B=1, 6 and 480 and
``time_dim=151``.

``sweep``: CUDA-event times of every G at each batch, in turns (plain, each
G, each G back, plain).

``ablate``: the wrapper's launch (G=1) timed against variants of the source
with one stage removed (textual edits in ``ABLATIONS``, each built into its
own library), in turns; the differences split the time into framing, ZCR,
FFT, split, mel and epilogue.  An edit whose text is no longer in the
source stops the run by name.  ``--baseline FILE`` adds an earlier version
of the source (with the same launch function) to the turns.

Every run names the card (``nvidia-smi`` name and power limit).  Without a
CUDA device the script stops before doing anything.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (check_budget, feature_windows, log,  # noqa: E402
                        time_ms)
from mmla_audio_torch import _build  # noqa: E402
from mmla_audio_torch.core.config import OverlapFeatureConfig  # noqa: E402
from mmla_audio_torch.ops.cuda_features import (  # noqa: E402
    GROUPS, launch_overlap_features, overlap_model_input_cuda)
from mmla_audio_torch.ops.features import overlap_model_input  # noqa: E402


def check_groups(name, y, cfg) -> None:
    """Every G within the budget of the plain version and bit-equal to G=1;
    raises otherwise."""
    ref = overlap_model_input(y, cfg)
    first = overlap_model_input_cuda(y, cfg, group=1)
    err, share = check_budget(name, first, ref)
    for g in GROUPS[1:]:
        if not torch.equal(overlap_model_input_cuda(y, cfg, group=g), first):
            raise AssertionError(f"{name}: G={g} differs from G=1")
    log(f"[check] {name}: every G bit-equal to G=1; max |diff| {err} on "
        f"{share:.4%} of pixels")


def ptxas_report():
    src = _build.CUDA_KERNELS["overlap_features"][0]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{tmp}/lib.so", str(src)], capture_output=True, text=True,
            timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    kernel = None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = subprocess.run(["c++filt", m.group(1)],
                                    capture_output=True, text=True
                                    ).stdout.strip()
        elif kernel and ("registers" in line or "spill" in line):
            log(f"  {kernel}: {line.split(':', 1)[-1].strip()}")


def cmd_build(device) -> None:
    log("[build] nvcc -Xptxas -v")
    ptxas_report()
    cfg = OverlapFeatureConfig()
    for batch in (1, 6, 480):
        check_groups(f"speech B={batch}",
                     feature_windows(batch, cfg.n_samples, device), cfg)
    cfg151 = OverlapFeatureConfig(time_dim=151)
    check_groups("time_dim=151 B=4",
                 feature_windows(4, cfg151.n_samples, device), cfg151)


def cmd_sweep(device, batches) -> None:
    cfg = OverlapFeatureConfig()
    for batch in batches:
        y = feature_windows(batch, cfg.n_samples, device)
        check_groups(f"B={batch}", y, cfg)
        reps = 20 if batch <= 64 else 5
        plain = [time_ms(overlap_model_input, y, cfg, reps=reps)]
        times = {g: [] for g in GROUPS}
        for g in GROUPS + GROUPS[::-1]:
            times[g].append(time_ms(overlap_model_input_cuda, y, cfg, g,
                                    reps=reps))
        plain.append(time_ms(overlap_model_input, y, cfg, reps=reps))
        best = min(times, key=lambda g: min(times[g]))
        log(f"[sweep] B={batch}: plain {plain[0]:.4f}/{plain[1]:.4f} ms; "
            f"best G={best}; " + ", ".join(
                f"G={g} {t[0]:.4f}/{t[1]:.4f}" for g, t in times.items())
            + " ms")


# name -> textual edits of csrc/overlap_features.cu, each removing one stage
ABLATIONS = {
    "no_zcr": [("        cnt += __popc((e ^ o) & valid) + __popc(d & valid);\n", "")],
    "no_fft": [("    for (int s = 0, p = 1; s < nrad; ++s) {",
                "    for (int s = nrad, p = 1; s < nrad; ++s) {")],
    "no_split": [("    for (int k = lane; k <= n2; k += 32) {\n      const float2 a",
                  "    for (int k = n2 + 1; k <= n2; k += 32) {\n      const float2 a")],
    "no_mel": [("      for (int j = 0; j < nb; ++j) {",
                "      for (int j = 0; j < 0 * nb; ++j) {")],
    "no_epilogue": [("    for (int i = tid; i < MT; i += blockDim.x) {\n      const float d",
                     "    for (int i = MT + tid; i < MT; i += blockDim.x) {\n      const float d")],
}


def ablation_launches(tmp, baseline=None):
    """``{name: launch function}`` for the unchanged source, the
    ``baseline`` source file if given, and each ablation, built in
    parallel."""
    src = _build.CUDA_KERNELS["overlap_features"][0].read_text()
    texts = {"base": src}
    if baseline:
        texts["baseline"] = baseline.read_text()
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablation {name}: its text is no longer "
                                   f"in the source; update ABLATIONS")
            text = text.replace(old, new)
        texts[name] = text

    def build(name):
        Path(tmp, f"{name}.cu").write_text(texts[name])
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                        f"{tmp}/lib{name}.so", f"{tmp}/{name}.cu"],
                       check=True, capture_output=True, timeout=600)

    with ThreadPoolExecutor(len(texts)) as pool:
        list(pool.map(build, texts))
    launches = {}
    for name in texts:
        fn = ctypes.CDLL(f"{tmp}/lib{name}.so").overlap_features_launch
        fn.restype = ctypes.c_int
        fn.argtypes = _build.CUDA_KERNELS["overlap_features"][1][
            "overlap_features_launch"]
        launches[name] = fn
    return launches


def cmd_ablate(device, batches, baseline) -> None:
    cfg = OverlapFeatureConfig()
    with tempfile.TemporaryDirectory() as tmp:
        launches = ablation_launches(tmp, baseline)
    for batch in batches:
        y = feature_windows(batch, cfg.n_samples, device)
        base = launch_overlap_features(y, cfg, 1, launches["base"])
        if not torch.equal(base, overlap_model_input_cuda(y, cfg)
                           .permute(0, 3, 1, 2)):
            raise AssertionError(f"B={batch}: the probe's build differs "
                                 f"from the wrapper's")
        if baseline:
            old = launch_overlap_features(y, cfg, 1, launches["baseline"])
            err, share = check_budget(f"baseline B={batch}", old, base)
            log(f"  baseline vs base B={batch}: bit-identical "
                f"{torch.equal(old, base)}; max |diff| {err} on "
                f"{share:.4%} of pixels")
        reps = 20 if batch <= 64 else 5
        times = {n: [] for n in launches}
        for n in list(launches) + list(launches)[::-1]:
            times[n].append(time_ms(launch_overlap_features, y, cfg, 1,
                                    launches[n], reps=reps))
        log(f"[ablate] B={batch} G=1: " + ", ".join(
            f"{n} {v[0]:.4f}/{v[1]:.4f}" for n, v in times.items()) + " ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("feature_probe: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=("build", "sweep", "ablate"))
    parser.add_argument("--batches", type=int, nargs="+",
                        default=[1, 64, 132, 200, 396, 480, 1024, 2400])
    parser.add_argument("--baseline", type=Path,
                        help="ablate: time this earlier version of the "
                             "source too")
    args = parser.parse_args()
    device = torch.device("cuda", 0)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    _build.cuda_library("overlap_features")
    if args.mode == "build":
        cmd_build(device)
    elif args.mode == "sweep":
        cmd_sweep(device, args.batches)
    else:
        cmd_ablate(device, args.batches, args.baseline)
    log("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
