"""Build report of WavLM's conv encoder kernel E1, and A/B timings of two
builds of it, on one CUDA card.

    env PYTHONPATH=. python3 scripts/e1_probe.py build
    env PYTHONPATH=. python3 scripts/e1_probe.py versus --other F.cu [--batch 64]

``build``: compiles ``csrc/wavlm_conv.cu`` with ``-Xptxas -v`` and prints
each entry's registers, stack frame and spills.

``versus --other F``: another build of ``wavlm_conv.cu`` with this tree's
C interface beside this tree's, each layer and the whole encoder alone in
turns (other, tree, tree, other) in one TF32 pass, and the largest
difference of their outputs.  Errors against float64 and each layer's time
beside the library's are ``chip_smoke.phase_conv_encoder``'s.

Every run names the card (``nvidia-smi`` name and power limit).  Without a
CUDA device the script stops before doing anything.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch


def build() -> None:
    from mmla_audio_torch import _build

    src = _build.CUDA_KERNELS["wavlm_conv"][0]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                               "-v", "-o", str(Path(tmp) / "e1.so"),
                               str(src)], capture_output=True, text=True,
                              timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    for line in proc.stderr.splitlines():
        if re.search(r"Compiling entry|registers|spill|stack frame", line):
            print(line.strip(), flush=True)


def versus(device, other: Path, batch: int) -> None:
    import ctypes

    from chip_smoke import e1_encoder, e1_input, e1_layers, queued_ms
    from mmla_audio_torch import _build
    from mmla_audio_torch.ops.cuda_conv_encoder import (pack_conv_weight,
                                                        wavlm_conv)
    from mmla_audio_torch.precision import fp32_policy

    tree = _build.cuda_library("wavlm_conv")
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "other.so"
        proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(so), str(other)], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            raise RuntimeError(proc.stderr)
        lib = ctypes.CDLL(str(so))          # stays mapped once loaded
    for name, argtypes in _build.CUDA_KERNELS["wavlm_conv"][1].items():
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = argtypes
    real = _build.cuda_library
    libs = {"tree": lambda name: tree, "other": lambda name: lib}
    layers = e1_layers(device)
    packed = [pack_conv_weight(w) for w, *_ in layers]
    x = e1_input(batch, device, seed=5)
    hs = [x[..., None]]
    with torch.no_grad(), fp32_policy(True):
        for i, layer in enumerate(layers[:-1]):
            hs.append(wavlm_conv(hs[-1], *layer[:3], layer[3],
                                 packed=packed[i]))
    try:
        for i, layer in enumerate(layers + [None]):
            if layer is None:
                fn, args = e1_encoder, (x, layers, packed)
            else:
                fn = wavlm_conv
                args = (hs[i], *layer[:3], layer[3], 1e-5, None, packed[i])
            ms = {"tree": [], "other": []}
            outs = {}
            with torch.no_grad(), fp32_policy(True):
                for who in ("other", "tree", "tree", "other"):
                    _build.cuda_library = libs[who]
                    outs[who] = fn(*args)
                    ms[who].append(queued_ms(fn, *args, reps=10))
            diff = float((outs["tree"] - outs["other"]).abs().max())
            what = "encoder" if layer is None else f"layer {i}"
            print(f"[versus] B={batch} {what}: tree "
                  f"{min(ms['tree']):.4f} ms, other {min(ms['other']):.4f} "
                  f"ms (each the better of two turns); largest difference "
                  f"{diff:.3g}", flush=True)
    finally:
        _build.cuda_library = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("build", "versus"))
    ap.add_argument("--other", type=Path)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("e1_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if args.what == "build":
        build()
        return 0
    if args.other is None:
        ap.error("versus needs --other")
    versus(torch.device("cuda", 0), args.other, args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
