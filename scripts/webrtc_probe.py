"""Build report, checks and batch sweep of the batched webrtcvad kernel
(W1) and the collector kernel (W2) on one CUDA card.

    env PYTHONPATH=. python3 scripts/webrtc_probe.py build
    env PYTHONPATH=. python3 scripts/webrtc_probe.py sweep [--batches 1 8 ...]

``build``: compiles ``csrc/webrtc_vad.cu`` with ``-Xptxas -v`` and prints
each kernel's registers, stack frame and spills.

``sweep``: W1 (one block of four warps a stream) held against the host
engine at B=8 and 64 (``chip_smoke.check_w1``: adapted rows, padding rows,
4 windows in a row), then CUDA-event times at each batch beside the host
engine's time over the same rows (host clock, one core) and W1's two
bounds (bytes; the decimator's serial chain at the card's clock).

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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (VAD_ROWS, VAD_WARMUP, VAD_WINDOWS,  # noqa: E402
                        ambient, check_w1, denoised_i16, host_ms, log,
                        time_ms, vad_windows, w1_bound, w1_chain_ms)
from mmla_audio_torch import _build  # noqa: E402
from mmla_audio_torch.core.config import PipelineConfig  # noqa: E402
from mmla_audio_torch.vad.webrtc import (  # noqa: E402
    webrtc_init, webrtc_vad_rows, webrtc_vad_rows_plain)


def ptxas_report() -> None:
    src = _build.CUDA_KERNELS["webrtc_vad"][0]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{tmp}/lib.so", str(src)], capture_output=True, text=True,
            timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    for line in proc.stderr.splitlines():
        if re.search(r"Compiling entry|registers|stack frame|spill", line):
            log(f"[ptxas] {line.strip()}")


def adapted_rows(device, cfg):
    """(denoised int16 pool on the card, ``VAD_ROWS`` rows carrying
    ``VAD_WARMUP`` windows of state plus a fresh one)."""
    raw = vad_windows(VAD_ROWS * (VAD_WARMUP + VAD_WINDOWS), seed=12)
    pool = denoised_i16(device, cfg, raw, ambient(11))
    rows = webrtc_init(VAD_ROWS + 1, "cpu")
    warm = pool[: VAD_ROWS * VAD_WARMUP].cpu().reshape(VAD_ROWS, VAD_WARMUP,
                                                       -1)
    for w in range(VAD_WARMUP):
        webrtc_vad_rows_plain(warm[:, w].contiguous(), rows,
                              np.arange(VAD_ROWS))
    return pool[VAD_ROWS * VAD_WARMUP:], rows


def sweep(device, batches) -> None:
    pool, rows = adapted_rows(device, PipelineConfig())
    for batch in (8, 64):
        check_w1(device, pool, rows, batch, np.random.RandomState(batch))
    log("[check] W1 == host engine bit for bit at B=8 and 64")
    chain = w1_chain_ms()
    for batch in batches:
        x = pool[torch.arange(batch, device=device) % len(pool)]
        states = rows[np.arange(batch) % VAD_ROWS].contiguous()
        idx = np.arange(batch, dtype=np.int32)
        card = states.to(device)
        ms = time_ms(lambda: webrtc_vad_rows(x, card, idx),
                     reps=20 if batch <= 8 else 5, rounds=3)
        plain = host_ms(webrtc_vad_rows_plain, x.cpu(), states.clone(), idx)
        log(f"[sweep] B={batch}: W1 {ms:.4f} ms; host engine {plain:.4f} ms; "
            f"bounds {w1_bound(batch, batch)['bound_ms'] * 1e3:.3f} us "
            f"(bytes), {chain:.4f} ms (the decimator's serial chain)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("build", "sweep"))
    ap.add_argument("--batches", type=int, nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("webrtc_probe: no CUDA device", file=sys.stderr)
        return 1
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60).stdout.strip())
    device = torch.device("cuda", 0)
    if args.what == "build":
        ptxas_report()
    else:
        sweep(device, args.batches or [1, 8, 64, 512])
    return 0


if __name__ == "__main__":
    sys.exit(main())
