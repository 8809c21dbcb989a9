"""Build report, plan sweep and ablation of the denoise's mask smoothing
(D2) and the VAD collector (W2) on one CUDA card.

    env PYTHONPATH=. python3 scripts/smooth_probe.py build
    env PYTHONPATH=. python3 scripts/smooth_probe.py sweep
    env PYTHONPATH=. python3 scripts/smooth_probe.py ablate --baseline F.cu
    env PYTHONPATH=. python3 scripts/smooth_probe.py ablate --stages 8

``build``: compiles ``csrc/denoise.cu`` and ``csrc/webrtc_vad.cu`` with
``-Xptxas -v`` and prints D2's and W2's registers, stack frames and spills.

``sweep``: D2 at the live window (T = 183) of B = 1, 8, 64 and 512 and on
the 12-minute file (T = 45,023) under every strip of 4 to 64 frames, at
the full-row tile and at one-warp tiles of 192 bins, each grid's output
bit for bit equal to the wrapper's (``smooth_plan``'s pick, marked ``*``),
timed on the card alone (``queued_ms``) beside the byte bound; then W2 at
B = 1, 8, 64 and 512 (T = 85), ``time_ms`` and ``queued_ms``; the launch
floor (an empty kernel queued the same way).

``ablate``: another build of D2 beside this tree's, in turns (other, tree,
tree, other) at the same five shapes: its output bit for bit against the
tree's, ``time_ms``, ``queued_ms``, and in a profiler trace of 40
back-to-back calls the median kernel duration and the median gap between
kernels.  ``--baseline F`` is an earlier ``denoise.cu`` (its launcher
either this tree's or the earlier one of a 16-frame tile, ``..., int nt,
int tile_t, cudaStream_t``); ``--stages N`` rebuilds this tree's source
with a staging ring of N rows.

Every run names the card (``nvidia-smi`` name and power limit).  Without a
CUDA device the script stops before doing anything.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import d2_bound, log, queued_ms, time_ms  # noqa: E402
from mmla_audio_torch import _build  # noqa: E402
from mmla_audio_torch.core.config import DenoiseConfig  # noqa: E402
from mmla_audio_torch.ops import denoise as dn  # noqa: E402
from mmla_audio_torch.ops.cuda_denoise import (  # noqa: E402
    SMOOTH_BINS_PER_THREAD, smooth_plan)
from mmla_audio_torch.vad.collector import (  # noqa: E402
    vad_collect_rows, vad_collect_rows_plain)

SHAPES = ((1, 183), (8, 183), (64, 183), (512, 183), (1, 45023))
STRIPS = (4, 8, 16, 32, 64)
BINS = 513
P, I = ctypes.c_void_p, ctypes.c_int


def nvcc(src: Path, out: Path, verbose: bool = False) -> str:
    flags = ("-Xptxas", "-v") if verbose else ()
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return proc.stderr


def ptxas_report() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("denoise", "webrtc_vad"):
            report = nvcc(_build.CUDA_KERNELS[name][0],
                          Path(tmp) / f"{name}.so", verbose=True)
            keep = False
            for line in report.splitlines():
                if "Compiling entry" in line:
                    keep = bool(re.search(r"smooth|collect", line))
                if keep and re.search(r"Compiling entry|registers|stack "
                                      r"frame|spill", line):
                    log(f"[ptxas] {line.strip()}")


def masks(device) -> dict:
    return {(g, t): torch.from_numpy(np.random.RandomState(g + t).rand(
        g, t, BINS).astype(np.float32)).to(device) for g, t in SHAPES}


def tree_launch(mask, out, strip, tile) -> None:
    """This tree's D2 launcher at an explicit grid."""
    G, T, K = mask.shape
    v_f, v_t = dn._smoothing_taps(DenoiseConfig(), 16000, mask.device)
    err = _build.cuda_library("denoise").smooth_mask_launch(
        mask.data_ptr(), out.data_ptr(), G, T, K, v_f.data_ptr(), len(v_f),
        v_t.data_ptr(), len(v_t), strip, tile,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"smooth_mask_launch: cudaError {err}")


def sweep(device) -> None:
    cfg = DenoiseConfig()
    for (G, T), mask in masks(device).items():
        ref = dn.smooth_mask(mask, cfg, 16000)
        pick = smooth_plan(G, T, BINS)
        full = -(-BINS // SMOOTH_BINS_PER_THREAD) * SMOOTH_BINS_PER_THREAD
        parts = []
        for tile in (full, 32 * SMOOTH_BINS_PER_THREAD):
            for strip in STRIPS:
                out = torch.empty_like(mask)
                tree_launch(mask, out, strip, tile)
                torch.cuda.synchronize()
                if not torch.equal(out.view(torch.int32),
                                   ref.view(torch.int32)):
                    raise AssertionError(f"D2 G={G} T={T} strip {strip} "
                                         f"tile {tile}: bits differ")
                ms = queued_ms(tree_launch, mask, out, strip, tile)
                mark = "*" if (strip, tile) == pick else ""
                parts.append(f"{strip}x{tile}{mark} {ms:.4f}")
        log(f"[sweep] D2 G={G} T={T} on the card alone (ms, strip x tile, "
            f"bits equal under every grid): " + ", ".join(parts)
            + f"; bound {d2_bound(G * T * BINS, 40)['bound_ms']:.4f}")
    rng = np.random.RandomState(1)
    for batch in (1, 8, 64, 512):
        dec = torch.from_numpy(rng.rand(batch, 85) < 0.7).to(device)
        n_valid = torch.full((batch,), 85, dtype=torch.int32)
        keep, kept = vad_collect_rows(dec, n_valid.to(device))
        ref_keep, ref_kept = vad_collect_rows_plain(dec.cpu(), n_valid)
        if not (torch.equal(keep.cpu(), ref_keep)
                and torch.equal(kept.cpu(), ref_kept)):
            raise AssertionError(f"W2 B={batch}: differs from collect_mask")
        nv = n_valid.to(device)
        log(f"[sweep] W2 B={batch}: time_ms "
            f"{time_ms(vad_collect_rows, dec, nv, reps=50):.4f}, queued_ms "
            f"{queued_ms(vad_collect_rows, dec, nv):.4f} (== collect_mask)")
    log(f"[sweep] launch floor (queued_ms of an empty kernel) "
        f"{queued_ms(torch.cuda._sleep, 0):.4f}")


def other_launch(source: Path, tmp: Path):
    """A launch function ``(mask, out)`` of another D2 build."""
    text = source.read_text()
    nvcc(source, tmp / "other.so")
    lib = ctypes.CDLL(str(tmp / "other.so"))
    fn = lib.smooth_mask_launch
    fn.restype = ctypes.c_int
    earlier = re.search(r"int nt, int tile_t, cudaStream_t", text)
    fn.argtypes = [P, P, I, I, I, P, I, P, I] + ([I] if earlier else [I, I]) \
        + [P]

    def launch(mask, out):
        G, T, K = mask.shape
        v_f, v_t = dn._smoothing_taps(DenoiseConfig(), 16000, mask.device)
        grid = (16,) if earlier else smooth_plan(G, T, K)
        err = fn(mask.data_ptr(), out.data_ptr(), G, T, K, v_f.data_ptr(),
                 len(v_f), v_t.data_ptr(), len(v_t), *grid,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{source}: cudaError {err}")
    return launch


def trace(fn, *args, calls: int = 40) -> tuple:
    """(median kernel duration, median gap between kernels, both in ms;
    kernels traced) of ``calls`` back-to-back calls under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if "smooth_mask" in e.name)
    gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:])] or [0]
    return (statistics.median(b - a for a, b in spans) / 1e3,
            statistics.median(gaps) / 1e3, len(spans))


def ablate(device, baseline, stages) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if baseline:
            source = Path(baseline)
        else:
            text = _build.CUDA_KERNELS["denoise"][0].read_text()
            old = re.search(r"constexpr int kSmoothStages = \d+;", text)
            if not old:
                raise RuntimeError("kSmoothStages not found in denoise.cu")
            source = tmp / "variant.cu"
            source.write_text(text.replace(
                old.group(0), f"constexpr int kSmoothStages = {stages};"))
        other = other_launch(source, tmp)
        log(f"[ablate] other build: {baseline or f'kSmoothStages = {stages}'}")

        def tree(mask, out):
            tree_launch(mask, out, *smooth_plan(*mask.shape))
        for (G, T), mask in masks(device).items():
            a, b = torch.empty_like(mask), torch.empty_like(mask)
            other(mask, a)
            tree(mask, b)
            torch.cuda.synchronize()
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
            got = {}
            for name, fn in (("other", other), ("tree", tree),
                             ("tree", tree), ("other", other)):
                got.setdefault(name, []).append(
                    (time_ms(fn, mask, a), queued_ms(fn, mask, a),
                     *trace(fn, mask, a)))
            parts = []
            for name, runs in got.items():
                ev, q, dur, gap, n = (min(r[i] for r in runs)
                                      for i in range(5))
                parts.append(f"{name} time_ms {ev:.4f}, queued_ms {q:.4f}, "
                             f"profiler duration {dur:.4f}, gap {gap:.4f} "
                             f"({n} of 40 kernels traced)")
            log(f"[ablate] D2 G={G} T={T}: bits "
                f"{'equal' if same else 'DIFFER'}; " + "; ".join(parts))


def main() -> int:
    if not torch.cuda.is_available():
        print("smooth_probe: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("build")
    sub.add_parser("sweep")
    ab = sub.add_parser("ablate")
    group = ab.add_mutually_exclusive_group(required=True)
    group.add_argument("--baseline")
    group.add_argument("--stages", type=int)
    args = parser.parse_args()
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60).stdout.strip())
    device = torch.device("cuda", 0)
    if args.cmd == "build":
        ptxas_report()
    elif args.cmd == "sweep":
        sweep(device)
    else:
        ablate(device, args.baseline, args.stages)
    return 0


if __name__ == "__main__":
    sys.exit(main())
