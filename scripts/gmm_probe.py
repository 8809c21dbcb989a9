"""Build report, sweep, ablation and path count of the GMM VAD's kernel G1
on one CUDA card.

    env PYTHONPATH=. python3 scripts/gmm_probe.py build
    env PYTHONPATH=. python3 scripts/gmm_probe.py sweep
    env PYTHONPATH=. python3 scripts/gmm_probe.py ablate --baseline OLD.cu
    env PYTHONPATH=. python3 scripts/gmm_probe.py versus --other F.cu
    env PYTHONPATH=. python3 scripts/gmm_probe.py stages
    env PYTHONPATH=. python3 scripts/gmm_probe.py path [--root DIR]

``build``: compiles ``csrc/gmm_vad.cu`` with ``-Xptxas -v`` and prints each
entry's registers, stack frame and spills.

``sweep``: G1 from samples (``gmm_vad_windows``) at B = 1, 8, 64 and 512
live windows (40,960 samples, 85 frames) and on the 10 s calibration clip
(160,000 samples, T = 333, with and without the scan): ``time_ms`` (CUDA
events) and ``queued_ms`` (the card alone) beside the bound (``g1_bound``)
and the chain floor (``g1_chain_ms``); then every cluster size forced at
B = 1, 8 and 64, each output bit for bit the wrapper's; then the same
filterbank through cuDNN ``conv1d`` (fp32, TF32 off; its band energies
checked against the plain filterbank's), ``time_ms``.

``ablate``: an earlier G1 (``--baseline``, the energies-in kernel of the
earlier tree, ``gmm_vad_launch``) beside the same source with each row's
energies staged in shared memory before its loop (a textual variant) and
this tree's scan alone (``gmm_vad_rows``), on the same energies at B = 1,
8 and 64, in turns (earlier, staged, tree, tree, staged, earlier): bits
compared, ``time_ms`` and ``queued_ms``; then the earlier path on the card
(the plain filterbank and ``total_db`` in torch ops, then the earlier
kernel) beside this tree's one launch at B = 1 and 64.

``versus --other F``: another build of ``gmm_vad.cu`` with this tree's C
interface beside this tree's, in turns (other, tree, tree, other): G1 from
samples at B = 1, 8, 64 and 512 and the scan alone at B = 1 and 64, every
output bit for bit, ``time_ms``.  ``--sass`` writes both builds' SASS to
``chiprun_out/g1_{tree,other}.sass``.

``stages``: where the filterbank's time goes: builds of this tree's source
that end each chunk after S1, S2, S3 or S6, and one that writes a constant
instead of loading the samples, timed in turns (``window_log_energies``,
no scan, B=132 live windows: one CTA a stream, one an SM).

``path``: ``preprocess_window(gmm_state=)`` at B=1 over 30 live windows on
the card: host-clock p50/p90 (synchronized) and, from ``torch.profiler``,
the device launches a window.  ``--root DIR`` imports ``mmla_audio_torch``
from ``DIR`` (an earlier tree's package) instead of this tree's.

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
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
BATCHES = (1, 8, 64, 512)
N_LIVE, N_CAL = 40960, 160000
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def nvcc(src: Path, out: Path, verbose: bool = False) -> str:
    from mmla_audio_torch import _build

    flags = ("-Xptxas", "-v") if verbose else ()
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return proc.stderr


def ptxas_report(log) -> None:
    from mmla_audio_torch import _build

    with tempfile.TemporaryDirectory() as tmp:
        report = nvcc(_build.CUDA_KERNELS["gmm_vad"][0],
                      Path(tmp) / "g1.so", verbose=True)
    for line in report.splitlines():
        if re.search(r"Compiling entry|registers|stack frame|spill", line):
            log(f"[ptxas] {line.strip()}")


def inputs(device, batch: int, n: int = N_LIVE, seed: int = 60):
    """``batch`` synthetic speech windows of ``n`` samples (int16 scale,
    float32) and their state rows, calibrated on seeded ambient noise."""
    from chip_smoke import ambient, vad_windows
    from mmla_audio_torch.vad import gmm

    x = torch.from_numpy(vad_windows(batch, seed, n=n).astype(np.float32))
    rows = torch.stack([gmm.state_rows(gmm.gmm_init_from_noise(
        ambient(seed + b), device="cpu")) for b in range(4)])
    return x.to(device), rows[torch.arange(batch) % 4].contiguous().to(device)


def conv_energies(x: torch.Tensor, frame_len: int = 480) -> torch.Tensor:
    """The band energies from ``chip_smoke.g1_conv_filterbank``."""
    from chip_smoke import g1_conv_filterbank as conv_filterbank

    T = x.shape[-1] // frame_len
    out = []
    for sig, d in zip(conv_filterbank(x), (32, 32, 16, 8, 8, 8)):
        m = frame_len // d
        e = torch.mean(torch.square(sig[:, : T * m].reshape(-1, T, m)), -1)
        out.append(10.0 * torch.log10(torch.clamp(e, min=1e-10)))
    return torch.stack(out, -1)


def sweep(device, log) -> None:
    from chip_smoke import g1_bound, g1_chain_ms, queued_ms, time_ms
    from chip_smoke import g1_conv_filterbank as conv_filterbank
    from chip_smoke import g1_energies_close
    from mmla_audio_torch.vad import gmm

    floor = queued_ms(torch.cuda._sleep, 0)
    log(f"[sweep] launch floor (queued_ms of an empty kernel) {floor:.4f}; "
        f"chain floor at T=85 {g1_chain_ms(85):.4f} ms, at T=333 "
        f"{g1_chain_ms(333):.4f} ms")
    cases = [(b, N_LIVE, True) for b in BATCHES] + [(1, N_CAL, True),
                                                    (1, N_CAL, False)]
    for batch, n, scan in cases:
        x, rows = inputs(device, batch, n)
        if scan:
            fn = lambda: gmm.gmm_vad_windows(x, rows)      # noqa: E731
        else:
            fn = lambda: gmm.window_log_energies(x)        # noqa: E731
        ms, alone = time_ms(fn, reps=50), queued_ms(fn)
        b = g1_bound(batch, n)
        log(f"[sweep] G1 B={batch} n={n}{'' if scan else ' energies only'} "
            f"(cluster {gmm.g1_cluster(batch, n // 480)}): time_ms {ms:.4f}, "
            f"queued_ms {alone:.4f}; bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}), chain floor "
            f"{g1_chain_ms(n // 480):.4f} ms")
    choose = gmm.g1_cluster
    try:
        for batch in (1, 8, 64):
            x, rows = inputs(device, batch)
            ref = gmm.gmm_vad_windows(x, rows, with_energies=True)
            parts = []
            for k in (1, 2, 4, 8):
                gmm.g1_cluster = lambda b, t, k=k: k
                got = gmm.gmm_vad_windows(x, rows, with_energies=True)
                if not all(torch.equal(a, r) for a, r in zip(got, ref)):
                    raise AssertionError(f"cluster {k} at B={batch}: bits")
                parts.append(f"cluster {k} "
                             f"{time_ms(gmm.gmm_vad_windows, x, rows, reps=50):.4f}")
            gmm.g1_cluster = choose
            log(f"[sweep] G1 layouts at B={batch}, bits equal, time_ms: "
                + ", ".join(parts) + f" (the wrapper's: cluster "
                f"{choose(batch, 85)})")
    finally:
        gmm.g1_cluster = choose
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for batch in BATCHES:
            x, _ = inputs(device, batch)
            worst = g1_energies_close(conv_energies(x),
                                      gmm.band_log_energies(x),
                                      gmm.total_db(x))
            ms = time_ms(conv_filterbank, x, reps=20)
            log(f"[sweep] cuDNN conv1d filterbank B={batch} (TF32 off; its "
                f"energies within {worst:.3g} dB of the plain filterbank's): "
                f"time_ms {ms:.4f}")


def staged_variant(text: str) -> str:
    """An earlier G1 source with each row's energies copied into shared
    memory before the frame loop (T <= 256)."""
    old = re.search(r"  const float\* e_row = [^\n]*\n  const float\* t_row "
                    r"= [^\n]*\n", text)
    if not old:
        raise RuntimeError("the baseline's e_row/t_row lines not found")
    staged = (
        "  __shared__ float stage_e[kWarps][256 * kBands];\n"
        "  __shared__ float stage_t[kWarps][256];\n"
        "  const int w_ = threadIdx.x >> 5;\n"
        "  for (int i = lane; i < T * kBands; i += 32)\n"
        "    stage_e[w_][i] = energies[static_cast<size_t>(row) * T * kBands"
        " + i];\n"
        "  for (int i = lane; i < T; i += 32)\n"
        "    stage_t[w_][i] = total_db[static_cast<size_t>(row) * T + i];\n"
        "  __syncwarp();\n"
        "  const float* e_row = stage_e[w_];\n"
        "  const float* t_row = stage_t[w_];\n")
    return text.replace(old.group(0), staged)


def other_launch(source: Path, out: Path):
    nvcc(source, out)
    fn = ctypes.CDLL(str(out)).gmm_vad_launch
    fn.restype = I
    fn.argtypes = [P, P, P, I, I, F, F, I, P, P, P]

    def launch(e, tot, rows, mode=3):
        B, T = tot.shape
        dec = torch.empty((B, T), dtype=torch.uint8, device=e.device)
        out_rows = torch.empty_like(rows)
        g_thr, l_thr = (2.0, 5.0) if mode == 3 else (0.5, 2.0)
        err = fn(e.data_ptr(), tot.data_ptr(), rows.data_ptr(), B, T, g_thr,
                 l_thr, 1, dec.data_ptr(), out_rows.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{source.name}: cudaError {err}")
        return dec.view(torch.bool), out_rows
    return launch


def ablate(device, baseline: Path, log) -> None:
    from chip_smoke import queued_ms, time_ms
    from mmla_audio_torch.vad import gmm

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        staged_src = tmp / "staged.cu"
        staged_src.write_text(staged_variant(baseline.read_text()))
        arms = {"earlier": other_launch(baseline, tmp / "earlier.so"),
                "staged": other_launch(staged_src, tmp / "staged.so"),
                "tree": lambda e, t, r: gmm.gmm_vad_rows(e, t, r)}
        for batch in (1, 8, 64):
            x, rows = inputs(device, batch)
            e, tot = gmm.band_log_energies(x), gmm.total_db(x)
            outs = {k: fn(e, tot, rows) for k, fn in arms.items()}
            same = all(torch.equal(a, b) for o in outs.values()
                       for a, b in zip(o, outs["earlier"]))
            got = {}
            for name in ("earlier", "staged", "tree", "tree", "staged",
                         "earlier"):
                got.setdefault(name, []).append(
                    (time_ms(arms[name], e, tot, rows, reps=50),
                     queued_ms(arms[name], e, tot, rows)))
            log(f"[ablate] scan alone B={batch} T=85: decisions and states "
                f"{'equal' if same else 'DIFFER'} across the three; "
                + "; ".join(f"{k} time_ms {min(r[0] for r in v):.4f}, "
                            f"queued_ms {min(r[1] for r in v):.4f}"
                            for k, v in got.items()))
        earlier = arms["earlier"]
        for batch in (1, 64):
            x, rows = inputs(device, batch)

            def old_path():
                return earlier(gmm.band_log_energies(x), gmm.total_db(x),
                               rows)
            times = {}
            for name, fn in (("earlier path", old_path),
                             ("G1", lambda: gmm.gmm_vad_windows(x, rows)),
                             ("G1 ", lambda: gmm.gmm_vad_windows(x, rows)),
                             ("earlier path ", old_path)):
                times.setdefault(name.strip(), []).append(
                    time_ms(fn, reps=20))
            log(f"[ablate] B={batch}, samples to decisions on the card: "
                + ", ".join(f"{k} {min(v):.4f} ms" for k, v in times.items()))


def sass(lib: Path, out: Path) -> None:
    tool = Path(_nvcc_dir(), "cuobjdump")
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    out.parent.mkdir(exist_ok=True)
    out.write_text(proc.stdout or proc.stderr)


def _nvcc_dir() -> str:
    from mmla_audio_torch import _build

    return str(Path(_build.nvcc()).parent)


def versus(device, other_src: Path, write_sass: bool, log) -> None:
    from chip_smoke import time_ms
    from mmla_audio_torch import _build
    from mmla_audio_torch.vad import gmm

    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "other.so"
        nvcc(other_src, lib_path)
        other = ctypes.CDLL(str(lib_path))
        for fn_name, argtypes in _build.CUDA_KERNELS["gmm_vad"][1].items():
            getattr(other, fn_name).restype = I
            getattr(other, fn_name).argtypes = argtypes
        if write_sass:
            sass(lib_path, ROOT / "chiprun_out" / "g1_other.sass")
            tree_so = Path(tmp) / "tree.so"
            nvcc(_build.CUDA_KERNELS["gmm_vad"][0], tree_so)
            sass(tree_so, ROOT / "chiprun_out" / "g1_tree.sass")
        tree_get = _build.cuda_library

        def run_other(fn, *args):
            _build.cuda_library = lambda name: other
            try:
                return fn(*args)
            finally:
                _build.cuda_library = tree_get
        cases = [("G1", b) for b in BATCHES] + [("scan", 1), ("scan", 64)]
        for kind, batch in cases:
            x, rows = inputs(device, batch)
            if kind == "G1":
                fn = lambda: gmm.gmm_vad_windows(          # noqa: E731
                    x, rows, with_energies=True)
            else:
                e, tot = gmm.band_log_energies(x), gmm.total_db(x)
                fn = lambda: gmm.gmm_vad_rows(e, tot, rows)  # noqa: E731
            a, b = fn(), run_other(fn)
            same = all(torch.equal(p, q) for p, q in zip(a, b))
            times = {}
            for name in ("other", "tree", "tree", "other"):
                call = fn if name == "tree" else \
                    (lambda: run_other(fn))                  # noqa: E731
                times.setdefault(name, []).append(time_ms(call, reps=50))
            log(f"[versus] {kind} B={batch}: outputs "
                f"{'equal' if same else 'DIFFER'}; time_ms "
                + ", ".join(f"{k} {min(v):.4f}" for k, v in times.items()))


STAGE_CUTS = {"after S1": "    // S2: x8 -> hp24, lp02",
              "after S2": "    // S3a: hp24 -> b23, b34",
              "after S3": "    // S4: lp01 -> b051, lp005",
              "after S6": "    // the band energies, low band first"}
SAMPLE_LOAD = "        buf[kX][i - r.keep] = __ldg(x_row + i);"


def stages(device, log) -> None:
    from chip_smoke import time_ms
    from mmla_audio_torch import _build
    from mmla_audio_torch.vad import gmm

    text = _build.CUDA_KERNELS["gmm_vad"][0].read_text()
    variants = {"whole": text,
                "no sample load": text.replace(SAMPLE_LOAD, SAMPLE_LOAD.split(
                    " = ")[0] + " = float(i & 7);")}
    for name, marker in STAGE_CUTS.items():
        if text.count(marker) != 1:
            raise RuntimeError(f"stage marker not found: {marker.strip()}")
        variants[name] = text.replace(marker, "    continue;\n" + marker)
    if variants["no sample load"] == text:
        raise RuntimeError("the sample load line not found")
    x, _ = inputs(device, 132)
    tree_get = _build.cuda_library
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, source in variants.items():
            src = Path(tmp) / f"{len(libs)}.cu"
            src.write_text(source)
            nvcc(src, src.with_suffix(".so"))
            lib = ctypes.CDLL(str(src.with_suffix(".so")))
            for fn_name, argtypes in _build.CUDA_KERNELS["gmm_vad"][1].items():
                getattr(lib, fn_name).restype = I
                getattr(lib, fn_name).argtypes = argtypes
            libs[name] = lib
        times = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                _build.cuda_library = lambda n, lib=libs[name]: lib
                try:
                    times.setdefault(name, []).append(
                        time_ms(gmm.window_log_energies, x, reps=30))
                finally:
                    _build.cuda_library = tree_get
    log("[stages] B=132, energies only, time_ms: " + ", ".join(
        f"{k} {min(v):.4f}" for k, v in times.items()))


def path(device, log) -> None:
    from chip_smoke import ambient, profile_steps, vad_windows
    from mmla_audio_torch.core.config import PipelineConfig
    from mmla_audio_torch.ops.denoise import noise_threshold
    from mmla_audio_torch.streaming.session import preprocess_window
    from mmla_audio_torch.vad import gmm

    cfg = PipelineConfig()
    noise = ambient(52)
    nt = noise_threshold(torch.from_numpy(noise.astype(np.float32) / 32768.0)
                         .to(device), cfg.denoise)
    state = gmm.gmm_init_from_noise(noise, device=device)
    windows = vad_windows(30, seed=51, n=cfg.audio.window_samples)
    for w in windows[:3]:
        preprocess_window(w, nt, cfg, gmm_state=state)
    torch.cuda.synchronize()
    times = []
    for w in windows:
        t0 = time.perf_counter()
        preprocess_window(w, nt, cfg, gmm_state=state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    def run():
        for w in windows[:10]:
            preprocess_window(w, nt, cfg, gmm_state=state)
    prof = profile_steps(run, 10)
    log(f"[path] {Path(gmm.__file__).parent.parent}: preprocess_window("
        f"gmm_state=) at B=1 over {len(windows)} windows, p50 "
        f"{np.percentile(times, 50):.3f} / p90 {np.percentile(times, 90):.3f}"
        f" ms (host clock); {prof['launches']:.1f} device launches a window "
        f"(torch.profiler), device busy "
        + ("not measured" if prof["busy_ms"] is None
           else f"{prof['busy_ms']:.3f} ms a window"))


def main() -> int:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("build")
    sub.add_parser("sweep")
    ab = sub.add_parser("ablate")
    ab.add_argument("--baseline", type=Path, required=True)
    vs = sub.add_parser("versus")
    vs.add_argument("--other", type=Path, required=True)
    vs.add_argument("--sass", action="store_true")
    sub.add_parser("stages")
    pa = sub.add_parser("path")
    pa.add_argument("--root", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gmm_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if getattr(args, "root", None) is not None:
        sys.path.insert(0, str(args.root.resolve()))
    from chip_smoke import log

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    device = torch.device("cuda", 0)
    if args.cmd == "build":
        ptxas_report(log)
    elif args.cmd == "sweep":
        sweep(device, log)
    elif args.cmd == "ablate":
        ablate(device, args.baseline, log)
    elif args.cmd == "versus":
        versus(device, args.other, args.sass, log)
    elif args.cmd == "stages":
        stages(device, log)
    else:
        path(device, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
