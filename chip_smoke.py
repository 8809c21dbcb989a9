"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mmla_audio_torch/csrc`` (one nvcc
per source, all at once), then:

1. featurizer: kernel vs its plain PyTorch version on the card, B=1 and
   B=64 seeded windows (|diff| <= 1 quantization step on < 2 % of pixels),
   with CUDA-event timings of both;
   grouped: ``group=4`` on B=6 (a partial group) and ``group=2`` on
   ``time_dim=151`` (152 frames), each bit-equal to ``group=1``; at B=200,
   480 (the post-time conversations), 1024 and 2400 every group bit-equal
   to ``group=1``, within the budget of the plain version, and CUDA-event
   timings of each group and the plain version beside the wrapper's pick;
2. fused residual block: the tensor-core kernel (every width with C % 8 ==
   0) vs ``fused_resblock_plain`` at the three non-pooling shapes of the
   full-width model, B=1, 64, 200 and 480 (the last two are the post-time
   batches), and the FFMA kernel (C % 8 != 0) at C=12, TF32 off, max |diff|
   <= 1e-4 * max |ref|; CUDA-event timings of the kernel, the plain version
   and the unfused ``ResBlock2D`` (cuDNN, the yardstick);
3. predictor: the full-width default ``OverlapModelConfig()`` with weights
   from a seeded numpy tree through ``params.py``; B=8 on the card vs the
   same predictor on the CPU, TF32 off;
4. session: ``OverlapSession`` on the card over 4 windows (one all zeros),
   a main path whose kernel launches are counted; the same session on the
   CPU must give the same labels; window-to-decision time;
5. post-time: ``overlap_post_analyze`` over a 5-minute ``audio*`` recording
   (3 denoise passes, 200 windows) and a 12-minute ``zoom*`` one (480
   windows, enough for ``pick_group`` to take the grouped featurizer),
   the other main path whose launches are counted (the fused block's on the
   tensor cores), on the card and on the CPU; labels equal where the CPU's
   top-2 margin is above 1e-3; windows per
   second on the host clock; then the CLI's ``overlap-post --weights``;
6. CLI: ``python -m mmla_audio_torch.cli overlap-run -f <wav>``.

The line before the last is a JSON object describing each kernel, with its
bound: the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and its fp32 FLOPs as 3xTF32 on the tensor cores (three
TF32 products for each fp32 one at 495 TFLOP/s, 165 TFLOP/s of fp32 work,
faster than the CUDA cores' 67 TFLOP/s), H100 SXM peaks.  The last line is
``{"ok": true, "device": {...}}``.  Any failure raises, so nothing after it
is printed and the exit code is not 0.  Without a CUDA device the script
stops before doing anything.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BUDGET_STEP, BUDGET_SHARE = 1.0, 0.02      # featurizer pixel budget
TOP2_MARGIN, PROB_ATOL = 1e-3, 1e-4        # predictor card vs CPU
BLOCK_RTOL = 1e-4                          # fused block: of max |ref|
# non-pooling ResBlock2D shapes of the full-width model: (C, H, W)
BLOCK_SHAPES = ((32, 64, 76), (64, 32, 38), (128, 16, 19))
# post-time recordings: name -> (seconds, windows); each is one batch
RECORDINGS = {"audio_conv0": (300, 200), "zoom_conv1": (720, 480)}
POST_BATCHES = tuple(n for _, n in RECORDINGS.values())
# H100 SXM peaks: device memory, TF32 on the tensor cores; an fp32 product
# at fp32 accuracy is three TF32 ones (3xTF32)
HBM_BYTES_S, TF32_FLOP_S, TF32_PER_FP32 = 3.35e12, 495e12, 3


def bound(flop: float, nbytes: float) -> dict:
    """The least time the card could take: bytes at its memory rate, or fp32
    FLOPs as 3xTF32 at its tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flop * TF32_PER_FP32 / TF32_FLOP_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def featurizer_bound(batch: int) -> dict:
    """DFT (re and im) and mel GEMMs of every frame; the windows in, the
    images out and the bases read once."""
    from mmla_audio_torch.core.config import OverlapFeatureConfig

    cfg = OverlapFeatureConfig()
    win, T, M = cfg.win_length, cfg.n_frames, cfg.n_mels
    bins = win // 2 + 1
    flop = batch * T * (4 * win * bins + 2 * bins * M)
    nbytes = 4 * (batch * (cfg.n_samples + 3 * M * T)
                  + 2 * win * bins + bins * M)
    return bound(flop, nbytes)


def block_work(batch: int, C: int, H: int, W: int) -> tuple:
    """(FLOPs, bytes) of a block: both convolutions (2 * 13 C^2 FLOPs a
    pixel); x in, out out, the weights and vectors read once."""
    return (2 * 13 * C * C * H * W * batch,
            4 * (2 * batch * C * H * W + 13 * C * C + 6 * C))


def log(msg: str) -> None:
    print(msg, flush=True)


def seeded_tree(shapes, rng):
    """Random numpy tree in the JAX model's layout, every leaf perturbed."""
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = seeded_tree(val, rng)
        elif key in ("var", "scale"):
            out[key] = rng.uniform(0.5, 2.0, val).astype(np.float32)
        elif key in ("kernel", "recurrent_kernel"):
            fan = np.prod(val[:-1]) + val[-1]
            out[key] = (rng.randn(*val) * np.sqrt(2.0 / fan)).astype(np.float32)
        else:
            out[key] = (rng.randn(*val) * 0.1).astype(np.float32)
    return out


def time_ms(fn, *args, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event mean over ``reps`` calls."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def speech_windows(n_windows: int, n: int, seed: int) -> np.ndarray:
    from mmla_audio_torch.streaming.capture import FakePCMSource

    src = FakePCMSource(seed=seed, speech_ratio=0.9)
    return np.stack([src.read(n) for _ in range(n_windows)])


def phase_featurizer(device):
    from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
    from mmla_audio_torch.ops.features import overlap_model_input

    result = {}
    for batch in (1, 64):
        y = torch.from_numpy(speech_windows(batch, 24000, seed=batch)
                             .astype(np.float32) / 32768.0).to(device)
        got = overlap_model_input_cuda(y)
        torch.cuda.synchronize()
        err, share = check_budget(f"featurizer B={batch}", got,
                                  overlap_model_input(y))
        # plain, kernel, kernel, plain
        plain_a = time_ms(overlap_model_input, y)
        kern_a = time_ms(overlap_model_input_cuda, y)
        kern_b = time_ms(overlap_model_input_cuda, y)
        plain_b = time_ms(overlap_model_input, y)
        result[batch] = dict(max_abs_err=err, share=share,
                             ms=min(kern_a, kern_b),
                             plain_ms=min(plain_a, plain_b),
                             **featurizer_bound(batch), library_ms=None)
        log(f"[featurizer] B={batch}: max |diff| {err} on {share:.4%} of "
            f"pixels (budget {BUDGET_STEP} on < {BUDGET_SHARE:.0%}); kernel "
            f"{kern_a:.4f}/{kern_b:.4f} ms, plain {plain_a:.4f}/"
            f"{plain_b:.4f} ms")
    return result


def check_budget(name, got, ref):
    diff = (got - ref).abs()
    err, share = float(diff.max()), float((diff > 0).float().mean())
    if not (err <= BUDGET_STEP and share < BUDGET_SHARE
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{name}: max |diff| {err}, {share:.4%} of "
                             f"pixels differ")
    return err, share


def phase_grouped(device):
    from mmla_audio_torch.core.config import OverlapFeatureConfig
    from mmla_audio_torch.ops.cuda_features import (GROUPS,
                                                    overlap_model_input_cuda,
                                                    pick_group)
    from mmla_audio_torch.ops.features import overlap_model_input

    def windows(batch, cfg):
        return torch.from_numpy(speech_windows(batch, cfg.n_samples,
                                               seed=batch).astype(np.float32)
                                / 32768.0).to(device)

    for batch, time_dim, group in ((6, 150, 4), (4, 151, 2)):
        cfg = OverlapFeatureConfig(time_dim=time_dim)
        y = windows(batch, cfg)
        got = overlap_model_input_cuda(y, cfg, group=group)
        if not torch.equal(got, overlap_model_input_cuda(y, cfg, group=1)):
            raise AssertionError(f"grouped featurizer B={batch} G={group}: "
                                 f"differs from group=1")
        err, share = check_budget(f"grouped featurizer B={batch} G={group}",
                                  got, overlap_model_input(y, cfg))
        log(f"[grouped] B={batch} T={cfg.n_frames} G={group}: bit-equal to "
            f"G=1; max |diff| {err} on {share:.4%} of pixels")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cfg = OverlapFeatureConfig()
    result = None
    for batch in POST_BATCHES + (1024, 2400):
        y = windows(batch, cfg)
        picked = pick_group(batch, sms)
        outs = {g: overlap_model_input_cuda(y, cfg, group=g) for g in GROUPS}
        if not all(torch.equal(outs[1], outs[g]) for g in GROUPS):
            raise AssertionError(f"grouped featurizer B={batch}: the groups "
                                 f"differ")
        err, share = check_budget(f"grouped featurizer B={batch}", outs[1],
                                  overlap_model_input(y, cfg))
        del outs
        # plain, then each G up and down, then plain
        times = {g: [] for g in ("plain",) + GROUPS}
        for g in ("plain",) + GROUPS + GROUPS[::-1] + ("plain",):
            if g == "plain":
                times[g].append(time_ms(overlap_model_input, y, cfg, reps=5))
            else:
                times[g].append(time_ms(overlap_model_input_cuda, y, cfg, g,
                                        reps=5))
        log(f"[grouped] B={batch}: every G bit-equal to G=1; max |diff| {err}"
            f" on {share:.4%} of pixels; pick_group takes G={picked}; " +
            ", ".join(f"{'plain' if g == 'plain' else f'G={g}'} "
                      f"{t[0]:.4f}/{t[1]:.4f} ms" for g, t in times.items()))
        if batch == max(POST_BATCHES):
            if picked == 1:
                raise AssertionError(f"pick_group takes G=1 at the post-time "
                                     f"batch {batch} on {sms} SMs")
            result = dict(max_abs_err=err, ms=min(times[picked]),
                          plain_ms=min(times["plain"]),
                          **featurizer_bound(batch), library_ms=None)
    return result


def seeded_block(C: int, device, rng):
    """An eval-mode ``ResBlock2D(C, C)`` on ``device``, every weight and
    BatchNorm statistic drawn from ``rng``."""
    from mmla_audio_torch.models.overlap import ResBlock2D

    block = ResBlock2D(C, C).to(device).eval()
    with torch.no_grad():
        for t in block.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
                    if t.ndim == 1 else rng.randn(*t.shape).astype(
                        np.float32) / np.sqrt(t[0].numel())))
    return block


def block_error(got, ref) -> tuple:
    """(max |got - ref|, its limit BLOCK_RTOL * max |ref|, whether got is
    finite and within it); synchronizes first."""
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    limit = BLOCK_RTOL * float(ref.abs().max())
    return err, limit, err <= limit and bool(torch.isfinite(got).all())


def phase_block(device):
    from mmla_audio_torch.ops.cuda_resblock import (block_route,
                                                    fused_resblock_cuda,
                                                    fused_resblock_plain)
    from mmla_audio_torch.precision import fp32_policy

    rng = np.random.RandomState(5)
    worst = worst_rel = 0.0
    sums = dict(ms=0.0, plain_ms=0.0, unfused_ms=0.0, flop=0, bytes=0)
    for C, H, W in BLOCK_SHAPES + ((12, 8, 9),):
        block = seeded_block(C, device, rng)
        ops = block.fused_operands()
        route = block_route(C)
        for batch in (8,) if route == "ffma" else (1, 64) + POST_BATCHES:
            x = torch.from_numpy(rng.randn(batch, C, H, W).astype(np.float32)
                                 ).to(device)
            reps = 20 if batch <= 64 else 5
            with torch.no_grad(), fp32_policy(False):
                before = fused_resblock_cuda.launches_mma
                got = fused_resblock_cuda(x, *ops)
                ref = fused_resblock_plain(x, *ops)
                err, limit, ok = block_error(got, ref)
                if not ok:
                    raise AssertionError(f"fused block C={C} B={batch}: "
                                         f"max |diff| {err} > {limit}")
                if fused_resblock_cuda.launches_mma - before != (
                        route == "mma"):
                    raise AssertionError(f"fused block C={C}: not the "
                                         f"{route} kernel")
                # plain, kernel, unfused, unfused, kernel, plain
                plain_a = time_ms(fused_resblock_plain, x, *ops, reps=reps)
                kern_a = time_ms(fused_resblock_cuda, x, *ops, reps=reps)
                mod_a = time_ms(block.forward_unfused, x, reps=reps)
                mod_b = time_ms(block.forward_unfused, x, reps=reps)
                kern_b = time_ms(fused_resblock_cuda, x, *ops, reps=reps)
                plain_b = time_ms(fused_resblock_plain, x, *ops, reps=reps)
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / float(ref.abs().max()))
            work = block_work(batch, C, H, W)
            bnd = bound(*work)
            if batch in POST_BATCHES and route == "mma":
                sums["ms"] += min(kern_a, kern_b)
                sums["plain_ms"] += min(plain_a, plain_b)
                sums["unfused_ms"] += min(mod_a, mod_b)
                sums["flop"] += work[0]
                sums["bytes"] += work[1]
            log(f"[block] C={C} {H}x{W} B={batch} ({route}): max |diff| "
                f"{err:.3g} (limit {limit:.3g}); kernel {kern_a:.4f}/"
                f"{kern_b:.4f} ms, plain {plain_a:.4f}/{plain_b:.4f} ms, "
                f"unfused ResBlock2D {mod_a:.4f}/{mod_b:.4f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    total = bound(sums["flop"], sums["bytes"])
    log(f"[block] the three shapes at B={' and B='.join(map(str, POST_BATCHES))}"
        f" (one block of each shape per post-time conversation), summed: "
        f"kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, "
        f"unfused ResBlock2D {sums['unfused_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({total['bound_by']}); worst max |diff| "
        f"{worst:.3g}, / max |ref| {worst_rel:.3g}")
    return dict(max_abs_err=worst, max_rel_err=worst_rel, ms=sums["ms"],
                plain_ms=sums["plain_ms"], **total,
                library_ms=sums["unfused_ms"])


def phase_predictor(device, state_dict, cfg):
    from mmla_audio_torch.inference import OverlapPredictor

    buf = speech_windows(8, 40960, seed=11)
    n = np.array([40960, 40000, 36000, 30000, 24000, 12000, 6000, 3000],
                 np.int32)
    outs = []
    for dev in (device, "cpu"):
        pred = OverlapPredictor(state_dict, cfg, device=dev,
                                matmul_precision="highest")
        labels, probs = pred.predict(buf, n)
        outs.append((labels.cpu().numpy(), probs.float().cpu().numpy()))
    (lc, pc), (l0, p0) = outs
    if pc.shape != (8, cfg.num_classes) or not np.isfinite(pc).all():
        raise AssertionError(f"predictor output bad: {pc.shape}")
    perr = float(np.abs(pc - p0).max())
    top2 = np.sort(p0, axis=1)
    decided = (top2[:, -1] - top2[:, -2]) > TOP2_MARGIN
    if perr > PROB_ATOL or not (lc[decided] == l0[decided]).all():
        raise AssertionError(f"predictor card vs CPU: labels {lc} vs {l0}, "
                             f"max |dprob| {perr}")
    log(f"[predictor] B=8 full width: card labels {lc.tolist()} == CPU "
        f"labels {l0.tolist()} where top-2 margin > {TOP2_MARGIN} "
        f"({int(decided.sum())}/8); max |dprob| {perr:.3g} "
        f"(atol {PROB_ATOL})")


def run_session(device, state_dict, cfg, samples, noise, root):
    from mmla_audio_torch.inference import OverlapPredictor
    from mmla_audio_torch.streaming.capture import ArraySource, CaptureThread
    from mmla_audio_torch.streaming.session import OverlapSession

    pred = OverlapPredictor(state_dict, cfg.overlap_model, device=device,
                            matmul_precision="highest")
    cap = CaptureThread(ArraySource(samples), cfg.audio).start()
    try:
        sess = OverlapSession(pred, cap, root, cfg=cfg)
        sess.set_noise_profile(noise)
        rows = sess.run(max_windows=4)
    finally:
        cap.stop()
    return sess, rows


class ProbsTap:
    """An OverlapPredictor whose ``predict`` also keeps the probabilities,
    so the post-time labels can be compared where the margin is clear."""

    def __init__(self, pred):
        self.pred, self.device, self.probs = pred, pred.device, []

    def predict(self, buf, n):
        labels, probs = self.pred.predict(buf, n)
        self.probs.append(probs.cpu().numpy())
        return labels, probs


def phase_post(device, tree, state_dict, cfg, noise, tmp: Path):
    from mmla_audio_torch.analyze.logs import parse_log
    from mmla_audio_torch.analyze.post_time import overlap_post_analyze
    from mmla_audio_torch.data.wavio import write_wav
    from mmla_audio_torch.inference import OverlapPredictor
    from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_cuda
    from mmla_audio_torch.params import save_overlap_npz
    from mmla_audio_torch.streaming.capture import FakePCMSource
    from mmla_audio_torch.utils.experiment import bootstrap

    sr = cfg.audio.sample_rate
    recordings = RECORDINGS
    src = FakePCMSource(seed=31, speech_ratio=0.8)
    clips = {name: src.read(sec * sr) for name, (sec, _) in recordings.items()}
    start = datetime(2026, 1, 1)
    runs = {}
    for dev in (device, device, "cpu"):
        key = "card" if dev != "cpu" else "cpu"
        dirs = bootstrap(tmp / f"post_{key}")
        for name, clip in clips.items():
            write_wav(dirs.post_whole / f"{name}.wav", clip, sr)
        write_wav(dirs.noise_path, noise, sr)
        pred = ProbsTap(OverlapPredictor(state_dict, cfg.overlap_model,
                                         device=dev,
                                         matmul_precision="highest"))
        overlap_model_input_cuda.launches_grouped = 0
        fused_resblock_cuda.launches = fused_resblock_cuda.launches_mma = 0
        t0 = time.perf_counter()
        logs = overlap_post_analyze(dirs, pred, cfg=cfg, noise=noise,
                                    start_time=start)
        if dev != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (overlap_model_input_cuda.launches_grouped,
                    fused_resblock_cuda.launches_mma)
        rows = {name: parse_log(path) for name, path in logs.items()}
        for name, (_, n_rows) in recordings.items():
            if len(rows[name]) != n_rows or \
                    not (dirs.charts / f"{name}.html").exists():
                raise AssertionError(f"post-time {key}: {name} has "
                                     f"{len(rows[name])} rows, want {n_rows}, "
                                     f"or no chart")
        n_windows = sum(n for _, n in recordings.values())
        log(f"[post] {key}: {n_windows} windows in {seconds:.3f} s = "
            f"{n_windows / seconds:.1f} windows/s (host clock, standardize "
            f"+ denoise + predict + logs + charts); launches: grouped "
            f"featurizer {launches[0]}, fused block on the tensor cores "
            f"{launches[1]}")
        if key not in runs:                  # the card's first run counts
            runs[key] = dict(rows=rows, probs=pred.probs, launches=launches,
                             wps=n_windows / seconds)
        else:
            runs[key]["wps_warm"] = n_windows / seconds
    card, cpu = runs["card"], runs["cpu"]
    if min(card["launches"]) <= 0:
        raise AssertionError(f"post-time on the card launched the grouped "
                             f"featurizer / tensor-core fused block "
                             f"{card['launches']} times")
    decided = agree = 0
    for i, name in enumerate(sorted(recordings)):
        top2 = np.sort(cpu["probs"][i], axis=1)
        clear = (top2[:, -1] - top2[:, -2]) > TOP2_MARGIN
        got = np.array([r[1] for r in card["rows"][name]])
        ref = np.array([r[1] for r in cpu["rows"][name]])
        decided += int(clear.sum())
        agree += int((got[clear] == ref[clear]).sum())
    if agree != decided:
        raise AssertionError(f"post-time card vs CPU: {decided - agree} of "
                             f"{decided} clear labels differ")
    log(f"[post] card labels == CPU labels where the top-2 margin > "
        f"{TOP2_MARGIN} ({decided}/{sum(n for _, n in recordings.values())} "
        f"windows)")

    npz = tmp / "weights.npz"
    save_overlap_npz(tree, npz)
    cli_root = tmp / "post_cli"
    bootstrap(cli_root)
    for name, clip in clips.items():
        write_wav(cli_root / "recordings/post-time/whole" / f"{name}.wav",
                  clip, sr)
    write_wav(cli_root / "Ambient_Noise.wav", noise, sr)
    proc = subprocess.run(
        [sys.executable, "-m", "mmla_audio_torch.cli", "overlap-post",
         "--root", str(cli_root), "--weights", str(npz)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    made = [(cli_root / d / f"{name}.{ext}").exists() for name in recordings
            for d, ext in (("logs", "txt"), ("charts", "html"))]
    if proc.returncode != 0 or not all(made):
        raise AssertionError(f"CLI overlap-post failed ({proc.returncode}):"
                             f"\n{proc.stdout}\n{proc.stderr}")
    log("[post] cli: " + " | ".join(ln for ln in proc.stdout.splitlines()
                                     if ln.startswith(("[INFO]", "[TIME]"))))
    return card


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from mmla_audio_torch.core.config import OverlapModelConfig, PipelineConfig
    from mmla_audio_torch import _build
    from mmla_audio_torch.analyze.logs import parse_log
    from mmla_audio_torch.data.wavio import write_wav
    from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_cuda
    from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                         overlap_tree_shapes)

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.cuda_libraries()
    log(f"[build] {', '.join(libs)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    feat = phase_featurizer(device)
    grouped = phase_grouped(device)
    block = phase_block(device)

    cfg = PipelineConfig()
    mcfg: OverlapModelConfig = cfg.overlap_model
    tree = seeded_tree(overlap_tree_shapes(mcfg), np.random.RandomState(0))
    state_dict = overlap_state_dict_from_jax(tree, mcfg)
    phase_predictor(device, state_dict, mcfg)

    n_win = cfg.audio.window_samples
    speech = speech_windows(3, n_win, seed=21)
    samples = np.concatenate([speech[0], np.zeros(n_win, np.int16),
                              speech[1], speech[2]])
    noise = (np.random.RandomState(3).randn(160000) * 20).astype(np.int16)
    with tempfile.TemporaryDirectory() as tmp:
        overlap_model_input_cuda.launches = 0
        fused_resblock_cuda.launches = fused_resblock_cuda.launches_mma = 0
        sess, rows = run_session(device, state_dict, cfg, samples, noise,
                                 Path(tmp) / "card")
        launches = overlap_model_input_cuda.launches
        block_launches = fused_resblock_cuda.launches_mma
        labels = [r[1] for r in rows]
        logged = parse_log(sess.log.path)
        if len(rows) != 4 or len(logged) != 4 or labels[1] != "silent":
            raise AssertionError(f"session: rows {rows}, log {logged}")
        if launches <= 0 or block_launches <= 0:
            raise AssertionError(f"session launched the featurizer "
                                 f"{launches} and the fused block "
                                 f"{block_launches} times")
        _, cpu_rows = run_session("cpu", state_dict, cfg, samples, noise,
                                  Path(tmp) / "cpu")
        cpu_labels = [r[1] for r in cpu_rows]
        if labels != cpu_labels:
            raise AssertionError(f"session labels card {labels} vs CPU "
                                 f"{cpu_labels}")
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            sess.process_window(speech[0])
            times.append((time.perf_counter() - t0) * 1e3)
        log(f"[session] card labels {labels} == CPU labels; {len(logged)} "
            f"TSV rows; launches in the run: featurizer {launches}, "
            f"fused block on the tensor cores {block_launches}; "
            f"window-to-decision median {statistics.median(times):.2f} ms "
            f"(min {min(times):.2f}, max {max(times):.2f}, 10 windows)")

        wav = Path(tmp) / "clip.wav"
        write_wav(wav, speech[0])
        proc = subprocess.run(
            [sys.executable, "-m", "mmla_audio_torch.cli", "overlap-run",
             "-f", str(wav)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or "[RESULT] clip.wav:" not in proc.stdout:
            raise AssertionError(f"CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        log("[cli] " + " | ".join(ln for ln in proc.stdout.splitlines()
                                  if ln.startswith(("[RESULT]", "[TIME]"))))

        post = phase_post(device, tree, state_dict, cfg, noise, Path(tmp))

    def entry(name, source, replaces, n, measured):
        return {"name": name, "route": "cuda",
                "source": f"mmla_audio_torch/csrc/{source}",
                "replaces": replaces, "launches": n, **measured}

    log(json.dumps({"kernels": [
        entry("overlap_features", "overlap_features.cu",
              "mmla_audio_tpu/ops/pallas_features.py:44", launches, feat[1]),
        entry("overlap_features_grouped", "overlap_features.cu",
              "mmla_audio_tpu/ops/pallas_features.py:90",
              post["launches"][0], grouped),
        entry("fused_resblock", "fused_resblock.cu",
              "benchmarks/fused_block_probe.py:64", post["launches"][1],
              block),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
