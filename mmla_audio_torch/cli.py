"""Command-line entry points of the PyTorch port.

    python -m mmla_audio_torch.cli setup        --root experiment
    python -m mmla_audio_torch.cli overlap-live --fake [--windows N] [--vad energy|webrtc]
    python -m mmla_audio_torch.cli overlap-run  -f clip.wav | --dir DIR
    python -m mmla_audio_torch.cli overlap-post --root experiment
    python -m mmla_audio_torch.cli charts       --root experiment [--kind overlap|speaker]

``--weights PATH.npz`` loads the model from the flat ``.npz`` that
``params.py`` documents; without it the weights are random-init from
``--seed`` (Keras initializers, as the JAX CLI without ``--ckpt``).
``--device`` defaults to ``cuda``; a run without a card fails unless it
asks for ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mmla_audio_torch.core.config import PipelineConfig, VadConfig


def _device(args) -> torch.device:
    return torch.device(args.device or "cuda")


def _cfg(args) -> PipelineConfig:
    """PipelineConfig honoring ``--vad``."""
    cfg = PipelineConfig()
    if getattr(args, "vad", None):
        cfg = dataclasses.replace(cfg, vad=VadConfig(decision=args.vad))
    return cfg


def _predictor(args, cfg):
    from mmla_audio_torch.inference import OverlapPredictor
    from mmla_audio_torch.models.overlap import OverlapResBLSTM, keras_init_
    from mmla_audio_torch.params import (load_overlap_npz,
                                         overlap_state_dict_from_jax)

    if args.weights:
        state_dict = overlap_state_dict_from_jax(
            load_overlap_npz(args.weights, cfg.overlap_model),
            cfg.overlap_model)
        print(f"[INFO] weights: {args.weights}")
    else:
        state_dict = keras_init_(OverlapResBLSTM(cfg.overlap_model),
                                 torch.Generator().manual_seed(args.seed)
                                 ).state_dict()
        print("[WARN] no --weights: using random-init weights "
              f"(seed {args.seed})")
    return OverlapPredictor(state_dict, cfg.overlap_model,
                            cfg.overlap_feature, device=_device(args),
                            matmul_precision=args.precision)


def cmd_setup(args):
    from mmla_audio_torch.utils.experiment import bootstrap

    dirs = bootstrap(args.root)
    print(f"[INFO] experiment tree ready under {dirs.root}")


def cmd_overlap_live(args):
    from mmla_audio_torch.streaming.capture import CaptureThread, FakePCMSource
    from mmla_audio_torch.streaming.session import OverlapSession

    if not args.fake:
        raise SystemExit("overlap-live: microphone capture is not ported "
                         "yet; pass --fake")
    cfg = _cfg(args)
    pred = _predictor(args, cfg)
    cap = CaptureThread(FakePCMSource(cfg.audio, seed=args.seed,
                                      realtime=args.realtime),
                        cfg.audio).start()
    try:
        sess = OverlapSession(pred, cap, args.root, cfg=cfg,
                              save_recordings=args.save_recordings)
        cal_s = args.calibrate_seconds or cfg.audio.noise_profile_seconds
        print(f"[INFO] calibrating ambient noise ({cal_s:.0f}s)...")
        sess.calibrate(args.calibrate_seconds)
        print("[INFO] model loaded: start predicting...")

        def show(idx, label, prob):
            print(f"[INFO] window {idx}: {label}  (probs {np.round(prob, 3)})")

        sess.run(max_windows=args.windows, on_result=show)
    finally:
        cap.stop()
    print(f"[INFO] log: {sess.log.path}")


def cmd_overlap_run(args):
    """Offline WAV file(s) -> one label each (no VAD: the silent gate is the
    raw length), with timings."""
    from mmla_audio_torch.analyze.logs import OVERLAP_LABELS
    from mmla_audio_torch.data.wavio import read_wav

    if not args.file and not args.dir:
        raise SystemExit("overlap-run: pass -f FILE or --dir DIR")
    cfg = PipelineConfig()
    paths = [Path(args.file)] if args.file else \
        sorted(Path(args.dir).glob("*.wav"))
    if not paths:
        raise SystemExit(f"overlap-run: no .wav files under {args.dir}")
    times = {}
    t0 = time.perf_counter()
    pred = _predictor(args, cfg)
    times["model_load"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    bufs = np.zeros((len(paths), cfg.audio.window_samples), np.int16)
    counts = np.zeros(len(paths), np.int32)
    for i, p in enumerate(paths):
        sig, _ = read_wav(p)
        k = min(len(sig), bufs.shape[1])
        bufs[i, :k] = sig[:k]
        counts[i] = k
    times["wav_load"] = time.perf_counter() - t0

    for stage in ("predict_first", "predict_steady"):
        t0 = time.perf_counter()
        labels, _ = pred.predict(bufs, counts)
        labels = labels.cpu().numpy()
        times[stage] = time.perf_counter() - t0

    for p, lab in zip(paths, labels):
        name = "silent" if lab < 0 else OVERLAP_LABELS[str(int(lab))]
        print(f"[RESULT] {p.name}: {name}")
    for stage, s in times.items():
        print(f"[TIME] {stage}: {s * 1e3:.1f} ms")


def cmd_overlap_post(args):
    """Every recording under ``post-time/whole`` -> a TSV log and a chart."""
    from mmla_audio_torch.analyze.post_time import overlap_post_analyze
    from mmla_audio_torch.data.wavio import read_wav
    from mmla_audio_torch.utils.experiment import bootstrap

    cfg = _cfg(args)
    dirs = bootstrap(args.root)
    noise = read_wav(dirs.noise_path)[0] if dirs.noise_path.exists() else None
    pred = _predictor(args, cfg)
    t0 = time.perf_counter()
    logs = overlap_post_analyze(dirs, pred, cfg=cfg, noise=noise)
    print(f"[TIME] overlap-post: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for name, log in logs.items():
        print(f"[INFO] {name}: {log}")


def cmd_charts(args):
    from mmla_audio_torch.analyze.charts import visualize_all
    from mmla_audio_torch.utils.experiment import ExperimentDirs

    dirs = ExperimentDirs(args.root)
    for out in visualize_all(dirs.logs, dirs.charts, kind=args.kind):
        print(f"[INFO] {out}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mmla_audio_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--seed", type=int, default=0,
                       help="seed of the random-init weights (and of the "
                            "fake source)")
        p.add_argument("--device", default=None,
                       help="torch device (default cuda; pass cpu to run "
                            "without a card)")
        p.add_argument("--precision", choices=["auto", "highest"],
                       default="auto",
                       help="model convs/LSTM/GEMMs: 'auto' allows TF32 on "
                            "the card, 'highest' keeps IEEE fp32")
        p.add_argument("--weights", default=None, metavar="PATH.npz",
                       help="model weights as the flat .npz of params.py "
                            "(default: random init from --seed)")

    p = sub.add_parser("setup")
    p.add_argument("--root", default="experiment")
    p.set_defaults(fn=cmd_setup)

    p = sub.add_parser("overlap-live")
    common(p)
    p.add_argument("--root", default="experiment")
    p.add_argument("--fake", action="store_true",
                   help="deterministic PCM source instead of a microphone")
    p.add_argument("--realtime", action="store_true")
    p.add_argument("--windows", type=int, default=None)
    p.add_argument("--calibrate-seconds", type=float, default=None)
    p.add_argument("--save-recordings", action="store_true")
    p.add_argument("--vad", choices=["energy", "webrtc"], default=None,
                   help="per-frame VAD decision (default webrtc, the "
                        "bit-exact native engine)")
    p.set_defaults(fn=cmd_overlap_live)

    p = sub.add_parser("overlap-run")
    common(p)
    p.add_argument("-f", "--file", default=None)
    p.add_argument("-dir", "--dir", default=None)
    p.set_defaults(fn=cmd_overlap_run)

    p = sub.add_parser("overlap-post")
    common(p)
    p.add_argument("--root", default="experiment")
    p.set_defaults(fn=cmd_overlap_post)

    p = sub.add_parser("charts")
    p.add_argument("--root", default="experiment")
    p.add_argument("--kind", default="overlap", choices=["overlap", "speaker"])
    p.set_defaults(fn=cmd_charts)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
