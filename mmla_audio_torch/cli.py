"""Command-line entry points of the PyTorch port.

    python -m mmla_audio_torch.cli setup        --root experiment
    python -m mmla_audio_torch.cli overlap-live [--fake] [--windows N] [--vad energy|webrtc] [--edge]
    python -m mmla_audio_torch.cli speaker-live [--fake] [--windows N] [--register NAME ...] [--edge]
    python -m mmla_audio_torch.cli overlap-run  -f clip.wav | --dir DIR [--parity]
    python -m mmla_audio_torch.cli overlap-post --root experiment [--vad energy|webrtc]
    python -m mmla_audio_torch.cli speaker-post --root experiment [--vad energy|webrtc]
    python -m mmla_audio_torch.cli speaker-pretrain --wav-dir DIR --out OUT [--epochs N]
    python -m mmla_audio_torch.cli synth-corpus --wav-dir DIR --out-dir OUT [--n-mixtures N]
    python -m mmla_audio_torch.cli overlap-train --single-dir S --overlap-dir O [--out D] [--epochs N] [--augmented]
    python -m mmla_audio_torch.cli charts       --root experiment [--kind overlap|speaker]

``--weights PATH.npz`` loads the model from the flat ``.npz`` that
``params.py`` documents, ``--ckpt DIR`` from a checkpoint directory of the
port (its ``variables.npz``: what ``overlap-train --out``,
``speaker-pretrain --out``, registration's ``experiment/model`` and
``export.export_serving`` write); without either the weights are
random-init from ``--seed`` (Keras initializers, as the JAX CLI without
``--ckpt``).  A reference-trained Keras SavedModel is loaded from Python
with ``convert.load_checkpoint_state_dict``, as the JAX package offers it.  A
speaker model's head is as wide as the file's; ``speaker-post`` checks it
against the enrollment corpus (one ``.wav`` per speaker) and takes a
sigmoid head when there is one, as the JAX CLI does.  ``speaker-live
--register NAME ...`` enrolls each name from the source, fine-tunes the
``--weights`` (or random-init) base on the corpus and writes
``experiment/model/variables.npz``, which ``speaker-post --weights`` reads;
``speaker-pretrain`` trains a base model from a directory of
``<speaker>_<clip>.wav`` files into ``OUT/variables.npz``.
``synth-corpus`` mixes such clips into ``Overlap<i>.wav`` files and their
``augmented_labels.csv`` (numpy on the host); ``overlap-train`` featurizes
single-speaker and overlapped WAVs in one call on the device and trains the
overlap detector, its best checkpoint (by validation accuracy) in
``D/variables.npz``, which ``overlap-run``/``overlap-post --weights``
read.
``--precision``: ``default`` (alias ``auto``) is each model's own default,
``highest`` IEEE fp32 everywhere, ``fast`` TF32 in the models (for
registration, in training too).  ``--device`` defaults to ``cuda``; a run
without a card fails unless it asks for ``--device cpu``.

The live commands capture from the microphone (``pyaudio``) unless given
``--fake``.  ``--edge`` runs the edge variants (``streaming/edge.py``: x4
denoise and the SSIM gate; the gated, pinned-program speaker loop with the
timestamp-free log).  ``--host-preprocess``/``--no-host-preprocess`` force
the host split on or off (default: on exactly when the decision is webrtc
and the native engine builds); it is refused with ``--edge``.
``overlap-run --parity`` holds the compiled (CUDA-graph) predictor against
the eager one on the run's batch.
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


def _matmul_precision(args):
    """``--precision`` -> the predictors' ``matmul_precision``: default ->
    "auto" (overlap TF32, speaker IEEE fp32), highest -> IEEE fp32, fast ->
    TF32 allowed."""
    return {"default": "auto", "auto": "auto", "highest": "highest",
            "fast": None}[args.precision]


def _weights(args):
    """The ``.npz`` of ``--weights`` or of the ``--ckpt`` directory (None
    for random init)."""
    ckpt = getattr(args, "ckpt", None)
    if ckpt and args.weights:
        raise SystemExit(f"{args.cmd}: pass --weights or --ckpt, not both")
    if not ckpt:
        return args.weights
    npz = Path(ckpt) / "variables.npz"
    if not npz.is_file():
        raise SystemExit(f"{args.cmd}: --ckpt {ckpt} holds no variables.npz "
                         f"(a checkpoint directory of the port: "
                         f"overlap-train --out, speaker-pretrain --out, "
                         f"experiment/model, export_serving)")
    return npz


def _overlap_predictor(args, cfg):
    from mmla_audio_torch.inference import OverlapPredictor
    from mmla_audio_torch.models.overlap import OverlapResBLSTM, keras_init_
    from mmla_audio_torch.params import (load_overlap_npz,
                                         overlap_state_dict_from_jax)

    weights = _weights(args)
    if weights:
        state_dict = overlap_state_dict_from_jax(
            load_overlap_npz(weights, cfg.overlap_model), cfg.overlap_model)
        print(f"[INFO] weights: {weights}")
    else:
        state_dict = keras_init_(OverlapResBLSTM(cfg.overlap_model),
                                 torch.Generator().manual_seed(args.seed)
                                 ).state_dict()
        print("[WARN] no --weights: using random-init weights "
              f"(seed {args.seed})")
    return OverlapPredictor(state_dict, cfg.overlap_model,
                            cfg.overlap_feature, device=_device(args),
                            matmul_precision=_matmul_precision(args))


def _speaker_predictor(args, cfg, n_speakers: int | None = None):
    """The speaker model from ``--weights`` (its head as wide as the file's,
    which must equal ``n_speakers`` when a corpus gives one) or random init
    with a head of ``n_speakers`` (None: the 630 of the base model); a
    sigmoid head exactly when ``n_speakers`` is given."""
    from mmla_audio_torch.inference import SpeakerPredictor
    from mmla_audio_torch.models.layers import keras_init_
    from mmla_audio_torch.models.speaker import SpeakerResBLSTM
    from mmla_audio_torch.params import (load_speaker_npz,
                                         speaker_state_dict_from_jax)

    mcfg = cfg.speaker_model
    weights = _weights(args)
    if weights:
        tree, head = load_speaker_npz(weights, mcfg)
        if n_speakers is not None and head != n_speakers:
            raise SystemExit(f"{weights}: the head has {head} units, "
                             f"the enrollment corpus {n_speakers} speakers")
        state_dict = speaker_state_dict_from_jax(tree, mcfg, head)
        print(f"[INFO] weights: {weights}")
    else:
        head = n_speakers
        state_dict = keras_init_(SpeakerResBLSTM(mcfg, head),
                                 torch.Generator().manual_seed(args.seed)
                                 ).state_dict()
        print("[WARN] no --weights: using random-init weights "
              f"(seed {args.seed})")
    return SpeakerPredictor(state_dict, mcfg, cfg.speaker_feature,
                            head_units=head,
                            sigmoid_head=n_speakers is not None,
                            device=_device(args),
                            matmul_precision=_matmul_precision(args))


def cmd_setup(args):
    from mmla_audio_torch.utils.experiment import bootstrap

    dirs = bootstrap(args.root)
    print(f"[INFO] experiment tree ready under {dirs.root}")


def _source(args, cfg):
    """The fake source with ``--fake``, else the microphone."""
    from mmla_audio_torch.streaming.capture import FakePCMSource, PyAudioSource

    if args.fake:
        return FakePCMSource(cfg.audio, seed=args.seed,
                             realtime=args.realtime)
    try:
        return PyAudioSource(cfg.audio)
    except ImportError:
        raise SystemExit(f"{args.cmd}: the microphone needs the pyaudio "
                         f"package, which is not installed; pass --fake") \
            from None


def _session_kw(args) -> dict:
    """The live commands' session options: ``--save-recordings`` and,
    without ``--edge``, the tri-state ``--host-preprocess``."""
    if args.edge and args.host_preprocess:
        raise SystemExit(f"{args.cmd}: --host-preprocess is not supported "
                         f"with --edge (the edge pipeline runs on the "
                         f"session's device; see streaming/edge.py)")
    kw = dict(save_recordings=args.save_recordings)
    if not args.edge:
        kw["host_preprocess"] = "auto" if args.host_preprocess is None \
            else args.host_preprocess
    return kw


def _run_live(args, cfg, make_session, show, prepare=None) -> None:
    """Calibrate, ``prepare(session)`` if given, then run a live session on
    the fake source or the microphone."""
    from mmla_audio_torch.streaming.capture import CaptureThread

    cap = CaptureThread(_source(args, cfg), cfg.audio).start()
    try:
        sess = make_session(cap)
        cal_s = args.calibrate_seconds or cfg.audio.noise_profile_seconds
        print(f"[INFO] calibrating ambient noise ({cal_s:.0f}s)...")
        sess.calibrate(args.calibrate_seconds)
        if prepare is not None:
            prepare(sess)
        print("[INFO] model loaded: start predicting...")
        sess.run(max_windows=args.windows, on_result=show)
    finally:
        cap.stop()
    print(f"[INFO] log: {sess.log.path}")


def cmd_overlap_live(args):
    from mmla_audio_torch.streaming.edge import EdgeOverlapSession
    from mmla_audio_torch.streaming.session import OverlapSession

    kw = _session_kw(args)
    cfg = _cfg(args)
    pred = _overlap_predictor(args, cfg)
    # the edge variant: x4 denoise and the SSIM silence gate
    session_cls = EdgeOverlapSession if args.edge else OverlapSession

    def show(idx, label, prob):
        print(f"[INFO] window {idx}: {label}  (probs {np.round(prob, 3)})")

    _run_live(args, cfg, lambda cap: session_cls(pred, cap, args.root,
                                                 cfg=cfg, **kw), show)


def cmd_speaker_live(args):
    """Identify speakers on the fake source with the base (630-way) model
    or ``--weights``; with ``--register NAME ...``, first enroll each name
    and fine-tune that model on the corpus (`record_on_pc.py` main)."""
    from mmla_audio_torch.streaming.edge import EdgeSpeakerSession
    from mmla_audio_torch.streaming.session import SpeakerSession

    kw = _session_kw(args)
    cfg = _cfg(args)
    pred = _speaker_predictor(args, cfg)
    # the edge variant: gated capture and registration, the identify step
    # as a pinned program, the timestamp-free log
    session_cls = EdgeSpeakerSession if args.edge else SpeakerSession

    def register(sess):
        for name in args.register:
            print(f"[INFO] registering '{name}' "
                  f"({args.enroll_seconds or cfg.audio.enroll_seconds:.0f}s)"
                  f"...")
            sess.register_speaker(name, seconds=args.enroll_seconds)
        override = None
        if args.phase1_epochs is not None or args.phase2_epochs is not None:
            override = (args.phase1_epochs or cfg.transfer.phase1_epochs,
                        args.phase2_epochs if args.phase2_epochs is not None
                        else cfg.transfer.phase2_epochs)
        print(f"[INFO] transfer-learning on the registered corpus "
              f"({sess.device})...")
        t0 = time.perf_counter()
        acc = sess.train_on_registered(pred.model.state_dict(),
                                       epochs_override=override)
        print(f"[TIME] registration training: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        print(f"[INFO] registration accuracy: {acc:.3f}")
        print(f"[INFO] model: {sess.dirs.model / 'variables.npz'}")

    def show(idx, label, prob):
        print(f"[INFO] window {idx}: {label}")

    _run_live(args, cfg, lambda cap: session_cls(pred, cap, args.root,
                                                 cfg=cfg, **kw),
              show, prepare=register if args.register else None)


def cmd_overlap_run(args):
    """Offline WAV file(s) -> one label each (no VAD: the silent gate is the
    raw length), with timings; ``--parity`` holds the predictor compiled
    for the batch's signature (``export.aot_compile``, a CUDA graph on the
    card) against the eager one, argmax per window."""
    from mmla_audio_torch.analyze.logs import OVERLAP_LABELS
    from mmla_audio_torch.data.wavio import read_wav
    from mmla_audio_torch.utils.timers import StageTimer

    if not args.file and not args.dir:
        raise SystemExit("overlap-run: pass -f FILE or --dir DIR")
    cfg = PipelineConfig()
    paths = [Path(args.file)] if args.file else \
        sorted(Path(args.dir).glob("*.wav"))
    if not paths:
        raise SystemExit(f"overlap-run: no .wav files under {args.dir}")
    timer = StageTimer()
    with timer.stage("model_load"):
        pred = _overlap_predictor(args, cfg)

    with timer.stage("wav_load"):
        bufs = np.zeros((len(paths), cfg.audio.window_samples), np.int16)
        counts = np.zeros(len(paths), np.int32)
        for i, p in enumerate(paths):
            sig, _ = read_wav(p)
            k = min(len(sig), bufs.shape[1])
            bufs[i, :k] = sig[:k]
            counts[i] = k

    # the first call also builds the card's kernels and plans (JAX's
    # stage name: its first call compiles)
    for stage in ("predict_compile_and_run", "predict_steady"):
        with timer.stage(stage):
            labels, _ = pred.predict(bufs, counts)
            labels = labels.cpu().numpy()

    if args.parity:
        from mmla_audio_torch.export import aot_compile, parity_check

        operands = (torch.from_numpy(bufs).to(pred.device),
                    torch.from_numpy(counts).to(pred.device))
        with timer.stage("aot_compile"):
            compiled = aot_compile(pred.predict, *operands)
        parity_check(lambda b, n: pred.predict(b, n)[1],
                     lambda b, n: compiled(b, n)[1], operands)
        print("[INFO] AOT parity check passed")

    for p, lab in zip(paths, labels):
        name = "silent" if lab < 0 else OVERLAP_LABELS[str(int(lab))]
        print(f"[RESULT] {p.name}: {name}")
    for stage, s in timer.summary().items():
        print(f"[TIME] {stage}: {s['mean_ms']:.1f} ms")


def cmd_overlap_post(args):
    """Every recording under ``post-time/whole`` -> a TSV log and a chart."""
    from mmla_audio_torch.analyze.post_time import overlap_post_analyze
    from mmla_audio_torch.data.wavio import read_wav
    from mmla_audio_torch.utils.experiment import bootstrap

    cfg = _cfg(args)
    dirs = bootstrap(args.root)
    noise = read_wav(dirs.noise_path)[0] if dirs.noise_path.exists() else None
    pred = _overlap_predictor(args, cfg)
    t0 = time.perf_counter()
    logs = overlap_post_analyze(dirs, pred, cfg=cfg, noise=noise)
    print(f"[TIME] overlap-post: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for name, log in logs.items():
        print(f"[INFO] {name}: {log}")


def cmd_speaker_post(args):
    """Every recording under ``post-time/whole`` -> a speaker TSV log and a
    chart; the head's width is the enrollment corpus's size."""
    from mmla_audio_torch.analyze.post_time import speaker_post_analyze
    from mmla_audio_torch.data.wavio import read_wav
    from mmla_audio_torch.utils.experiment import bootstrap

    cfg = _cfg(args)
    dirs = bootstrap(args.root)
    noise = read_wav(dirs.noise_path)[0] if dirs.noise_path.exists() else None
    n_speakers = len(list(dirs.corpus.glob("*.wav"))) or None
    pred = _speaker_predictor(args, cfg, n_speakers)
    t0 = time.perf_counter()
    logs = speaker_post_analyze(dirs, pred, cfg=cfg, noise=noise)
    print(f"[TIME] speaker-post: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for name, log in logs.items():
        print(f"[INFO] {name}: {log}")


def cmd_speaker_pretrain(args):
    """Base speaker model pretrain (TIMIT layout or a flat directory):
    RMSprop 1e-4, batch 32, early stopping on the loss of the training set
    itself (``x_val = x``, as the JAX CLI), Keras init from ``--seed``;
    writes ``--out/variables.npz`` and ``metadata.json``."""
    from mmla_audio_torch.data.corpus import featurize_clips
    from mmla_audio_torch.data.timit import TimitCatalog
    from mmla_audio_torch.models.layers import keras_init_
    from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
    from mmla_audio_torch.train.checkpoints import save_variables
    from mmla_audio_torch.train.losses import keras_categorical_crossentropy
    from mmla_audio_torch.train.optimizers import rmsprop
    from mmla_audio_torch.train.trainer import Trainer

    cfg = PipelineConfig()
    mcfg, tcfg = cfg.speaker_model, cfg.speaker_train
    device = _device(args)
    catalog = TimitCatalog.from_flat_dir(args.wav_dir) if not args.labels_csv \
        else TimitCatalog.from_labels_csv(args.labels_csv, args.wav_dir)
    clips, labels = [], []
    for sid, sig, _ in catalog.iter_clips():
        clips.append(sig)
        labels.append(sid)
    if not clips:
        raise SystemExit(f"speaker-pretrain: no clips under {args.wav_dir}")
    x, y, sid_dict = featurize_clips(clips, labels, dim=mcfg.num_speakers,
                                     cfg=cfg.speaker_feature, device=device)
    model = keras_init_(SpeakerResBLSTM(mcfg),
                        torch.Generator().manual_seed(args.seed))
    trainer = Trainer(model, rmsprop(tcfg.lr), keras_categorical_crossentropy,
                      extra_penalty_fn=lambda m: l2_penalty(m, mcfg),
                      device=device, seed=args.seed)
    t0 = time.perf_counter()
    trainer.fit(x, y, epochs=args.epochs or tcfg.epochs,
                batch_size=tcfg.batch_size,
                early_stop_patience=tcfg.early_stop_patience,
                x_val=x, y_val=y, verbose=True)
    print(f"[TIME] speaker-pretrain: {(time.perf_counter() - t0) * 1e3:.1f} "
          f"ms ({len(clips)} clips, {len(sid_dict)} speakers)")
    save_variables(args.out, trainer.variables_of(), mcfg, None,
                   {"speakers": sid_dict})
    print(f"[INFO] saved base model to {Path(args.out) / 'variables.npz'}")


def cmd_synth_corpus(args):
    """Mix the clips of a TIMIT layout or a flat ``<speaker>_<clip>.wav``
    directory into ``--n-mixtures`` overlapped windows and their labels
    CSV."""
    import csv

    from mmla_audio_torch.data.synth import synthesize_corpus
    from mmla_audio_torch.data.timit import TimitCatalog

    catalog = TimitCatalog.from_flat_dir(args.wav_dir) if not args.labels_csv \
        else TimitCatalog.from_labels_csv(args.labels_csv, args.wav_dir)
    if not catalog.n_speakers:
        raise SystemExit(f"synth-corpus: no clips under {args.wav_dir}")
    t0 = time.perf_counter()
    plan = synthesize_corpus(
        catalog.clip_loader, n_mixtures=args.n_mixtures,
        n_speakers=catalog.n_speakers, out_dir=args.out_dir, seed=args.seed)
    with open(Path(args.out_dir) / "augmented_labels.csv", "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "speaker_ids", "overlap_degree"])
        for e in plan:
            w.writerow([e.index, "_".join(e.speaker_ids), e.label])
    print(f"[TIME] synth-corpus: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    print(f"[INFO] wrote {len(plan)} mixtures to {args.out_dir}")


def cmd_overlap_train(args):
    """Train the overlap detector from WAV directories (singles label 0,
    mixtures label 1): the first 1.5 s of each file (``sig[:24000] /
    32768``, zero-padded; no denoise, no VAD) featurized in one call on the
    device, where the corpus stays; the stratified split, weighted CCE,
    Adadelta under the cosine lr; prints the test split's accuracy and
    confusion matrix."""
    from mmla_audio_torch.data.wavio import read_wav
    from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
    from mmla_audio_torch.train.overlap_trainer import OverlapTrainer

    cfg = PipelineConfig()
    device = _device(args)
    n = cfg.overlap_feature.n_samples
    sigs, labels = [], []
    for label, d in ((0, args.single_dir), (1, args.overlap_dir)):
        for p in sorted(Path(d).glob("*.wav")):
            sigs.append(read_wav(p)[0][:n])
            labels.append(label)
    if not sigs:
        raise SystemExit("overlap-train: no .wav files under "
                         f"{args.single_dir} or {args.overlap_dir}")
    buf = np.zeros((len(sigs), n), np.float32)
    for i, sig in enumerate(sigs):
        buf[i, :len(sig)] = sig.astype(np.float32) / 32768.0
    t0 = time.perf_counter()
    feats = overlap_model_input_cuda(torch.from_numpy(buf).to(device),
                                     cfg.overlap_feature)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[TIME] featurize: {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"({len(sigs)} windows)")
    y = np.eye(2, dtype=np.float32)[labels]
    trainer = OverlapTrainer(cfg.overlap_model, dataclasses.replace(
        cfg.overlap_train, epochs=args.epochs, batch_size=args.batch_size),
        device=device)
    t0 = time.perf_counter()
    state, _, (x_test, y_test) = trainer.train(
        feats, y, weighted=True, augmented=args.augmented,
        checkpoint_dir=args.out, seed=args.seed, verbose=True)
    print(f"[TIME] overlap-train: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    ev = trainer.evaluation(state, x_test, y_test)
    print(f"[RESULT] test accuracy: {ev['accuracy']:.4f}")
    print(f"[RESULT] confusion:\n{ev['confusion']}")
    if args.out:
        print(f"[INFO] best checkpoint at {args.out}")


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
        p.add_argument("--precision",
                       choices=["default", "highest", "fast", "auto"],
                       default="default",
                       help="model convs/LSTM/GEMMs on the card: 'default' "
                            "(alias 'auto') each model's own (overlap TF32, "
                            "speaker IEEE fp32), 'highest' IEEE fp32, "
                            "'fast' TF32")
        p.add_argument("--weights", default=None, metavar="PATH.npz",
                       help="model weights as the flat .npz of params.py "
                            "(default: random init from --seed)")
        p.add_argument("--ckpt", default=None, metavar="DIR",
                       help="a checkpoint directory of the port (its "
                            "variables.npz), instead of --weights")

    p = sub.add_parser("setup")
    p.add_argument("--root", default="experiment")
    p.set_defaults(fn=cmd_setup)

    def vad(p):
        p.add_argument("--vad", choices=["energy", "webrtc"], default=None,
                       help="per-frame VAD decision (default webrtc, the "
                            "bit-exact native engine)")

    def live(p):
        common(p)
        vad(p)
        p.add_argument("--root", default="experiment")
        p.add_argument("--fake", action="store_true",
                       help="deterministic PCM source instead of a "
                            "microphone")
        p.add_argument("--realtime", action="store_true")
        p.add_argument("--windows", type=int, default=None)
        p.add_argument("--calibrate-seconds", type=float, default=None)
        p.add_argument("--save-recordings", action="store_true")
        p.add_argument("--host-preprocess", dest="host_preprocess",
                       action="store_true", default=None,
                       help="force the host split: denoise, webrtc VAD and "
                            "trim on the CPU, only the trimmed window to "
                            "the device (default: off on a CUDA card, "
                            "else on when the decision is webrtc and the "
                            "native engine builds); --no-host-preprocess "
                            "keeps the chain on the device")
        p.add_argument("--no-host-preprocess", dest="host_preprocess",
                       action="store_false", help=argparse.SUPPRESS)

    p = sub.add_parser("overlap-live")
    live(p)
    p.add_argument("--edge", action="store_true",
                   help="edge variant: x4 denoise and the SSIM silence gate")
    p.set_defaults(fn=cmd_overlap_live)

    p = sub.add_parser("speaker-live")
    live(p)
    p.add_argument("--register", nargs="*", default=None, metavar="NAME",
                   help="enroll each name from the source, then fine-tune "
                        "the model on the corpus before identifying")
    p.add_argument("--enroll-seconds", type=float, default=None)
    p.add_argument("--phase1-epochs", type=int, default=None)
    p.add_argument("--phase2-epochs", type=int, default=None)
    p.add_argument("--edge", action="store_true",
                   help="edge variant: gated capture, the identify step as "
                        "a pinned program, timestamp-free log")
    p.set_defaults(fn=cmd_speaker_live)

    p = sub.add_parser("overlap-run")
    common(p)
    p.add_argument("--root", default="experiment",
                   help="accepted as the JAX CLI does; unused")
    p.add_argument("-f", "--file", default=None)
    p.add_argument("-dir", "--dir", default=None)
    p.add_argument("--parity", action="store_true",
                   help="hold the compiled predictor (a CUDA graph on the "
                        "card) against the eager one, argmax per window")
    p.set_defaults(fn=cmd_overlap_run)

    for name, fn in (("overlap-post", cmd_overlap_post),
                     ("speaker-post", cmd_speaker_post)):
        p = sub.add_parser(name)
        common(p)
        vad(p)
        p.add_argument("--root", default="experiment")
        p.set_defaults(fn=fn)

    p = sub.add_parser("speaker-pretrain")
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--labels-csv", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu to run "
                        "without a card)")
    p.set_defaults(fn=cmd_speaker_pretrain)

    p = sub.add_parser("synth-corpus")
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--labels-csv", default=None)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-mixtures", type=int, default=6300)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth_corpus)

    p = sub.add_parser("overlap-train")
    p.add_argument("--single-dir", required=True)
    p.add_argument("--overlap-dir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--augmented", action="store_true")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the Keras init, the permutations and the "
                        "dropout masks")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu to run "
                        "without a card)")
    p.set_defaults(fn=cmd_overlap_train)

    p = sub.add_parser("charts")
    p.add_argument("--root", default="experiment")
    p.add_argument("--kind", default="overlap", choices=["overlap", "speaker"])
    p.set_defaults(fn=cmd_charts)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
