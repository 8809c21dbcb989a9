"""Post-time (offline) pipelines over whole conversation recordings
(counterpart of ``mmla_audio_tpu.analyze.post_time``).

Overlap (`overlap_detection_post_processing.py:151-226`): every file under
``experiment/recordings/post-time/whole`` is standardized (``zoom*``: 0
denoise passes, ``audio*``: 3), cut into back-to-back 1.5 s segments,
featurized, predicted, logged (segment index from 0, +1.5 s synthetic
timestamps, first write truncates) and charted.  No silent gate here.
Every per-segment disk round-trip of the reference becomes one
``predictor.predict`` call per conversation: all its windows in one batch,
on the predictor's device (on the card the featurizer kernel, one window a
CTA, and the fused residual blocks).

Speaker (`speaker_identification_post_processing.py:191-354`): the
standardized conversation is cut into 2.56 s segments whose VAD-trimmed
length marks them ``silent``; one webrtc detector serves the whole run, fed
every segment of every file in order, like the reference's module-level
``Vad(3)``.  The WHOLE standardized file is featurized in one MFCC pass
(deltas edged at the file's last frame) and sliced into ceil(T/256)
windows, which the model predicts in one batch.  The silent set covers only
the whole segments, so the last partial slice is never gated (kept as the
reference does).  Timestamps advance +2.56 s BEFORE every row, the first
included; the log is overwritten.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from mmla_audio_torch.analyze.charts import visualize_log
from mmla_audio_torch.analyze.logs import OVERLAP_LABELS, SessionLog
from mmla_audio_torch.core.config import PipelineConfig
from mmla_audio_torch.data.corpus import clip_mfcc39
from mmla_audio_torch.data.standardize import segment_signal, standardize_audio
from mmla_audio_torch.data.wavio import read_wav, write_wav
from mmla_audio_torch.utils.experiment import ExperimentDirs
from mmla_audio_torch.vad.collector import (calibrate_threshold, collect_mask,
                                            energy_vad, frame_count)

__all__ = ["overlap_post_analyze", "speaker_post_analyze",
           "speaker_id_dict_from_corpus", "whole_file_mfcc39"]

WINDOW_SECONDS = 1.5     # post-time segment length and stride


def _standardize_file(path: Path, dirs: ExperimentDirs, noise,
                      passes_audio: int, cfg: PipelineConfig,
                      device) -> Path:
    sig, sr = read_wav(path)
    passes = 0 if path.name.startswith("zoom") else passes_audio
    out = standardize_audio(sig, sr, target_sr=cfg.audio.sample_rate,
                            noise=noise, noise_passes=passes,
                            denoise_cfg=cfg.denoise, vad_cfg=cfg.vad,
                            device=device)
    dst = dirs.post_standardized / (path.stem + ".wav")
    write_wav(dst, out, cfg.audio.sample_rate)
    return dst


def overlap_post_analyze(dirs: ExperimentDirs, predictor, *,
                         cfg: PipelineConfig = PipelineConfig(),
                         noise: np.ndarray | None = None,
                         start_time: datetime | None = None,
                         make_charts: bool = True) -> Dict[str, Path]:
    """Run the overlap post-time pipeline over ``post-time/whole``.

    ``predictor``: OverlapPredictor; the denoise runs on its device.
    Returns {conversation: log_path}.
    """
    logs = {}
    win = WINDOW_SECONDS
    sr = cfg.audio.sample_rate
    for f in sorted(dirs.post_whole.glob("*.wav")):
        std = _standardize_file(f, dirs, noise, cfg.denoise.passes_post, cfg,
                                predictor.device)
        sig, _ = read_wav(std)
        segs = segment_signal(sig, sr, win, win)             # (N, 24000)
        log_path = dirs.logs / (f.stem + ".txt")
        # the first write truncates, like the reference's open(..., 'w')
        # (`overlap_detection_post_processing.py:214`)
        log = SessionLog(log_path, kind="overlap", start_index=0,
                         overwrite=True)
        log.ensure_header()
        t0 = start_time or datetime.today()
        if len(segs):
            n = np.full((segs.shape[0],), segs.shape[1], np.int32)
            labels, _ = predictor.predict(segs.astype(np.int16), n)
            names = [OVERLAP_LABELS.get(str(int(lab)), "silent")
                     for lab in labels.cpu().tolist()]
            log.append_batch(names, t0, win)
        logs[f.stem] = log_path
        if make_charts:
            visualize_log(log_path, dirs.charts, kind="overlap")
    return logs


def speaker_id_dict_from_corpus(corpus_dir) -> Dict[str, str]:
    """speaker_id_dict rebuilt from the enrollment file names, in sorted
    order (`speaker_identification_post_processing.py:193-197`)."""
    files = sorted(p.name for p in Path(corpus_dir).glob("*.wav"))
    return {str(i): name[:-4] for i, name in enumerate(files)}


def _kept_frames(segs: np.ndarray, cfg: PipelineConfig, frame_len: int,
                 vad, vad_thr: float) -> list:
    """Frames the collector keeps in each segment ``(N, n)``: the run's
    native webrtc detector fed each segment in order, or the energy
    detector at ``vad_thr``."""
    T = frame_count(segs.shape[1], frame_len)
    frames = segs[:, : T * frame_len]
    if vad is not None:
        decisions = [vad.decisions(seg, frame_len, cfg.audio.sample_rate)
                     for seg in frames]
    else:
        decisions = energy_vad(torch.from_numpy(
            frames.astype(np.float32).reshape(len(segs), T, frame_len)),
            vad_thr)
    return [int(collect_mask(d, ring=cfg.vad.ring_frames).sum())
            for d in decisions]


def whole_file_mfcc39(sig, cfg: PipelineConfig, device) -> torch.Tensor:
    """MFCC-39 of a whole int16 recording (numpy or tensor) on ``device``:
    ``(T, 39)``, the deltas' edges at its last frame."""
    return clip_mfcc39(sig, cfg.speaker_feature, device)


def speaker_post_analyze(dirs: ExperimentDirs, predictor, *,
                         cfg: PipelineConfig = PipelineConfig(),
                         noise: np.ndarray | None = None,
                         speaker_id_dict: Dict[str, str] | None = None,
                         start_time: datetime | None = None,
                         make_charts: bool = True) -> Dict[str, Path]:
    """Run the speaker post-time pipeline over ``post-time/whole``.

    ``predictor``: SpeakerPredictor (the transfer-learned head for an
    enrolled corpus); the denoise and the MFCC run on its device.
    ``speaker_id_dict``: label -> name (default: the corpus file names).
    Returns {conversation: log_path}.
    """
    if speaker_id_dict is None:
        speaker_id_dict = speaker_id_dict_from_corpus(dirs.corpus)
    logs = {}
    sr = cfg.audio.sample_rate
    win_s = cfg.audio.window_seconds                        # 2.56
    fc = cfg.speaker_feature
    # without an ambient profile, the live sessions' 30 dB floor: a
    # threshold calibrated on silence would never gate
    vad_thr = (calibrate_threshold(noise, cfg.vad.aggressiveness)
               if noise is not None else 30.0)
    frame_len = int(sr * cfg.vad.frame_ms / 1000)
    vad = None
    if cfg.vad.decision == "webrtc":
        from mmla_audio_torch.vad.native import NativeWebRtcVad

        vad = NativeWebRtcVad(cfg.vad.aggressiveness)
    for f in sorted(dirs.post_whole.glob("*.wav")):
        std = _standardize_file(f, dirs, noise, cfg.denoise.passes_post, cfg,
                                predictor.device)
        sig, _ = read_wav(std)
        segs = segment_signal(sig, sr, win_s, win_s)
        silent = set()
        if len(segs) and frame_count(segs.shape[1], frame_len) > 0:
            kept = _kept_frames(segs, cfg, frame_len, vad, vad_thr)
            silent = {i for i, k in enumerate(kept)
                      if k * frame_len < fc.silent_samples}
        elif len(segs):
            silent = set(range(len(segs)))

        feats = whole_file_mfcc39(sig, cfg, predictor.device)
        T = feats.shape[0]
        n_slices = -(-T // fc.max_frames)
        feats = torch.nn.functional.pad(
            feats, (0, 0, 0, n_slices * fc.max_frames - T))
        logits = predictor.logits_from_features(
            feats.reshape(n_slices, fc.max_frames, feats.shape[-1]))
        pred_idx = torch.argmax(logits, dim=-1).cpu().tolist()

        log_path = dirs.logs / (f.stem + ".txt")
        log = SessionLog(log_path, kind="speaker", start_index=0,
                         overwrite=True)
        log.ensure_header()
        t = start_time or datetime.today()
        for i, idx in enumerate(pred_idx):
            t = t + timedelta(seconds=win_s)                # before the row
            name = "silent" if i in silent else \
                speaker_id_dict.get(str(idx), str(idx))
            log.append(name, t)
        logs[f.stem] = log_path
        if make_charts:
            visualize_log(log_path, dirs.charts, kind="speaker")
    return logs
