"""Post-time (offline) overlap pipeline over whole conversation recordings
(counterpart of the overlap half of ``mmla_audio_tpu.analyze.post_time``).

Reference behavior (`overlap_detection_post_processing.py:151-226`): every
file under ``experiment/recordings/post-time/whole`` is standardized
(``zoom*``: 0 denoise passes, ``audio*``: 3), cut into back-to-back 1.5 s
segments, featurized, predicted, logged (segment index from 0, +1.5 s
synthetic timestamps, first write truncates) and charted.  No silent gate
here.

Every per-segment disk round-trip of the reference becomes one
``predictor.predict`` call per conversation: all its windows in one batch,
on the predictor's device (the grouped featurizer kernel and the fused
residual blocks on the card).
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Dict

import numpy as np

from mmla_audio_torch.analyze.charts import visualize_log
from mmla_audio_torch.analyze.logs import OVERLAP_LABELS, SessionLog
from mmla_audio_torch.core.config import PipelineConfig
from mmla_audio_torch.data.standardize import segment_signal, standardize_audio
from mmla_audio_torch.data.wavio import read_wav, write_wav
from mmla_audio_torch.utils.experiment import ExperimentDirs

__all__ = ["overlap_post_analyze"]

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
