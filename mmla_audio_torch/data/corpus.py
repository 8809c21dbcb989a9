"""Enrolled-corpus featurization (counterpart of
``mmla_audio_tpu.data.corpus``; `make_feature_experiment`,
`speaker_identification.py:317-369`).

Each ``experiment/corpus/<name>.wav`` (a VAD-trimmed ~60 s enrollment clip)
is featurized in one MFCC pass and sliced into ``ceil(T / 256)`` windows of
(256, 39), zero-padded at the tail; every window carries the speaker's
one-hot label.  Label indices follow first appearance over the sorted file
list (the reference's ``binarizer``), and ``speaker_id_dict`` maps
``str(index) -> name``.  ``featurize_clips`` is ``make_feature_timit``:
one 256-frame window per clip, for base training.

The JAX package zero-pads each clip to a 5 s bucket only to bound its
compiles, then keeps the valid frames; here the MFCC runs on the clip
itself (``clip_mfcc39``), which gives the same psf values.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from mmla_audio_torch.core.config import SpeakerFeatureConfig
from mmla_audio_torch.data.wavio import read_wav
from mmla_audio_torch.ops.mfcc import mfcc39

__all__ = ["clip_mfcc39", "featurize_corpus", "featurize_clips",
           "one_hot_first_appearance"]


def clip_mfcc39(sig, cfg: SpeakerFeatureConfig,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """MFCC-39 of a whole int16 clip (numpy or tensor) with ``cfg``'s psf
    parameters, on ``device``: ``(T, 39)``, the deltas' edges at the clip's
    last frame."""
    return mfcc39(torch.as_tensor(sig).to(device, torch.float32),
                  sample_rate=cfg.sample_rate, n_fft=cfg.n_fft,
                  n_filt=cfg.n_filt, n_cep=cfg.n_cep, preemph=cfg.preemph,
                  ceplifter=cfg.ceplifter, append_energy=cfg.append_energy,
                  win_length=cfg.win_length, hop_length=cfg.hop_length,
                  delta_n=cfg.delta_n)


def one_hot_first_appearance(labels: Sequence[str], dim: int | None = None
                             ) -> Tuple[np.ndarray, Dict[str, str]]:
    """binarizer semantics (speaker_identification.py:121-138): class index =
    first-appearance order.  Returns (one-hot (N, dim), {index: label})."""
    index: Dict[str, int] = {}
    for lab in labels:
        if lab not in index:
            index[lab] = len(index)
    dim = dim or len(index)
    y = np.zeros((len(labels), dim), np.float32)
    for i, lab in enumerate(labels):
        y[i, index[lab]] = 1.0
    id_dict = {str(v): k for k, v in index.items()}
    return y, id_dict


def featurize_corpus(corpus_dir,
                     cfg: SpeakerFeatureConfig = SpeakerFeatureConfig(),
                     min_samples: int = 0,
                     device: torch.device | str = "cuda"
                     ) -> Tuple[np.ndarray, np.ndarray, Dict[str, str]]:
    """-> (x (N, 256, 39), y one-hot (N, n_speakers), speaker_id_dict), the
    MFCCs computed on ``device``.

    ``min_samples``: skip clips shorter than this (the reference's
    ``get_wav_files`` drops corpus files under 240,000 bytes, ~7.5 s,
    `speaker_identification.py:56-66`, i.e. ``min_samples=120_000``); the
    default 0 keeps every enrollment.  A clip at another sample rate
    raises: resample it first (``data.standardize``)."""
    xs: List[np.ndarray] = []
    labels: List[str] = []
    for path in sorted(Path(corpus_dir).glob("*.wav")):
        sig, rate = read_wav(path)
        if rate != cfg.sample_rate:
            raise ValueError(
                f"{path}: sample rate {rate} != configured "
                f"{cfg.sample_rate}; run standardize_audio first")
        if len(sig) < min_samples:
            continue
        feats = clip_mfcc39(sig, cfg, device)
        n_slices = -(-feats.shape[0] // cfg.max_frames)
        feats = torch.nn.functional.pad(
            feats, (0, 0, 0, n_slices * cfg.max_frames - feats.shape[0]))
        xs.extend(feats.reshape(n_slices, cfg.max_frames, -1).cpu().numpy())
        labels.extend([path.stem] * n_slices)
    if not xs:
        raise ValueError(f"no wav files in {corpus_dir}")
    y, id_dict = one_hot_first_appearance(labels)
    return np.stack(xs), y, id_dict


def featurize_clips(clips: Sequence[np.ndarray], labels: Sequence[str],
                    dim: int | None = None,
                    cfg: SpeakerFeatureConfig = SpeakerFeatureConfig(),
                    device: torch.device | str = "cuda"
                    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, str]]:
    """make_feature_timit: one (256, 39) window per clip (truncated or
    zero-padded).  Clips must already be at ``cfg.sample_rate``."""
    xs = []
    for sig in clips:
        feats = clip_mfcc39(sig, cfg, device)[: cfg.max_frames]
        feats = torch.nn.functional.pad(
            feats, (0, 0, 0, cfg.max_frames - feats.shape[0]))
        xs.append(feats.cpu().numpy())
    y, id_dict = one_hot_first_appearance(labels, dim)
    return np.stack(xs), y, id_dict
