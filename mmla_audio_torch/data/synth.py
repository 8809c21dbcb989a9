"""Overlap-corpus synthesis (counterpart of ``mmla_audio_tpu.data.synth``;
reference `data_augmentation.py` semantics).

Builds the overlap-detector training corpus from single-speaker clips:
6,300 synthetic mixtures — i < 3150: 2 simultaneous speakers, < 5040: 3,
< 5985: 4, else 5 — by overlaying clips at random 100 ms-grid offsets onto a
<=1.5 s canvas (`generate_overlap_segment`, :20-34), labeled ``2`` =
overlapped vs ``1`` = single-speaker (`run_overlap_features_generator`,
:91-92).

pydub ``overlay`` semantics: the overlay is added sample-wise into the canvas
starting at ``position`` and truncated at the canvas end; int16 saturation.
Mixing is NumPy on the host with the JAX package's ``RandomState`` draw
order, so both packages build the same corpus from the same clips and
seed; featurizing it is one batched call on the card.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, List, Sequence

import numpy as np

from mmla_audio_torch.data.wavio import write_wav

__all__ = ["MixturePlanEntry", "speaker_count_for_index", "overlay",
           "make_mixture", "synthesize_corpus"]


def speaker_count_for_index(i: int, n_mixtures: int = 6300) -> int:
    """data_augmentation.py:45-52: absolute thresholds 3150/5040/5985 at the
    reference's 6300 mixtures = a 50%/30%/15%/5% schedule.  For other corpus
    sizes the proportions scale (absolute thresholds would make e.g. a
    1000-mixture corpus ALL 2-speaker, silently dropping the 3-5-speaker
    cases the detector must learn)."""
    if n_mixtures == 6300:
        t2, t3, t4 = 3150, 5040, 5985
    else:
        t2 = round(n_mixtures * 0.50)
        t3 = round(n_mixtures * 0.80)
        t4 = round(n_mixtures * 0.95)
    if i < t2:
        return 2
    if i < t3:
        return 3
    if i < t4:
        return 4
    return 5


def overlay(canvas: np.ndarray, sound: np.ndarray, position: int) -> np.ndarray:
    """pydub AudioSegment.overlay: add ``sound`` into ``canvas`` at sample
    ``position``; excess truncated; int16 saturation."""
    out = canvas.astype(np.int32).copy()
    room = len(canvas) - position
    if room <= 0:
        return canvas
    seg = sound[:room].astype(np.int32)
    out[position: position + len(seg)] += seg
    return np.clip(out, -32768, 32767).astype(np.int16)


def make_mixture(clips: Sequence[np.ndarray], rng: np.random.RandomState,
                 sr: int = 16_000, canvas_seconds: float = 1.5) -> np.ndarray:
    """generate_overlap_segment: canvas = clip0 truncated to <=1.5 s; each
    further clip overlaid at ``randrange(duration_ds - 2) * 0.1 s``."""
    canvas = np.asarray(clips[0], np.int16)
    dur = min(canvas_seconds, len(canvas) / sr)
    canvas = canvas[: int(dur * sr)]
    for clip in clips[1:]:
        hi = int(dur * 10) - 2
        index_ms = (rng.randint(0, max(hi, 1))) * 100
        canvas = overlay(canvas, np.asarray(clip, np.int16),
                         int(index_ms * sr / 1000))
    return canvas


@dataclasses.dataclass
class MixturePlanEntry:
    index: int
    speaker_ids: List[str]
    label: int                      # 2 = overlapped (1 = single-speaker)


def synthesize_corpus(clip_loader: Callable[[int, int], tuple[np.ndarray, str]],
                      n_mixtures: int = 6300, n_speakers: int = 630,
                      clips_per_speaker: int = 10, seed: int = 0,
                      sr: int = 16_000,
                      out_dir=None,
                      sink: Callable[[int, np.ndarray], None] | None = None
                      ) -> List[MixturePlanEntry]:
    """Build the mixture corpus.  ``clip_loader(speaker, sample) -> (int16
    samples, speaker_id)`` abstracts the TIMIT layout.  If ``out_dir`` is
    set, mixtures are written as ``Overlap<i>.wav``; ``sink(i, mixture)``
    receives each mixture in memory (device featurization pipelines skip the
    12,600-file round trip the reference pays).  Returns the plan (speaker
    ids + label per mixture) for the labels CSV."""
    rng = np.random.RandomState(seed)
    plan = []
    for i in range(n_mixtures):
        k = speaker_count_for_index(i, n_mixtures)
        clips, ids = [], []
        for _ in range(k):
            sp = rng.randint(0, n_speakers)
            sm = rng.randint(0, clips_per_speaker)
            clip, sid = clip_loader(sp, sm)
            clips.append(clip)
            ids.append(sid)
        mix = make_mixture(clips, rng, sr)
        if out_dir is not None:
            write_wav(Path(out_dir) / f"Overlap{i}.wav", mix, sr)
        if sink is not None:
            sink(i, mix)
        plan.append(MixturePlanEntry(i, ids, 2))
    return plan
