"""TIMIT corpus ingest (counterpart of ``mmla_audio_tpu.data.timit``,
numpy only).

The reference reads TIMIT from a Kaggle-style layout: a ``labels.csv`` with
``speaker_id`` and ``path_from_data_dir_windows`` columns next to a ``data/``
tree of per-speaker WAVs (`data_augmentation.py:14-17, 41`;
`speaker_identification.py:264-282`).  ``TimitCatalog`` abstracts that layout
(and any directory of ``<speaker>_<clip>.wav`` files) into the
``clip_loader(speaker, sample)`` interface the synthesizer and base trainer
consume.  The actual corpus is not shipped here; tests drive the interface
with generated fixtures.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from mmla_audio_torch.data.wavio import read_wav

__all__ = ["TimitCatalog"]


class TimitCatalog:
    def __init__(self, entries: List[Tuple[str, Path]]):
        """entries: [(speaker_id, wav_path)] in catalog order."""
        self.entries = entries
        self.by_speaker: Dict[str, List[Path]] = {}
        for sid, p in entries:
            self.by_speaker.setdefault(sid, []).append(p)
        self.speakers = sorted(self.by_speaker)

    @classmethod
    def from_labels_csv(cls, labels_csv, data_dir) -> "TimitCatalog":
        """Kaggle TIMIT layout (the reference's labels.csv)."""
        data_dir = Path(data_dir)
        entries = []
        with open(labels_csv) as f:
            for row in csv.DictReader(f):
                rel = row.get("path_from_data_dir") or \
                    row.get("path_from_data_dir_windows", "").replace("\\", "/")
                if not rel:
                    continue
                conv = row.get("is_converted_audio", "").strip().upper()
                if conv:
                    # Kaggle CSV marks RIFF conversions; the NIST-sphere
                    # originals (plain .WAV) are unreadable by wave.open
                    if conv != "TRUE" or not rel.upper().endswith(".WAV"):
                        continue
                else:
                    if not rel.lower().endswith(".wav"):
                        continue
                    if rel.endswith(".WAV") and not rel.endswith(".wav"):
                        # exact-case .WAV without the .wav re-extension is a
                        # NIST sphere original in the Kaggle tree — it would
                        # crash wave.open and double every utterance
                        continue
                entries.append((row["speaker_id"], data_dir / rel))
        return cls(entries)

    @classmethod
    def from_flat_dir(cls, wav_dir) -> "TimitCatalog":
        """Directory of ``<speaker>_<clip>.wav`` files."""
        entries = []
        for p in sorted(Path(wav_dir).glob("*.wav")):
            sid = p.stem.split("_")[0]
            entries.append((sid, p))
        return cls(entries)

    @property
    def n_speakers(self) -> int:
        return len(self.speakers)

    def clip_loader(self, speaker_index: int, sample_index: int
                    ) -> Tuple[np.ndarray, str]:
        """The synth.synthesize_corpus interface: (int16 samples, speaker)."""
        sid = self.speakers[speaker_index % len(self.speakers)]
        paths = self.by_speaker[sid]
        sig, _ = read_wav(paths[sample_index % len(paths)])
        return sig, sid

    def statistics(self) -> Dict[str, int]:
        """Clips per speaker (`speaker_identification.py:154-165`)."""
        return {sid: len(paths) for sid, paths in self.by_speaker.items()}

    def iter_clips(self):
        for sid, path in self.entries:
            sig, sr = read_wav(path)
            yield sid, sig, sr
