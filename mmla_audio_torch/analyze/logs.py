"""Session TSV logs (counterpart of ``mmla_audio_tpu.analyze.logs``); the
bytes written equal the JAX package's.

Header, written with the first row:
  overlap:  ``segment\\toverlapped degree\\ttimestamp``  (record_on_pc.py:146-152)
  speaker:  ``segment\\tspeaker\\ttimestamp``            (SI record_on_pc.py:126-131)
Rows: ``<index>\\t<label>\\t<str(datetime)>``.  Live loops start at segment 1
and stamp ``datetime.today()`` per row; post-time loops start at 0 and add a
fixed ``timedelta`` per segment (`overlap_detection_post_processing.py:211-226`).
``timestamps=False`` writes the edge speaker runner's schema: a
``segment\\tspeaker`` header and rows without a timestamp column
(`SpeakerIdentification/scripts/record_on_pi.py:226-251`).
"""

from __future__ import annotations

from datetime import datetime, timedelta
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

__all__ = ["OVERLAP_HEADER", "SPEAKER_HEADER", "OVERLAP_LABELS", "SessionLog",
           "parse_log"]

OVERLAP_HEADER = "segment\toverlapped degree\ttimestamp"
SPEAKER_HEADER = "segment\tspeaker\ttimestamp"

OVERLAP_LABELS = {"0": "non-overlapped", "1": "overlapped"}


class SessionLog:
    """Append-only TSV log; each write is flushed as it is made."""

    def __init__(self, path, kind: str = "overlap", start_index: int = 1,
                 overwrite: bool = False, timestamps: bool = True):
        if kind not in ("overlap", "speaker"):
            raise ValueError(f"SessionLog kind must be 'overlap' or "
                             f"'speaker': {kind!r}")
        self.path = Path(path)
        self.timestamps = timestamps
        self.header = OVERLAP_HEADER if kind == "overlap" else SPEAKER_HEADER
        if not timestamps:
            self.header = self.header.rsplit("\t", 1)[0]
        self.index = start_index
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if overwrite and self.path.exists():
            self.path.unlink()
        # appending to an existing non-empty log must not repeat the header
        self._wrote_header = self.path.exists() and self.path.stat().st_size > 0

    @classmethod
    def resume(cls, path, kind: str = "overlap") -> "SessionLog":
        """Continue an interrupted session's log from its last segment
        index."""
        log = cls(path, kind=kind)
        if log.path.exists():
            rows = parse_log(log.path)
            if rows:
                log.index = rows[-1][0] + 1
        return log

    def _write(self, rows: Iterable[Tuple[str, datetime]]) -> None:
        with open(self.path, "a") as f:
            if not self._wrote_header:
                f.write(self.header + "\n")
                self._wrote_header = True
            for label, ts in rows:
                f.write(f"{self.index}\t{label}\t{ts}\n" if self.timestamps
                        else f"{self.index}\t{label}\n")
                self.index += 1

    def ensure_header(self) -> None:
        """Create the file with its header even when no rows follow, so an
        empty conversation still yields a parseable log."""
        self._write(())

    def append(self, label: str, timestamp: Optional[datetime] = None) -> int:
        self._write([(label, timestamp if timestamp is not None
                      else datetime.today())])
        return self.index - 1

    def append_batch(self, labels: Iterable[str], start_time: datetime,
                     step_seconds: float) -> None:
        """Post-time convention: synthetic timestamps advancing by the window
        stride per segment."""
        self._write((label, start_time + timedelta(seconds=step_seconds * i))
                    for i, label in enumerate(labels))


def parse_log(path) -> List[Tuple[int, str, str]]:
    """Parse a session log -> [(segment, label, timestamp_str)]."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    rows = []
    for ln in lines[1:]:
        parts = ln.split("\t")
        rows.append((int(parts[0]), parts[1],
                     parts[2] if len(parts) > 2 else ""))
    return rows
