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

A log keeps its file open between writes: the append handles live in one
bounded LRU for the process (``_OPEN_HANDLES``, keyed by ``id(log)``).  At
hundreds of multiplexed streams an open and close a row is a large share of
the host's time a window; one descriptor a log would exhaust a 1,024-fd
ulimit at the 1,024-stream scale, so at most ``_MAX_OPEN_HANDLES`` stay
open and eviction closes the least recently written.  The next write of an
evicted log reopens it in append mode, so eviction changes no byte.  Every
write is flushed, so ``parse_log`` reads a live log whole.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from datetime import datetime, timedelta
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

__all__ = ["OVERLAP_HEADER", "SPEAKER_HEADER", "OVERLAP_LABELS",
           "OVERLAP_LABELS_3WAY", "SessionLog", "parse_log"]

# id(log) -> (path, append handle), least recently written first
_OPEN_HANDLES: "OrderedDict[int, tuple]" = OrderedDict()
_MAX_OPEN_HANDLES = 128
# held across a whole write: an eviction by another thread must not close
# a handle between its lookup and its write
_HANDLES_LOCK = threading.RLock()

OVERLAP_HEADER = "segment\toverlapped degree\ttimestamp"
SPEAKER_HEADER = "segment\tspeaker\ttimestamp"

OVERLAP_LABELS = {"0": "non-overlapped", "1": "overlapped"}
OVERLAP_LABELS_3WAY = {"0": "non-overlapped", "1": "overlapped", "2": "silent"}


class SessionLog:
    """Append-only TSV log; each write is flushed as it is made, through an
    append handle kept open in the module's LRU until ``close`` or
    eviction."""

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

    def _file(self):
        """This log's append handle, opened (and the least recently written
        handle beyond the cap closed) on a miss.  Call with
        ``_HANDLES_LOCK`` held."""
        key = id(self)
        ent = _OPEN_HANDLES.get(key)
        if ent is not None and ent[0] == self.path and not ent[1].closed:
            _OPEN_HANDLES.move_to_end(key)
            return ent[1]
        fh = open(self.path, "a")
        _OPEN_HANDLES[key] = (self.path, fh)
        while len(_OPEN_HANDLES) > _MAX_OPEN_HANDLES:
            _OPEN_HANDLES.popitem(last=False)[1][1].close()
        return fh

    def close(self) -> None:
        """Close this log's handle, if open; a later write reopens it."""
        with _HANDLES_LOCK:
            ent = _OPEN_HANDLES.pop(id(self), None)
            if ent is not None:
                ent[1].close()

    def __del__(self):
        # at interpreter exit the module's globals may already be gone
        try:
            self.close()
        except (AttributeError, TypeError):
            pass

    def _write(self, rows: Iterable[Tuple[str, datetime]]) -> None:
        with _HANDLES_LOCK:
            f = self._file()
            if not self._wrote_header:
                f.write(self.header + "\n")
                self._wrote_header = True
            for label, ts in rows:
                f.write(f"{self.index}\t{label}\t{ts}\n" if self.timestamps
                        else f"{self.index}\t{label}\n")
                self.index += 1
            f.flush()

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
