"""Multi-stream serving: many live conversations, one device program a tick
(counterpart of ``mmla_audio_tpu.streaming.multiplex``).

``Multiplexer`` owns k streams, each with its own capture ring, TSV log,
noise profile and webrtcvad detector state.  Every tick it gathers the
streams that have a full 2.56 s window ready, stacks them (padded to the
smallest bucket of the ladder that holds them), runs one batched
denoise -> VAD -> trim -> featurize -> predict program on the card and
sends each label back to its stream's log.

* **Non-blocking gather.** Each tick polls every stream once without
  waiting, from a rotating start, so a stalled stream costs one poll and no
  stream starves.  With native rings (``streaming.native``) the whole
  gather is one ``rb_pop_batch`` call that copies each window straight into
  a row of the staging matrix; otherwise a Python poll loop does the same.
* **Bucket ladder and ``min_fill``.** A tick pads the ready set to the
  smallest sufficient bucket; with ``min_fill`` ready windows accumulate
  until the top bucket is that full, a tick gathers nothing new, or the
  oldest has waited ``max_pending_ticks`` ticks.
* **One-tick pipeline.** A batch is dispatched without waiting and its
  labels are resolved on the NEXT tick, after that tick's gather and
  dispatch.  At dispatch the labels are copied into one of two pinned
  buffers (flipped with the staging) and a CUDA event is recorded after
  the copy; the resolve waits on that event alone, so the batch dispatched
  just before it keeps the card busy under the host's log appends, the
  next gather and the next stage.  That wait is the pipeline's only
  blocking wait on the card.
* **Staging.** Two pinned int16 matrices ``(top bucket, window)`` (and two
  of the per-row thresholds), flipped every dispatch and copied to the card
  without blocking.  A CUDA event recorded after each batch's copies is
  waited on before its matrix is written again: a matrix whose copy may
  still be in flight must not be rewritten.
* **Detector state on the card.** With ``decision="webrtc"`` every stream's
  detector state is one row of an ``(n, 265)`` int32 tensor on the card;
  the batch runs W1 (``vad/webrtc.py``) on the dispatched rows by index,
  in place.  A stream never contributes two windows to one batch (the
  busy-guard), so no two rows of a launch share a state row; padding rows
  pass an index past the last stream and touch no state.
* **Data parallelism** (``mesh=``, one process's devices,
  ``parallel.make_mesh``): a batch splits into the data axis's equal row
  blocks; each runs the whole program on its device with that device's
  replica of the model.  The stacked detector state stays on the first
  device: a block gathers its rows, advances them on its device and writes
  them back (the blocks' rows are disjoint); the labels come back to the
  first device, whose stream copies them to the pinned buffer.  A
  one-device mesh is the unsplit path, launch for launch.  A split batch's
  labels and detector rows equal the unsplit batch's: every stage of the
  program is row-independent, the denoise included (D1 and D2 are
  batch-invariant).

Retention (a long-lived host must stay bounded; the TSV logs are always
the complete record): ``results_cap`` bounds each stream's in-memory
``results`` tail (None keeps everything, 0 keeps nothing), and
``remove_stream(stream, archive=False)`` drops a finished conversation's
``Stream`` when its row is recycled instead of keeping it in ``retired``,
and closes its log's append handle (``close_log=True``, the default).
The defaults (``results_cap=None``, ``archive=True``) are the JAX
package's.

Timing.  A tick's five phases are spans (``utils.timers.phase``) that also
add their host seconds to ``phase_seconds``: ``mux.gather`` (``gather``),
``mux.stage`` (``stage``), ``mux.dispatch`` (``dispatch``; inside it the
program's ``chain.denoise``, ``chain.detect``, ``chain.trim``,
``model.features``, ``model.forward`` and ``model.labels``, once a device
block on a split mesh), ``mux.fetch`` (``resolve_fetch``) and ``mux.log``
(``resolve_log``, with a ``logs.reopen`` span for each log handle the LRU
reopens).  A span is recorded only while a ``torch.profiler`` runs (one
flag check otherwise); ``phase_seconds`` always counts.  ``add_stream`` is
the set-up span ``setup.stream``, a calibration-cache miss inside it
``setup.calibrate``; ``calib_hits`` and ``calib_misses`` count the cache's
lookups.  ``fetch_ready`` and ``fetch_waited`` count the resolves whose
batch had already finished when the resolve asked (its event done; every
resolve on the CPU) and those that waited for it.
"""

from __future__ import annotations

import hashlib
import time
from collections import deque
from datetime import datetime
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mmla_audio_torch.analyze.logs import SessionLog
from mmla_audio_torch.core.config import PipelineConfig
# the benchmark's taps patch the featurizers here by name; the decision
# step calls them through ``mmla_audio_torch.inference``
from mmla_audio_torch.models.wavlm import wavlm_input_batch  # noqa: F401
from mmla_audio_torch.ops.cuda_features import (  # noqa: F401
    overlap_model_input_cuda)
from mmla_audio_torch.ops.denoise import noise_threshold
from mmla_audio_torch.ops.features import speaker_feature_batch  # noqa: F401
from mmla_audio_torch.parallel.mesh import canonical_device, replicate_tree
from mmla_audio_torch.streaming.native import BatchGather, NativeRingBuffer
from mmla_audio_torch.streaming.session import (preprocess_windows,
                                                session_stamp)
from mmla_audio_torch.utils.experiment import ExperimentDirs, bootstrap
from mmla_audio_torch.utils.timers import phase, setup_span
from mmla_audio_torch.vad.collector import calibrate_threshold
from mmla_audio_torch.vad.webrtc import webrtc_init

__all__ = ["Stream", "Multiplexer"]

CALIBRATION_CACHE = 256      # distinct ambient profiles kept, FIFO


class Stream:
    """One conversation: capture, log, calibration and its detector row.

    ``results`` keeps the most recent ``results_cap`` ``(index, label,
    timestamp)`` tuples (None: all of them); the TSV ``log`` is the complete
    record."""

    def __init__(self, name: str, capture, log: SessionLog,
                 noise_thresh: np.ndarray, vad_threshold_db: float,
                 label_names: Optional[Dict[str, str]] = None,
                 index: int = 0, results_cap: Optional[int] = None):
        self.name = name
        self.capture = capture
        self.log = log
        self.noise_thresh = noise_thresh
        self.vad_threshold_db = vad_threshold_db
        self.label_names = label_names
        self.index = index                  # row in the stacked webrtc state
        self.results = deque(maxlen=results_cap) \
            if results_cap is not None else []
        self.done = False
        self.retiring = False               # remove_stream called
        self.archive = True                 # keep the Stream in .retired


class _Fetch(NamedTuple):
    """A dispatched batch's labels: ``labels`` on the device (kept alive
    until the resolve), ``host`` their pinned copy and ``event`` recorded
    after that copy; on the CPU ``host`` is ``labels`` and ``event`` None."""
    labels: torch.Tensor
    host: torch.Tensor
    event: Optional[torch.cuda.Event]


class Multiplexer:
    """Batch windows across streams into one device program a tick.

    ``predictor``: an ``inference.Predictor``, whose decision step, gate
    (``serving_gate(cfg)``), log schema and label names the multiplexer
    serves; ``kind``, if given, must be the predictor's, and ``cfg``'s
    feature section (``predictor.cfg_features``) its ``feat_cfg``.  ``bucket`` fixes
    one batch size; ``buckets`` is the ascending ladder (a tick rounds its
    ready count up to the smallest sufficient bucket).  ``min_fill``: None
    is 0.75 once there are as many streams as the top bucket, else 0
    (dispatch every tick).  ``device`` must be the predictor's.  ``mesh``: a
    one-process mesh whose first device is ``device`` and whose data axis
    divides every bucket; each batch splits over its data axis (the module
    docstring)."""

    def __init__(self, predictor, dirs: ExperimentDirs | str, *,
                 kind: str | None = None, bucket: int | None = None,
                 buckets: Sequence[int] = (8, 64),
                 min_fill: float | None = None,
                 max_pending_ticks: int = 4,
                 results_cap: int | None = None,
                 cfg: PipelineConfig = PipelineConfig(),
                 device: torch.device | str = "cuda", mesh=None):
        if kind is not None and kind != predictor.kind:
            raise ValueError(f"kind {kind!r} is not the predictor's "
                             f"({predictor.kind!r})")
        field = predictor.cfg_features
        if field is not None and getattr(cfg, field) != predictor.feat_cfg:
            raise ValueError(f"cfg.{field} is not the predictor's feat_cfg, "
                             f"which it featurizes with")
        self.device = torch.device(device)
        if predictor.device.type != self.device.type:
            raise ValueError(f"the predictor runs on {predictor.device}, the "
                             f"multiplexer on {self.device}")
        if results_cap is not None and results_cap < 0:
            raise ValueError(f"results_cap must be None or >= 0: "
                             f"{results_cap}")
        self.predictor = predictor
        self.dirs = dirs if isinstance(dirs, ExperimentDirs) \
            else bootstrap(dirs)
        if bucket is not None:
            buckets = (bucket,)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f"buckets must be positive: {buckets}")
        self.bucket = self.buckets[-1]          # the most a tick gathers
        if min_fill is not None and not 0.0 <= min_fill <= 1.0:
            raise ValueError(f"min_fill must be in [0, 1]: {min_fill}")
        self.min_fill = min_fill
        self.mesh = mesh
        self._replicas = None               # device -> model, a split mesh
        if mesh is not None:
            self._check_mesh(mesh)
            if mesh.devices.shape[0] > 1:
                self._replicas = replicate_tree(predictor.model, mesh)
        self.max_pending_ticks = int(max_pending_ticks)
        self.results_cap = results_cap
        self.cfg = cfg
        self._gate = predictor.serving_gate(cfg)
        self._calib_cache: Dict[bytes, tuple] = {}
        self.calib_hits = self.calib_misses = 0
        self.streams: List[Stream] = []
        # finished conversations: remove_stream moves a stream to
        # _retiring; add_stream recycles its row (list slot, gather ring,
        # detector row reset to a fresh engine) once none of its windows is
        # pending or in flight
        self.retired: List[Stream] = []
        self._retiring: List[Stream] = []
        self._use_webrtc = cfg.vad.decision == "webrtc"
        self._webrtc_states: Optional[torch.Tensor] = None
        self._webrtc_n = 0
        self._fresh_row = webrtc_init(1, self.device) \
            if self._use_webrtc else None
        self._rr = 0                            # round-robin gather offset
        self._inflight = None                   # (ready streams, _Fetch)
        pinned = self.device.type == "cuda"
        n_win = cfg.audio.window_samples
        self._fill = [torch.zeros((self.bucket, n_win), dtype=torch.int16,
                                  pin_memory=pinned) for _ in range(2)]
        self._vts = [torch.zeros((self.bucket,), dtype=torch.float32,
                                 pin_memory=pinned) for _ in range(2)]
        self._nts = None                        # 2 x (top bucket, K), lazily
        # each dispatch's labels, copied behind its program (CUDA only)
        self._labels_host = [torch.zeros((self.bucket,), dtype=torch.int32,
                                         pin_memory=True)
                             for _ in range(2)] if pinned else None
        self._copied: list = [None, None]       # CUDA event after each H2D
        self._flip = 0
        self._pending_streams: List[Stream] = []
        self._pending_ticks = 0
        self._batch_gather: Optional[BatchGather] = None
        self._gather_dirty = True
        # Per tick, on the host clock:
        #   gather        ring polls + window pops into the staging rows
        #   stage         padding and per-row threshold staging
        #   dispatch      non-blocking copies + enqueuing the program
        #   resolve_fetch the wait for the previous batch's own labels
        #   resolve_log   per-stream TSV log appends
        # Host-side cost = gather + stage + resolve_log.
        self.phase_seconds = {"gather": 0.0, "stage": 0.0, "dispatch": 0.0,
                              "resolve_fetch": 0.0, "resolve_log": 0.0}
        self.windows_resolved = 0
        self.fetch_ready = self.fetch_waited = 0

    def _check_mesh(self, mesh) -> None:
        if mesh.group is not None:
            raise ValueError("Multiplexer: the mesh spans processes; each "
                             "process serves its own streams on a mesh of "
                             "its own devices")
        first = mesh.local_devices[0]
        if first != canonical_device(self.device):
            raise ValueError(f"Multiplexer: the mesh's first device is "
                             f"{first}, the multiplexer's {self.device}")
        n = mesh.devices.shape[0]
        if any(b % n for b in self.buckets):
            raise ValueError(f"Multiplexer: every bucket must divide by the "
                             f"mesh's data axis ({n}): {self.buckets}")

    def reset_phase_counters(self) -> None:
        for k in self.phase_seconds:
            self.phase_seconds[k] = 0.0
        self.windows_resolved = 0

    def host_side_seconds(self) -> float:
        """Host-only time since the last reset: gather + stage + log
        appends (the copies, the program's launch and the label fetch
        excluded)."""
        p = self.phase_seconds
        return p["gather"] + p["stage"] + p["resolve_log"]

    # -- the device program ---------------------------------------------------
    @torch.no_grad()
    def _program(self, raws: torch.Tensor, nts: torch.Tensor,
                 vts: torch.Tensor, idx, states: Optional[torch.Tensor],
                 model=None) -> torch.Tensor:
        """One batch: the pre-decision chain (``states``: the detector rows
        ``idx`` names, advanced in place), then the predictor's decision
        step (``model``: the replica on the batch's device, default the
        predictor's); labels (B,) int32 on the device, -1 where the trimmed
        window is silent."""
        trimmed, n_out = preprocess_windows(
            raws, nts, vts, self.cfg, states=states, idx=idx)
        return self.predictor.step(trimmed, n_out, self._gate, model)[0]

    def _program_split(self, raws: torch.Tensor, nts: torch.Tensor,
                       vts: torch.Tensor, idx) -> torch.Tensor:
        """``_program`` over the mesh's data axis: one row block a device,
        its detector rows gathered from the stacked state (which stays on
        the first device) and written back; the labels on the first
        device."""
        devices = self.mesh.local_devices
        rows = raws.shape[0] // len(devices)
        states = self._webrtc_states
        parts = []
        for i, d in enumerate(devices):
            blk = slice(i * rows, (i + 1) * rows)
            local, local_idx, real = None, None, None
            if idx is not None:
                own = idx[blk] < self._webrtc_n
                # pageable source: staged before the call returns
                real = torch.from_numpy(idx[blk][own].astype(np.int64)).to(
                    states.device, non_blocking=True)
                local = states.index_select(0, real).to(d)
                # this block's stream rows first, padding past them
                local_idx = np.full(rows, len(real), np.int32)
                local_idx[own] = np.arange(len(real), dtype=np.int32)
            labels = self._program(raws[blk].to(d), nts[blk].to(d),
                                   vts[blk].to(d), local_idx, local,
                                   self._replicas[d])
            if real is not None and len(real):
                states.index_copy_(0, real, local.to(states.device))
            parts.append(labels.to(devices[0]))
        return torch.cat(parts)

    def _calibrate(self, noise_clip_i16: np.ndarray) -> tuple:
        """(noise_thresh, vad_threshold_db) of an ambient clip, cached by
        its dtype, shape and bytes: fleets of streams often share one
        ambient profile, and a derivation runs an STFT on the device."""
        clip = np.ascontiguousarray(noise_clip_i16)
        key = hashlib.sha1(f"{clip.dtype.str}{clip.shape}".encode()
                           + clip.tobytes()).digest()
        hit = self._calib_cache.get(key)
        if hit is not None:
            self.calib_hits += 1
            return hit
        self.calib_misses += 1
        with setup_span("setup.calibrate"):
            nf = torch.from_numpy(clip.astype(np.float32) / 32768.0)
            hit = (noise_threshold(nf.to(self.device), self.cfg.denoise)
                   .cpu().numpy(),
                   calibrate_threshold(clip, self.cfg.vad.aggressiveness))
        if len(self._calib_cache) >= CALIBRATION_CACHE:
            self._calib_cache.pop(next(iter(self._calib_cache)))
        self._calib_cache[key] = hit
        return hit

    # -- stream management ---------------------------------------------------
    @setup_span("setup.stream")
    def add_stream(self, name: str, capture, noise_clip_i16: np.ndarray,
                   label_names: Optional[Dict[str, str]] = None,
                   now: Optional[datetime] = None) -> Stream:
        log = SessionLog(self.dirs.logs / f"{session_stamp(now)}-{name}.txt",
                         kind=self.predictor.log_kind, start_index=1)
        noise_thresh, vad_db = self._calibrate(noise_clip_i16)
        row = self._claim_retired_row()
        stream = Stream(name, capture, log, noise_thresh=noise_thresh,
                        vad_threshold_db=vad_db, label_names=label_names,
                        index=len(self.streams) if row is None else row,
                        results_cap=self.results_cap)
        if row is None:
            self.streams.append(stream)
        else:
            self.streams[row] = stream
            self._reset_webrtc_row(row)
        self._gather_dirty = True
        return stream

    def remove_stream(self, stream: Stream, close_log: bool = True,
                      archive: bool = True) -> None:
        """Retire a finished conversation: it is no longer gathered, and its
        row is recycled by a later ``add_stream`` once none of its windows
        is pending or in flight (those still resolve to its log, which
        reopens in append mode).  ``close_log`` closes the log's append
        handle now instead of leaving it to the handle LRU.
        ``archive=False`` drops the ``Stream`` at recycling instead of
        keeping it in ``retired``.  The capture is the caller's to stop.
        Idempotent (the first call's ``archive`` holds)."""
        if stream.retiring:
            return
        stream.retiring = True
        stream.archive = archive
        self._mark_done(stream)
        if close_log:
            stream.log.close()
        self._retiring.append(stream)
        self._gather_dirty = True

    def _claim_retired_row(self) -> Optional[int]:
        """A recyclable row: a retiring stream with no window pending or in
        a dispatched, unresolved batch (that batch still writes its
        detector row)."""
        inflight = self._inflight[0] if self._inflight is not None else ()
        for i, s in enumerate(self._retiring):
            if s not in self._pending_streams and s not in inflight:
                self._retiring.pop(i)
                if s.archive:
                    self.retired.append(s)
                return s.index
        return None

    def _reset_webrtc_row(self, row: int) -> None:
        """A recycled row decides like a fresh engine (rows past the stacked
        length are made fresh by ``_ensure_webrtc_states``).  A copy on the
        card, after whatever was enqueued before it."""
        if self._webrtc_states is not None and row < self._webrtc_n:
            self._webrtc_states[row].copy_(self._fresh_row[0])

    def _ensure_webrtc_states(self) -> None:
        """Grow the stacked detector state to one row a stream; existing
        rows keep their adapted state."""
        n = len(self.streams)
        if self._webrtc_states is None:
            self._webrtc_states = self._fresh_row.expand(n, -1).contiguous()
        elif self._webrtc_n < n:
            self._webrtc_states = torch.cat(
                [self._webrtc_states,
                 self._fresh_row.expand(n - self._webrtc_n, -1)])
        self._webrtc_n = n

    # -- serving loop --------------------------------------------------------
    def _ensure_gather(self) -> None:
        """(Re)build the one-call gather when the stream set changed; the
        Python poll loop serves when any stream's ring is not native."""
        if not self._gather_dirty:
            return
        self._gather_dirty = False
        self._batch_gather = None
        rings = [getattr(s.capture, "ring", None) for s in self.streams]
        if rings and all(isinstance(r, NativeRingBuffer) for r in rings):
            self._batch_gather = BatchGather(rings)
            for s in self.streams:
                self._batch_gather.set_active(s.index, not s.done)
        if self._nts is None and self.streams:
            k = len(self.streams[0].noise_thresh)
            self._nts = [torch.zeros((self.bucket, k), dtype=torch.float32,
                                     pin_memory=self.device.type == "cuda")
                         for _ in range(2)]

    def _await_staging(self) -> None:
        """Wait until the current staging buffers' last copy to the card has
        finished, before they are written again."""
        event = self._copied[self._flip]
        if event is not None:
            event.synchronize()
            self._copied[self._flip] = None

    def _mark_done(self, stream: Stream) -> None:
        stream.done = True
        if self._batch_gather is not None:
            self._batch_gather.set_active(stream.index, False)

    def _sweep_done(self) -> None:
        """Flag streams whose producer finished with less than a window
        left (checked on empty gathers, the only time it can change)."""
        n_win = self.cfg.audio.window_samples
        for stream in self.streams:
            if stream.done:
                continue
            ring = getattr(stream.capture, "ring", None)
            # `drained` (the final chunk was pushed), not `source.exhausted`
            # (true before the last push: would drop a buffered window)
            if ring is not None:
                if getattr(stream.capture, "drained", False) \
                        and ring.available < n_win:
                    ring.clear()
                    self._mark_done(stream)
            elif getattr(stream.capture.source, "exhausted", False):
                self._mark_done(stream)

    def _gather(self, limit: Optional[int] = None) -> List[Stream]:
        """Poll every stream once without waiting, from the rotating offset;
        windows land in rows ``[len(pending):]`` of the current staging
        matrix.  Returns the streams gathered."""
        with phase(self.phase_seconds, "gather", "mux.gather"):
            return self._gather_rows(limit)

    def _gather_rows(self, limit: Optional[int]) -> List[Stream]:
        self._ensure_gather()
        self._await_staging()
        n_win = self.cfg.audio.window_samples
        n = len(self.streams)
        limit = self.bucket if limit is None else limit
        if n == 0 or limit <= 0:
            return []
        buf = self._fill[self._flip].numpy()
        nts = self._nts[self._flip].numpy()
        vts = self._vts[self._flip].numpy()
        k0 = len(self._pending_streams)
        gathered: List[Stream] = []
        if self._batch_gather is not None:
            # busy-guard: a pending stream must not add a second window
            if self._use_webrtc:
                for s in self._pending_streams:
                    self._batch_gather.set_active(s.index, False)
            idx = self._batch_gather.pop_into(buf, k0, self._rr, limit, n_win)
            if self._use_webrtc:
                for s in self._pending_streams:
                    if not s.done:
                        self._batch_gather.set_active(s.index, True)
            for r, si in enumerate(idx):
                stream = self.streams[int(si)]
                gathered.append(stream)
                nts[k0 + r] = stream.noise_thresh
                vts[k0 + r] = stream.vad_threshold_db
        else:
            busy = {id(s) for s in self._pending_streams} \
                if self._use_webrtc else ()
            for k in range(n):
                if len(gathered) >= limit:
                    break
                stream = self.streams[(self._rr + k) % n]
                if stream.done or id(stream) in busy:
                    continue
                ring = getattr(stream.capture, "ring", None)
                window = ring.pop(n_win) if ring is not None \
                    else stream.capture.read_window(n_win, timeout=0.0)
                if window is None:
                    continue
                r = k0 + len(gathered)
                buf[r] = window
                nts[r] = stream.noise_thresh
                vts[r] = stream.vad_threshold_db
                gathered.append(stream)
        if not gathered:
            self._sweep_done()
        self._rr = (self._rr + 1) % n
        return gathered

    def _dispatch_staged(self):
        """Enqueue the pending rows as one batch (the smallest sufficient
        bucket) and the copy of its labels to pinned memory without waiting,
        then flip the staging buffers.  Returns (ready streams, _Fetch)."""
        with phase(self.phase_seconds, "stage", "mux.stage"):
            self._await_staging()
            ready = self._pending_streams
            k = len(ready)
            bucket = next((b for b in self.buckets if b >= k), self.bucket)
            f = self._flip
            self._fill[f][k: bucket] = 0
            self._vts[f][k: bucket] = 0.0
            self._nts[f][k: bucket] = 0.0
            idx = None
            if self._use_webrtc:
                self._ensure_webrtc_states()
                # padding rows index one past the last stream: no state
                # touched
                idx = np.full((bucket,), self._webrtc_n, np.int32)
                idx[:k] = [stream.index for stream in ready]
        with phase(self.phase_seconds, "dispatch", "mux.dispatch"):
            raws, nts, vts = (buf[:bucket].to(self.device, non_blocking=True)
                              for buf in (self._fill[f], self._nts[f],
                                          self._vts[f]))
            if self.device.type == "cuda":
                self._copied[f] = torch.cuda.Event()
                self._copied[f].record()
            labels = self._program(raws, nts, vts, idx,
                                   self._webrtc_states) \
                if self._replicas is None else \
                self._program_split(raws, nts, vts, idx)
            if self.device.type == "cuda":
                # the slot is written again two dispatches on, after this
                # batch's resolve
                host = self._labels_host[f][:bucket]
                host.copy_(labels, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(labels.device))
                fetch = _Fetch(labels, host, event)
            else:
                fetch = _Fetch(labels, labels, None)
        self._pending_streams = []
        self._pending_ticks = 0
        self._flip ^= 1
        return ready, fetch

    def _resolve(self, inflight) -> int:
        """Wait for a dispatched batch's own labels (its event: nothing
        enqueued after it) and append them to the logs."""
        ready, fetch = inflight
        with phase(self.phase_seconds, "resolve_fetch", "mux.fetch"):
            if fetch.event is None or fetch.event.query():
                self.fetch_ready += 1
            else:
                self.fetch_waited += 1
                fetch.event.synchronize()       # the one blocking wait
            labels = fetch.host.numpy()
        with phase(self.phase_seconds, "resolve_log", "mux.log"):
            ts = datetime.today()
            for i, stream in enumerate(ready):
                name = self.predictor.label_name(int(labels[i]),
                                                 stream.label_names)
                row = stream.log.append(name, ts)
                stream.results.append((row, name, ts))
        self.windows_resolved += len(ready)
        return len(ready)

    def _effective_min_fill(self) -> float:
        if self.min_fill is not None:
            return float(self.min_fill)
        return 0.75 if len(self.streams) >= self.bucket else 0.0

    def tick(self) -> int:
        """One serving step: gather ready windows, dispatch them (when the
        top bucket is ``min_fill`` full, nothing new arrived, or the oldest
        has waited ``max_pending_ticks`` ticks), then resolve the PREVIOUS
        tick's batch, waiting for that batch alone: the one just dispatched
        runs on while this tick logs and the next gathers and stages.
        Returns the windows logged now."""
        new = self._gather(limit=self.bucket - len(self._pending_streams))
        self._pending_streams.extend(new)
        prev, self._inflight = self._inflight, None
        if self._pending_streams:
            self._pending_ticks += 1
            if (len(self._pending_streams)
                    >= self._effective_min_fill() * self.bucket
                    or not new
                    or self._pending_ticks >= self.max_pending_ticks):
                self._inflight = self._dispatch_staged()
        return self._resolve(prev) if prev is not None else 0

    def flush(self) -> int:
        """Resolve the batch in flight and drain the pending windows (call
        when the serving loop stops); each drained batch is resolved as soon
        as it is dispatched, so its wait covers the whole batch."""
        total = 0
        prev, self._inflight = self._inflight, None
        if prev is not None:
            total += self._resolve(prev)
        while self._pending_streams:
            total += self._resolve(self._dispatch_staged())
        return total

    def run_until_exhausted(self, max_ticks: int = 100_000) -> int:
        """Drive replayed or fake streams to their end; total decisions."""
        total = 0
        idle = 0
        for _ in range(max_ticks):
            got = self.tick()
            total += got
            if got == 0 and self._inflight is None:
                if all(s.done for s in self.streams):
                    break
                idle += 1
                time.sleep(min(0.001 * idle, 0.05))    # back off while empty
            else:
                idle = 0
        return total + self.flush()
