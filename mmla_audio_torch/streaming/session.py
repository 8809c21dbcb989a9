"""Live sessions, overlap detection and speaker identification
(counterpart of ``mmla_audio_tpu.streaming.session`` and
``streaming.hostpre``).

Per 2.56 s window, at B=1:

1. raw int16 window -> device: /32768, stationary denoise against the
   session's noise profile, int16 re-quantization (the reference's WAV
   round-trip);
2. int16 -> host: per-frame webrtcvad decisions from the native engine,
   whose state lives across windows like the reference's ``Vad(3)``; or,
   with ``decision="energy"``, the calibrated energy detector on the device;
3. hysteresis trim (``vad_trim``) -> the predictor's featurizer and model
   on the device (``inference.Predictor.score``: the overlap image,
   WavLM's normalised window or the MFCC), then on the host the argmax of
   the logits and the predictor's serving gate (``serving_gate(cfg)``) -> one TSV log
   row.

``preprocess_windows`` is the same chain over a batch of windows from many
streams, all on the windows' device: per-row denoise profiles and energy
thresholds, and for ``decision="webrtc"`` each stream's detector state as
one row of a stacked state tensor (``vad/webrtc.py``; kernel W1 on the
card), the hysteresis keep masks from ``vad_trim_batch`` (W2 on the card).
The multiplexer runs it.

``host_preprocess=True`` runs steps 1-3's denoise, decisions and trim on
the CPU (``preprocess_window`` there, as ``streaming/hostpre.py`` does) and
ships only the trimmed window to the card; ``False`` keeps step 1 on the
session's device.  ``"auto"`` (the default) takes the host split when the
decision is webrtc and the native engine builds, as in the JAX package,
except on a CUDA device: there it keeps the chain on the card, through
which a window reached its decision sooner on the H100 (``PERF.md``).
``gate`` (``streaming/edge.GateSource``) is the edge runners' button:
while it is released the capture is suspended (`record_on_pi.py:139-159`);
``telemetry`` (``analyze/telemetry``) is sent each logged label.

Calibration (10 s of ambient noise) gives the denoise profile, the energy
VAD threshold and the ``Ambient_Noise.wav`` artifact.  Logs land under
``experiment/logs/<timestamp>.txt`` and optional window recordings under
``experiment/recordings/real-time/<timestamp>/wav``, the timestamp that of
``now`` (default: the session's construction).  A session creates its log,
header included, when it is built, and raises ``FileExistsError`` if
another session already holds that name.

Speaker registration (`record_on_pc.py:299-346`): each enrollment clip
(~60 s) goes through the same denoise, VAD and trim chain, the detector's
state carried on, and lands in ``experiment/corpus/<name>.wav``; then the
corpus is featurized and the transfer fine-tune runs until its accuracy
gate, on the session's device, and the session identifies with the new
sigmoid head.

Spans (``utils.timers``; recorded only while a ``torch.profiler`` runs,
one flag check otherwise): ``session.window`` is one window of
``StreamingSession.run``, which every session class shares; inside it
``session.read`` (the capture), ``session.chain`` (``preprocess``, and in
it ``session.vad_fetch``, the blocking copy of the denoised PCM to the
host, ``session.vad_engine``, the detector's call, and ``session.trim``),
``session.predict`` (with the predictor's ``model.*`` spans),
``session.probs_fetch`` (the blocking fetch of the probabilities),
``session.log`` (log row, telemetry, recording) and ``session.callback``
(``on_result``).  ``preprocess_windows`` spans ``chain.denoise``,
``chain.detect`` and ``chain.trim``.  A session's construction and
``set_noise_profile`` are the set-up span ``setup.stream``.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from mmla_audio_torch.analyze.logs import SessionLog
from mmla_audio_torch.core.config import PipelineConfig
from mmla_audio_torch.data.wavio import write_wav
from mmla_audio_torch.inference import SILENT, SpeakerPredictor
from mmla_audio_torch.ops.denoise import (noise_threshold, quantize_i16,
                                          reduce_noise)
from mmla_audio_torch.utils.experiment import ExperimentDirs, bootstrap
from mmla_audio_torch.utils.timers import setup_span, span
from mmla_audio_torch.vad.collector import (calibrate_threshold, energy_vad,
                                            frame_count, vad_trim,
                                            vad_trim_batch)
from mmla_audio_torch.vad.native import NativeWebRtcVad, native_available
from mmla_audio_torch.vad.webrtc import webrtc_vad_rows

__all__ = ["session_stamp", "preprocess_window", "preprocess_windows",
           "StreamingSession", "OverlapSession", "WavLMSession",
           "SpeakerSession"]


def session_stamp(now: Optional[datetime] = None) -> str:
    """Reference log/dir naming: str(datetime) with ' ' and ':' -> '-',
    microseconds stripped (`record_on_pc.py:103`)."""
    s = str(now or datetime.now())
    if "." in s:
        s = s[: s.index(".")]
    return s.replace(" ", "-").replace(":", "-")


@torch.no_grad()
def preprocess_window(window_i16, noise_thresh: torch.Tensor,
                      cfg: PipelineConfig, *, vad=None,
                      vad_threshold_db: float = 30.0, gmm_state=None
                      ) -> tuple[torch.Tensor, int]:
    """The single-window chain on ``noise_thresh``'s device: int16 window
    -> /32768 -> denoise (``passes_live``) -> int16 re-quantization ->
    per-frame decisions (the native engine ``vad``'s, its state carried
    across calls, or without it the energy detector's at
    ``vad_threshold_db``) -> ``vad_trim``.  Only the collector's ``T``
    frames (strict ``<``) reach the detector.  Returns the trimmed
    int16-scale float window on that device (zero beyond the count) and
    the count.

    ``gmm_state`` (a ``vad.gmm.GmmVadState`` on that device) selects the
    float GMM approximation instead, a probe that no serving surface
    passes: ``gmm_vad`` over the whole window (G1 on the card), its
    decisions cut to the collector's ``T``; the adapted state is dropped,
    as in the JAX package."""
    sr = cfg.audio.sample_rate
    raw = torch.as_tensor(np.asarray(window_i16, np.int16))
    y = raw.to(noise_thresh.device).to(torch.float32) / 32768.0
    y = reduce_noise(y, noise_thresh, cfg.denoise, sr=sr,
                     passes=cfg.denoise.passes_live)
    i16 = quantize_i16(y)
    fl = int(sr * cfg.vad.frame_ms / 1000)
    T = frame_count(i16.shape[-1], fl)
    if vad is not None:
        with span("session.vad_fetch"):
            pcm = i16[: T * fl].to("cpu", torch.int16).numpy()
        with span("session.vad_engine"):
            decisions = vad.decisions(pcm, frame_len=fl, sample_rate=sr)
    elif gmm_state is not None:
        from mmla_audio_torch.vad.gmm import gmm_vad

        with span("session.vad_engine"):
            decisions = gmm_vad(i16, gmm_state,
                                aggressiveness=cfg.vad.aggressiveness,
                                frame_len=fl)[0][:T]
    else:
        with span("session.vad_engine"):
            decisions = energy_vad(i16[: T * fl].reshape(T, fl),
                                   vad_threshold_db)
    with span("session.trim"):
        return vad_trim(i16, i16.shape[-1], decisions, fl,
                        cfg.vad.ring_frames)


@torch.no_grad()
def preprocess_windows(raws_i16: torch.Tensor, noise_threshs: torch.Tensor,
                       vad_thrs: torch.Tensor, cfg: PipelineConfig, *,
                       states: Optional[torch.Tensor] = None, idx=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The single-window chain (``StreamingSession.preprocess``) over a
    batch of windows, one stream a row, without a host round trip:
    ``raws_i16 (B, n)`` int16, each row's denoise threshold ``(B, K)`` and
    energy threshold ``(B,)`` -> /32768 -> denoise (``passes_live``) ->
    int16 re-quantization -> per-frame decisions -> ``vad_trim_batch``.

    With ``states`` (``(S, 265)`` int32 rows, ``vad/webrtc.py``) and the host
    array ``idx (B,)`` the decisions are webrtcvad's, advancing
    ``states[idx[b]]`` in place (``idx[b] >= S``: a padding row, which
    touches no state); without them the energy detector's.  Only the
    collector's ``T`` frames (strict ``<``) reach the detector.  Returns
    (trimmed int16-scale float32 ``(B, n)``, zero beyond each count; kept
    samples ``(B,)`` int32)."""
    sr = cfg.audio.sample_rate
    with span("chain.denoise"):
        y = raws_i16.to(torch.float32) / 32768.0
        # a (B, 1, K) threshold broadcasts against the (B, frames, K)
        # spectra
        y = reduce_noise(y, noise_threshs[:, None, :], cfg.denoise, sr=sr,
                         passes=cfg.denoise.passes_live)
        i16 = quantize_i16(y)
    B, n = i16.shape
    fl = int(sr * cfg.vad.frame_ms / 1000)
    T = frame_count(n, fl)
    with span("chain.detect"):
        if states is not None:
            decisions = webrtc_vad_rows(
                i16[:, : T * fl].to(torch.int16), states, idx,
                mode=cfg.vad.aggressiveness, frame_len=fl, sample_rate=sr)
        else:
            decisions = energy_vad(i16[:, : T * fl].reshape(B, T, fl),
                                   vad_thrs[:, None])
    with span("chain.trim"):
        n_samples = torch.full((B,), n, dtype=torch.int32,
                               device=i16.device)
        return vad_trim_batch(i16, n_samples, decisions, fl,
                              cfg.vad.ring_frames)


class StreamingSession:
    """Calibration, the per-window pre-decision chain, the run loop, logs;
    a subclass sets ``predictor``, whose step ``process_window`` runs."""

    kind = "overlap"
    log_timestamps = True
    # the labels' names (a speaker session's enrollment); None: the
    # predictor's own
    speaker_id_dict: Optional[Dict[str, str]] = None

    @setup_span("setup.stream")
    def __init__(self, capture, dirs: ExperimentDirs | str,
                 cfg: PipelineConfig = PipelineConfig(),
                 device: torch.device | str = "cuda",
                 save_recordings: bool = False,
                 now: Optional[datetime] = None, telemetry=None, gate=None,
                 host_preprocess: bool | str = "auto"):
        self.device = torch.device(device)
        if host_preprocess == "auto":
            host_preprocess = (cfg.vad.decision == "webrtc"
                               and self.device.type != "cuda"
                               and native_available())
        if host_preprocess and cfg.vad.decision != "webrtc":
            raise ValueError(
                "host_preprocess is the low-latency arrangement for the "
                "webrtc decision; set cfg.vad.decision='webrtc'")
        self.telemetry = telemetry
        self.gate = gate
        self.capture = capture
        self.dirs = dirs if isinstance(dirs, ExperimentDirs) else bootstrap(dirs)
        self.cfg = cfg
        self.save_recordings = save_recordings
        stamp = session_stamp(now)
        self.log = self._claim_log(self.dirs.logs / f"{stamp}.txt")
        self.rec_dir = self.dirs.real_time / stamp / "wav"
        if save_recordings:
            self.rec_dir.mkdir(parents=True, exist_ok=True)
        self.noise_thresh: Optional[torch.Tensor] = None
        self.vad_threshold_db = 30.0
        # where the pre-decision chain runs, and its copy of the profile
        self.preprocess_device = torch.device("cpu") if host_preprocess \
            else self.device
        self._nt_pre: Optional[torch.Tensor] = None
        # one window a call: "webrtc" runs the native host engine and raises
        # here if it cannot be built (the batched chain of many streams,
        # preprocess_windows, runs the engine on the card)
        self._vad = NativeWebRtcVad(cfg.vad.aggressiveness) \
            if cfg.vad.decision == "webrtc" else None

    def _claim_log(self, path: Path) -> SessionLog:
        """Create the session's log with its header, or raise
        ``FileExistsError`` if another session already holds that name (two
        sessions started in the same second with no distinct ``now``): one
        log a session, never a second header in one file."""
        try:
            path.open("x").close()
        except FileExistsError:
            raise FileExistsError(
                f"session log {path} already exists: another session "
                f"started at the same time; give each session its own "
                f"now=") from None
        log = SessionLog(path, kind=self.kind,
                         timestamps=self.log_timestamps)
        log.ensure_header()
        return log

    def calibrate(self, seconds: Optional[float] = None) -> None:
        """Record ambient noise -> denoise profile + VAD threshold +
        ``Ambient_Noise.wav`` (`record_on_pc.py:299-322`)."""
        sr = self.cfg.audio.sample_rate
        n = int((seconds or self.cfg.audio.noise_profile_seconds) * sr)
        chunks, got = [], 0
        while got < n:
            w = self.capture.read_window(min(n - got, sr), timeout=30.0)
            if w is None:
                break
            chunks.append(w)
            got += len(w)
        noise = (np.concatenate(chunks) if chunks
                 else np.zeros(n, np.int16))[:n]
        write_wav(self.dirs.noise_path, noise, sr)
        self.set_noise_profile(noise)

    @setup_span("setup.stream")
    def set_noise_profile(self, noise_i16: np.ndarray) -> None:
        nf = torch.from_numpy(np.asarray(noise_i16, np.float32) / 32768.0)
        self.noise_thresh = noise_threshold(nf.to(self.device),
                                            self.cfg.denoise)
        self.vad_threshold_db = calibrate_threshold(
            noise_i16, self.cfg.vad.aggressiveness)
        self._nt_pre = self.noise_thresh.to(self.preprocess_device)

    def preprocess(self, window_i16: np.ndarray) -> tuple[torch.Tensor, int]:
        """denoise -> int16 re-quantization -> VAD decisions -> trim, on
        ``preprocess_device`` (``preprocess_window``).  Returns the trimmed
        int16-scale float window there (zero beyond the count) and the
        count."""
        if self.noise_thresh is None:
            raise RuntimeError("calibrate() or set_noise_profile() first")
        with span("session.chain"):
            return preprocess_window(window_i16, self._nt_pre, self.cfg,
                                     vad=self._vad,
                                     vad_threshold_db=self.vad_threshold_db)

    # -- the gate ---------------------------------------------------------------
    def _suspend_target(self):
        """What owns producer suspension: the capture when it runs its own
        producer thread (``CaptureThread``), else the raw source."""
        return self.capture if hasattr(self.capture, "suspend") else \
            getattr(self.capture, "source", None)

    def _ensure_capturing(self) -> None:
        """Gate pressed: resume a capture created suspended (the edge
        device boots with the button up) or parked by an earlier release.
        Shared by the run loop and gated registration."""
        target = self._suspend_target()
        if hasattr(target, "resume"):
            target.resume()

    def run(self, max_windows: Optional[int] = None,
            on_result: Optional[Callable] = None) -> list:
        """Consume windows until the capture ends or ``max_windows``;
        returns ``[(index, label, timestamp)]``.  With a gate, the capture
        is suspended while it is released and resumed when it is pressed;
        a capture created suspended is adopted only by a gated session (an
        always-on one leaves a capture an operator parked alone)."""
        if self.noise_thresh is None:
            raise RuntimeError("calibrate() or set_noise_profile() first")
        results = []
        n_win = self.cfg.audio.window_samples
        target = self._suspend_target()
        suspended = self.gate is not None and \
            bool(getattr(target, "suspended", False))
        try:
            while max_windows is None or len(results) < max_windows:
                if self.gate is not None and not self.gate.pressed:
                    if not suspended and hasattr(target, "suspend"):
                        target.suspend()
                    suspended = True
                    if not self.gate.wait_pressed(timeout=0.1):
                        continue
                if suspended:
                    self._ensure_capturing()
                    suspended = False
                with span("session.window"):
                    if not self._run_window(n_win, results, on_result):
                        break
        except KeyboardInterrupt:
            pass
        return results

    def _run_window(self, n_win: int, results: list, on_result) -> bool:
        """One window of ``run``: read, decide, log, call back.  False when
        the capture has ended."""
        with span("session.read"):
            window = self.capture.read_window(n_win, timeout=30.0)
        if window is None:
            err = getattr(self.capture, "error", None)
            if err is not None:
                raise RuntimeError(f"capture failed: {err!r}") from err
            return False
        label, prob = self.process_window(window)
        with span("session.log"):
            ts = datetime.today()
            idx = self.log.append(label, ts)
            if self.telemetry is not None:
                self.telemetry.send(label)
            if self.save_recordings:
                write_wav(self.rec_dir / f"{idx}.wav", window,
                          self.cfg.audio.sample_rate)
            results.append((idx, label, ts))
        if on_result is not None:
            with span("session.callback"):
                on_result(idx, label, prob)
        return True

    def _score(self, samples: torch.Tensor, n: torch.Tensor):
        return self.predictor.score(samples, n)

    def process_window(self, window_i16: np.ndarray):
        """One window -> (label name, probs as numpy)."""
        trimmed, n_out = self.preprocess(window_i16)
        pred = self.predictor
        with span("session.predict"):
            logits, probs = self._score(
                trimmed[None], torch.tensor([n_out], dtype=torch.int32,
                                            device=self.device))
            out = torch.cat([logits[0], probs[0]])
        with span("session.probs_fetch"):
            logits, probs = np.split(out.cpu().numpy(), 2)    # one fetch
        label = SILENT if n_out < pred.serving_gate(self.cfg) else \
            int(np.argmax(logits))
        return pred.label_name(label, self.speaker_id_dict), probs


class OverlapSession(StreamingSession):
    def __init__(self, predictor, capture, dirs, **kw):
        super().__init__(capture, dirs, device=predictor.device, **kw)
        self.predictor = predictor


class WavLMSession(OverlapSession):
    """Live overlap detection with WavLM Large (a ``WavLMPredictor``): the
    overlap session's chain, gate, labels and log, the predictor's
    normalised window in place of the overlap image."""


class SpeakerSession(StreamingSession):
    """Live speaker identification and registration.  The same
    pre-decision chain as the overlap session, the native webrtc engine's
    state carried across windows and enrollments; the silent gate is
    ``cfg.speaker_feature.silent_samples``."""

    kind = "speaker"

    def __init__(self, predictor, capture, dirs,
                 speaker_id_dict: Optional[Dict[str, str]] = None, **kw):
        super().__init__(capture, dirs, device=predictor.device, **kw)
        self.predictor = predictor
        self.speaker_id_dict = speaker_id_dict or {}

    # -- registration ---------------------------------------------------------
    def register_speaker(self, name: str,
                         seconds: Optional[float] = None) -> Path:
        """One enrollment: capture ``seconds`` (default
        ``cfg.audio.enroll_seconds``), denoise, VAD-trim, write
        ``experiment/corpus/<name>.wav`` (`record_on_pc.py:299-328`)."""
        if self.noise_thresh is None:
            raise RuntimeError("calibrate() or set_noise_profile() first")
        sr = self.cfg.audio.sample_rate
        n = int((seconds or self.cfg.audio.enroll_seconds) * sr)
        chunks, got = [], 0
        while got < n:
            w = self.capture.read_window(min(n - got, sr), timeout=60.0)
            if w is None:
                break
            chunks.append(w)
            got += len(w)
        raw = (np.concatenate(chunks) if chunks else np.zeros(n, np.int16))[:n]
        # the session's own chain, so that one detector sees every frame in
        # capture order
        trimmed, n_out = self.preprocess(raw)
        path = self.dirs.corpus / f"{name}.wav"
        write_wav(path, torch.as_tensor(trimmed)[:n_out].to(
            "cpu", torch.int16).numpy(), sr)
        return path

    def train_on_registered(self, base_state_dict: Mapping[str, torch.Tensor],
                            seed: int = 0, epochs_override=None) -> float:
        """Featurize the corpus, fine-tune ``base_state_dict``'s trunk under
        a new head until the accuracy gate, save the model, and identify
        with it from now on (`transfer_learning_on_experiment` and the
        retrain loop).  Writes ``experiment_feature.npz``/``.json`` and
        ``speaker_id_dict.json`` at the experiment's root and
        ``model/variables.npz`` + ``model/metadata.json``; returns the
        validation accuracy.  Training and the new predictor take the
        current predictor's device and precision."""
        from mmla_audio_torch.data.corpus import featurize_corpus
        from mmla_audio_torch.train.checkpoints import (save_feature_cache,
                                                        save_variables)
        from mmla_audio_torch.train.transfer import TransferLearner

        cfg = self.cfg
        precision = self.predictor.matmul_precision
        x, y, sid = featurize_corpus(self.dirs.corpus, cfg.speaker_feature,
                                     device=self.device)
        save_feature_cache(self.dirs.root / "experiment_feature", x, y, sid)
        n_speakers = int(y.shape[1])
        learner = TransferLearner(base_state_dict, n_speakers,
                                  cfg.speaker_model, cfg.transfer,
                                  device=self.device,
                                  matmul_precision=precision)
        state_dict, acc, _ = learner.fit_until_gate(
            x, y, seed=seed, epochs_override=epochs_override)
        self.speaker_id_dict = sid
        (self.dirs.root / "speaker_id_dict.json").write_text(json.dumps(sid))
        save_variables(self.dirs.model, state_dict, cfg.speaker_model,
                       n_speakers, {"n_speakers": n_speakers,
                                    "accuracy": float(acc),
                                    "speaker_id_dict": sid})
        self.predictor = SpeakerPredictor(
            state_dict, cfg.speaker_model, cfg.speaker_feature,
            head_units=n_speakers, sigmoid_head=True, device=self.device,
            matmul_precision=precision)
        return acc
