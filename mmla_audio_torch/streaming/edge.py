"""Edge (Pi-class) session variants (counterpart of
``mmla_audio_tpu.streaming.edge``), the reference's Raspberry-Pi runners
(`OverlapDetection/scripts/record_on_pi.py`,
`SpeakerIdentification/scripts/record_on_pi.py`):

* ``EdgeOverlapSession``: heavier denoising (``passes_edge``, x4; on the
  card through the denoise kernels D1 and D2), int16 re-quantization, the
  raw and the denoised 1.5 s feature images in one featurizer launch at
  B=2, and the SSIM silence gate instead of the VAD-length gate: SSIM below
  ``ssim_threshold`` (denoising wiped the features, the window was
  noise-only) means silent (:39-48, :120); the model runs on the denoised
  image;
* ``EdgeSpeakerSession``: registration behind the gate, the timestamp-free
  ``segment\\tspeaker`` log, and the identify step (MFCC and model) run
  through ``export.aot_compile`` at the pinned window shape (the TFLite
  interpreter of the reference), rebuilt after ``train_on_registered``
  installs a new head (the reference reloads the interpreter, :264-268);
* ``GateSource``: the button; while it is released the session suspends
  its capture (``StreamingSession.run``), so GPIO, a keyboard or a test
  can drive it.

Both run on the session's device and refuse ``host_preprocess=True``: the
host split is the single-stream PC arrangement.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from mmla_audio_torch.core.config import PipelineConfig
from mmla_audio_torch.export import aot_compile
from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
from mmla_audio_torch.ops.denoise import quantize_i16, reduce_noise
from mmla_audio_torch.ops.ssim import ssim
from mmla_audio_torch.streaming.session import SpeakerSession, StreamingSession

__all__ = ["GateSource", "EdgeOverlapSession", "EdgeSpeakerSession"]


class GateSource:
    """The Pi button: while released, capture is suspended.  Tests and
    keyboard handlers toggle ``set_pressed``."""

    def __init__(self, pressed: bool = True):
        self._event = threading.Event()
        if pressed:
            self._event.set()

    def set_pressed(self, pressed: bool) -> None:
        if pressed:
            self._event.set()
        else:
            self._event.clear()

    @property
    def pressed(self) -> bool:
        return self._event.is_set()

    def wait_pressed(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


def _refuse_host_split(kw: dict) -> dict:
    if kw.get("host_preprocess") is True:
        raise ValueError("host_preprocess is not supported on edge sessions")
    return {**kw, "host_preprocess": False}


class EdgeOverlapSession(StreamingSession):
    """Overlap detection with the Pi runner's gates.  ``last_similarity``
    holds the SSIM of the last window."""

    kind = "overlap"

    def __init__(self, predictor, capture, dirs,
                 gate: Optional[GateSource] = None,
                 ssim_threshold: float = 0.3,
                 cfg: PipelineConfig = PipelineConfig(), **kw):
        super().__init__(capture, dirs, cfg=cfg, device=predictor.device,
                         gate=gate or GateSource(pressed=True),
                         **_refuse_host_split(kw))
        self.predictor = predictor
        self.ssim_threshold = ssim_threshold
        self.last_similarity: Optional[float] = None

    @torch.no_grad()
    def process_window(self, window_i16: np.ndarray):
        """One window -> (label name, probs as numpy).  The threshold is
        read at every window, so changing ``ssim_threshold`` between
        windows takes effect."""
        if self.noise_thresh is None:
            raise RuntimeError("calibrate() or set_noise_profile() first")
        cfg, fcfg = self.cfg, self.cfg.overlap_feature
        raw = torch.from_numpy(np.asarray(window_i16, np.int16))
        y = raw.to(self.device).to(torch.float32) / 32768.0
        y_dn = reduce_noise(y, self.noise_thresh, cfg.denoise,
                            sr=cfg.audio.sample_rate,
                            passes=cfg.denoise.passes_edge)
        y_dn = quantize_i16(y_dn) / 32768.0
        n = fcfg.n_samples
        imgs = overlap_model_input_cuda(torch.stack([y[:n], y_dn[:n]]), fcfg)
        similarity = ssim(imgs[0], imgs[1])
        probs = torch.softmax(self.predictor.apply_model(imgs[1:]), dim=-1)[0]
        out = torch.cat([probs, similarity[None]]).cpu().numpy()  # one fetch
        probs, sim = out[:-1], float(out[-1])
        self.last_similarity = sim
        # SSIM below the threshold: denoising erased the features, the
        # window was noise-only (record_on_pi.py:44-48, :120)
        if sim < self.ssim_threshold:
            return "silent", probs
        return self.predictor.label_name(int(np.argmax(probs))), probs


class EdgeSpeakerSession(SpeakerSession):
    """Speaker identification with the Pi runner's composition
    (`SpeakerIdentification/scripts/record_on_pi.py:199-378`).  The SI Pi
    runner keeps the VAD-length silent gate of the PC pipeline (:296-300);
    the SSIM gate is the overlap runner's only."""

    kind = "speaker"
    log_timestamps = False        # the Pi runner's timestamp-free schema

    def __init__(self, predictor, capture, dirs,
                 gate: Optional[GateSource] = None,
                 cfg: PipelineConfig = PipelineConfig(), **kw):
        super().__init__(predictor, capture, dirs, cfg=cfg,
                         gate=gate or GateSource(pressed=True),
                         **_refuse_host_split(kw))
        self._aot = None

    def register_speaker(self, name, seconds=None):
        """Registration behind the gate: wait until it is pressed and make
        sure the capture produces (it may have been created suspended, or
        parked by an earlier release)."""
        self.gate.wait_pressed()
        self._ensure_capturing()
        return super().register_speaker(name, seconds)

    def train_on_registered(self, *args, **kwargs) -> float:
        acc = super().train_on_registered(*args, **kwargs)
        self._aot = None          # a new head: compile the pinned step anew
        return acc

    def _score(self, samples: torch.Tensor, n: torch.Tensor):
        """The identify step through the pinned program."""
        if self._aot is None:
            self._aot = aot_compile(self.predictor.score, samples, n)
        return self._aot(samples, n)
