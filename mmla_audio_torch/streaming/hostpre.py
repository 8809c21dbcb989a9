"""Host half of the low-latency preprocessing split (``host_preprocess``),
counterpart of ``mmla_audio_tpu.streaming.hostpre``.

The single-window chain (``streaming.session.preprocess_window``) on the
CPU: the plain denoise, the native webrtcvad engine's decisions, the CPU
trim.  Only the trimmed window goes to the card, where the featurizer and
the model run.  A session with ``host_preprocess=True`` runs the same
chain on the CPU itself; this class is the chain for a caller without a
session.  The reference's pipeline is all-host at batch 1
(`record_on_pc.py:130-163`).
"""

from __future__ import annotations

import numpy as np
import torch

from mmla_audio_torch.core.config import PipelineConfig
from mmla_audio_torch.streaming.session import preprocess_window
from mmla_audio_torch.vad.native import NativeWebRtcVad, native_available

__all__ = ["HostPreprocessor"]


class HostPreprocessor:
    """One per stream: owns the native detector (``vad``) and the CPU copy
    of the denoise profile.  ``window()`` takes one raw int16 window and
    returns ``(trimmed int16 (n,), n_out)``, zero beyond ``n_out``, ready
    for ``predictor.predict`` (callers apply their own silent gate)."""

    def __init__(self, cfg: PipelineConfig, noise_thresh=None):
        if not native_available():
            raise RuntimeError(
                "host_preprocess requires the native webrtcvad engine "
                "(libmmla_host.so failed to build/load)")
        self.cfg = cfg
        self.vad = NativeWebRtcVad(cfg.vad.aggressiveness)
        self._nt_cpu = None
        if noise_thresh is not None:
            self.set_noise_threshold(noise_thresh)

    def set_noise_threshold(self, noise_thresh) -> None:
        """A CPU copy of the denoise profile ``(K,)``."""
        self._nt_cpu = torch.as_tensor(noise_thresh).detach().to(
            "cpu", torch.float32)

    def window(self, window_i16: np.ndarray) -> tuple[np.ndarray, int]:
        if self._nt_cpu is None:
            raise RuntimeError("set_noise_threshold() first")
        trimmed, n_out = preprocess_window(window_i16, self._nt_cpu, self.cfg,
                                           vad=self.vad)
        return trimmed.to(torch.int16).numpy(), int(n_out)
