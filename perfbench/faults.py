"""Faults planted under the timed path, to see that the comparison fails
them: the detector state left unchanged by each step, the denoised window
rounded to bfloat16, half of each batch never logged, an answer altered
where the model produces it, one image of each batch altered where the
featurizer produces it, and kernel B3 in one TF32 pass where the
configuration states 3xTF32.  Used by the tests (on the CPU) and by
``calibrate.py --fault`` (on the card); never by the benchmark's runs.  Each installs itself with a pytest-style
``monkeypatch`` (``setattr(obj, name, value)``)."""

from __future__ import annotations

import torch

__all__ = ["FAULTS"]


def state_unchanged(mp) -> None:
    """Every window is decided from the state its stream had before it."""
    from mmla_audio_torch.streaming import session
    from mmla_audio_torch.vad.native import NativeWebRtcVad

    real_rows = session.webrtc_vad_rows
    mp.setattr(session, "webrtc_vad_rows", lambda x, states, idx, **kw:
               real_rows(x, states.clone(), idx, **kw))
    real = NativeWebRtcVad.decisions

    def decisions(self, *a, **kw):
        saved = self.state_array
        out = real(self, *a, **kw)
        self.state_array = saved
        return out
    mp.setattr(NativeWebRtcVad, "decisions", decisions)


def denoise_bf16(mp) -> None:
    """The denoised window rounded to bfloat16 before its PCM16 round
    trip: the denoise at the precision below its own."""
    from mmla_audio_torch.streaming import session

    real = session.reduce_noise
    mp.setattr(session, "reduce_noise", lambda *a, **kw: real(*a, **kw).to(
        torch.bfloat16).to(torch.float32))


def half_batch(mp) -> None:
    """The second half of each batch's rows is never logged."""
    from mmla_audio_torch.streaming.multiplex import Multiplexer

    real = Multiplexer._resolve
    mp.setattr(Multiplexer, "_resolve", lambda self, inflight: real(
        self, (inflight[0][: (len(inflight[0]) + 1) // 2], inflight[1])))


def answer_altered(mp) -> None:
    """The first logit of every window is moved by a tenth of the batch's
    largest."""
    from mmla_audio_torch.inference import OverlapPredictor, SpeakerPredictor

    for cls in (OverlapPredictor, SpeakerPredictor):
        real = cls.apply_model

        def apply_model(self, x, model=None, _real=real):
            logits = _real(self, x, model)
            bump = torch.zeros_like(logits[:1])
            bump[0, 0] = 0.1
            return logits + bump * logits.abs().amax()
        mp.setattr(cls, "apply_model", apply_model)


def feature_altered(mp) -> None:
    """The overlap image of the first row of each batch is moved by two
    levels on its first mel band (one window in 64 at bucket 64)."""
    import importlib

    from perfbench.kinds.overlap import FEATURIZERS

    for mod_name, name in FEATURIZERS:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, name)

        def featurize(*a, _real=real, **kw):
            img = _real(*a, **kw).clone()
            img[0, 0] = (img[0, 0] + 2.0).clamp(max=255.0)
            return img
        mp.setattr(mod, name, featurize)


def b3_tf32(mp) -> None:
    """Kernel B3's fused blocks in one TF32 pass (cuDNN's TF32
    convolutions) instead of the 3xTF32 the configuration states."""
    from mmla_audio_torch.models import overlap
    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_plain

    def fused(*a):
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return fused_resblock_plain(*a)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
    mp.setattr(overlap, "fused_resblock_cuda", fused)


FAULTS = {"state_unchanged": state_unchanged,
          "denoise_bf16": denoise_bf16, "half_batch": half_batch,
          "answer_altered": answer_altered,
          "feature_altered": feature_altered, "b3_tf32": b3_tf32}


class Patch:
    """A minimal ``monkeypatch`` for scripts: ``undo`` restores."""

    def __init__(self):
        self._saved = []

    def setattr(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)
