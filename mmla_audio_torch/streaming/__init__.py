"""See the counterpart subpackage of ``mmla_audio_tpu``."""

from mmla_audio_torch.streaming.capture import (
    ArraySource,
    CaptureThread,
    FakePCMSource,
    PrefilledCapture,
)
from mmla_audio_torch.streaming.multiplex import Multiplexer, Stream
from mmla_audio_torch.streaming.native import (
    BatchGather,
    NativeRingBuffer,
    PyRingBuffer,
    load_native,
    make_ring,
)
from mmla_audio_torch.streaming.session import (
    OverlapSession,
    SpeakerSession,
    StreamingSession,
    WavLMSession,
    preprocess_window,
    preprocess_windows,
    session_stamp,
)

__all__ = [
    "ArraySource",
    "CaptureThread",
    "FakePCMSource",
    "PrefilledCapture",
    "Multiplexer",
    "Stream",
    "BatchGather",
    "NativeRingBuffer",
    "PyRingBuffer",
    "load_native",
    "make_ring",
    "OverlapSession",
    "SpeakerSession",
    "StreamingSession",
    "WavLMSession",
    "preprocess_window",
    "preprocess_windows",
    "session_stamp",
]
