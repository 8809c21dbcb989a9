"""The port builds its host engine (webrtcvad, ring buffer, WAV IO) from its
own copies of the JAX package's C++ sources, unchanged."""

from pathlib import Path

import pytest

from mmla_audio_torch import _build

ROOT = Path(__file__).resolve().parent.parent


def test_host_sources_lie_in_the_port():
    port = ROOT / "mmla_audio_torch"
    assert _build.HOST_SOURCES
    for src in _build.HOST_SOURCES:
        assert src.resolve().is_relative_to(port), src


@pytest.mark.parametrize("name", ["ringbuffer.cpp", "wavio.cpp",
                                  "webrtcvad.cpp"])
def test_host_source_copies_match_jax(name):
    copy = next(s for s in _build.HOST_SOURCES if s.name == name)
    original = ROOT / "mmla_audio_tpu" / "native" / name
    assert copy.read_bytes() == original.read_bytes()
