"""Port VAD gating vs ``mmla_audio_tpu.vad``: the collector and trim must be
exactly equal on seeded decision patterns; the port's native binding must
give the decisions of the JAX package's pure engine (``vad/webrtc.py``),
with the state carried across calls.  No port test loads the JAX package's
native library: its build is the JAX package's own (an in-place ``make``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.vad import collector as jax_collector
from mmla_audio_torch.vad import collector, native
from tests.conftest import synth_speech_i16

torch.set_num_threads(1)


def _patterns():
    rng = np.random.RandomState(0)
    runs = np.repeat(rng.rand(12) < 0.6, rng.randint(1, 15, 12))[:85]
    return {
        "random": rng.rand(85) < 0.5,
        "mostly_voiced": rng.rand(85) < 0.92,
        "runs": np.pad(runs, (0, 85 - len(runs))),
        "all_voiced": np.ones(85, bool),
        "silent": np.zeros(85, bool),
    }


@pytest.mark.parametrize("name", list(_patterns()))
def test_collect_mask_exact(name):
    speech = _patterns()[name]
    for n_valid in (85, 40, 9):
        valid = np.arange(85) < n_valid
        got = collector.collect_mask(torch.from_numpy(speech),
                                     torch.from_numpy(valid)).numpy()
        ref = np.asarray(jax_collector.collect_mask(jnp.asarray(speech),
                                                    jnp.asarray(valid)))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [40960, 30001, 4800, 500])
def test_vad_trim_exact(n):
    buf = synth_speech_i16(40960, seed=4).astype(np.float32)
    speech = _patterns()["runs"]
    got, got_n = collector.vad_trim(torch.from_numpy(buf), n,
                                    torch.from_numpy(speech))
    ref, ref_n = jax_collector.vad_trim(jnp.asarray(buf), jnp.asarray(n),
                                        jnp.asarray(speech))
    assert got_n == int(ref_n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_energy_vad_and_threshold_match():
    noise = (np.random.RandomState(5).randn(160000) * 20).astype(np.int16)
    thr = collector.calibrate_threshold(noise)
    assert thr == jax_collector.calibrate_threshold(noise)
    frames = synth_speech_i16(40800, seed=6).reshape(85, 480)
    frames[::3] //= 200
    np.testing.assert_array_equal(
        collector.energy_vad(torch.from_numpy(frames), thr).numpy(),
        np.asarray(jax_collector.energy_vad(jnp.asarray(frames), thr)))


def test_native_decisions_match_jax_engine():
    from mmla_audio_tpu.vad.webrtc import webrtc_init, webrtc_vad_frames

    assert native.native_available()
    stream = np.concatenate([synth_speech_i16(48000, seed=7),
                             np.zeros(9600, np.int16),
                             synth_speech_i16(24000, seed=8) // 8])
    ours, state = native.NativeWebRtcVad(3), webrtc_init()
    decided = []
    for chunk in np.array_split(stream, 4):     # state carries across calls
        chunk = chunk[: len(chunk) // 480 * 480]
        ref, state = webrtc_vad_frames(jnp.asarray(chunk.astype(np.int32)),
                                       state, mode=3)
        got = ours.decisions(chunk)
        np.testing.assert_array_equal(got, np.asarray(ref))
        decided.append(got)
    decided = np.concatenate(decided)
    assert decided.any() and not decided.all()


def test_port_tests_load_no_jax_native_library():
    """The JAX package builds ``libmmla_host.so`` with an in-place ``make``
    that concurrent test workers can race; the port's tests reach the JAX
    package's engines only through its pure-JAX modules."""
    pattern = re.compile(r"mmla_audio_tpu\.(vad|streaming)\.native\b|"
                         r"from mmla_audio_tpu\.(vad|streaming) import native")
    tests = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert len(tests) >= 10
    assert [p.name for p in tests if pattern.search(p.read_text())] == []
