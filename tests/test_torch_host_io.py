"""The port's host IO against the JAX package's: the session logs' bounded
LRU of append handles (the counterpart of
``tests/test_log_resume.py::test_log_handle_lru_eviction``) and
``Multiplexer.remove_stream(close_log=)``; the WAV readers on malformed
input (every case of ``tests/test_wav_robustness.py``), the host library's
WAV round trip (``tests/test_streaming.py:68-89``) and ``read_wav_float``.

The native cases read the port's own ``libmmla_host.so``
(``streaming.native.load_native``), never the JAX package's; they skip
where the library cannot be built.
"""

import ctypes
import os
import struct
import wave
from datetime import datetime

import numpy as np
import pytest
import torch

from mmla_audio_tpu.analyze import logs as jax_logs
from mmla_audio_tpu.data.wavio import read_wav as jax_read_wav
from mmla_audio_tpu.data.wavio import read_wav_float as jax_read_wav_float
from mmla_audio_torch.analyze import logs as logs_mod
from mmla_audio_torch.analyze.logs import SessionLog, parse_log
from mmla_audio_torch.data.wavio import read_wav, read_wav_float, write_wav
from mmla_audio_torch.streaming.native import load_native
from tests.conftest import synth_speech_i16

TS = datetime(2026, 1, 2, 3, 4, 5)


# -- the handle LRU ----------------------------------------------------------
def _open_fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_log_handle_lru_eviction(tmp_path):
    """More logs than the cap: at most ``_MAX_OPEN_HANDLES`` stay open, an
    evicted log reopens in append mode on its next write, and the bytes are
    the JAX package's for the same writes."""
    assert logs_mod._MAX_OPEN_HANDLES == jax_logs._MAX_OPEN_HANDLES == 128
    n = logs_mod._MAX_OPEN_HANDLES + 40
    fds = _open_fds()
    ours = [SessionLog(tmp_path / "port" / f"log{i}.txt") for i in range(n)]
    theirs = [jax_logs.SessionLog(tmp_path / "jax" / f"log{i}.txt")
              for i in range(n)]
    for i, (a, b) in enumerate(zip(ours, theirs)):
        a.append(str(i % 3), TS)
        b.append(str(i % 3), TS)
    assert len(logs_mod._OPEN_HANDLES) == logs_mod._MAX_OPEN_HANDLES
    assert id(ours[0]) not in logs_mod._OPEN_HANDLES        # evicted
    ours[0].append("1", TS)                                # reopened
    theirs[0].append("1", TS)
    ours[1].append_batch(["a", "b"], TS, 1.5)
    theirs[1].append_batch(["a", "b"], TS, 1.5)
    for i in (0, 1, n - 1):
        rows = parse_log(ours[i].path)
        assert rows and rows[0][0] == 1
        assert ours[i].path.read_bytes() == theirs[i].path.read_bytes()
    assert len(parse_log(ours[0].path)) == 2                # one header
    for log in ours + theirs:
        log.close()
    assert not logs_mod._OPEN_HANDLES
    assert _open_fds() <= fds
    ours[2].append("x", TS)                     # a closed log reopens too
    assert [r[1] for r in parse_log(ours[2].path)] == ["2", "x"]
    ours[2].close()


def test_live_log_is_readable_and_freed(tmp_path):
    """Each write is flushed (a reader sees it while the handle is open);
    a collected log releases its handle."""
    log = SessionLog(tmp_path / "live.txt", kind="speaker")
    log.ensure_header()
    log.append("alice", TS)
    assert parse_log(log.path) == [(1, "alice", str(TS))]
    key = id(log)
    assert key in logs_mod._OPEN_HANDLES
    del log
    assert key not in logs_mod._OPEN_HANDLES


def test_overlap_labels_3way_match_jax():
    assert logs_mod.OVERLAP_LABELS_3WAY == jax_logs.OVERLAP_LABELS_3WAY
    assert logs_mod.OVERLAP_LABELS == jax_logs.OVERLAP_LABELS


@pytest.mark.parametrize("close_log", [True, False])
def test_remove_stream_close_log(tmp_path, close_log):
    """``remove_stream`` closes the retired stream's handle unless
    ``close_log=False``; a window still in flight resolves to its log
    either way."""
    from mmla_audio_torch.inference import Predictor
    from mmla_audio_torch.streaming.multiplex import Multiplexer
    from tests.test_torch_multiplex import _noise, _Windows

    class _Pred(Predictor):
        kind = "overlap"
        device = torch.device("cpu")

    mux = Multiplexer(_Pred(), tmp_path / "exp", device="cpu")
    stream = mux.add_stream("a", _Windows([]), _noise())
    stream.log.append("overlapped", TS)
    assert id(stream.log) in logs_mod._OPEN_HANDLES
    mux.remove_stream(stream, close_log=close_log, archive=False)
    assert (id(stream.log) in logs_mod._OPEN_HANDLES) != close_log
    stream.log.append("silent", TS)
    assert [r[1] for r in parse_log(stream.log.path)] == ["overlapped",
                                                          "silent"]
    stream.log.close()


# -- WAV ---------------------------------------------------------------------
def _native():
    lib = load_native()
    if lib is None:
        pytest.skip("the host library cannot be built here")
    return lib


def _native_read(lib, path):
    """(count, rate, samples) from ``wav_read``; samples freed."""
    out = ctypes.POINTER(ctypes.c_int16)()
    rate = ctypes.c_int32()
    n = lib.wav_read(str(path).encode(), ctypes.byref(out),
                     ctypes.byref(rate))
    samples = None
    if n >= 0:
        samples = np.ctypeslib.as_array(out, shape=(n,)).copy() if n else \
            np.zeros(0, np.int16)
        lib.wav_free(out)
    return n, rate.value, samples


def _pcm_header(body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def _bad_files(tmp_path):
    """name -> a malformed file (the native cases of test_wav_robustness)."""
    sig = synth_speech_i16(4000, seed=0)
    write_wav(tmp_path / "ok.wav", sig)
    raw = (tmp_path / "ok.wav").read_bytes()
    data = b"\x00" * 100
    files = {
        "not_a_wav": b"this is not a riff file at all",
        "truncated_header": b"RI",
        "wrong_bits": _pcm_header(
            b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 16000, 1, 8)
            + b"data" + struct.pack("<I", len(data)) + data),
        "truncated_data": raw[: len(raw) // 2],
    }
    paths = {}
    for name, content in files.items():
        paths[name] = tmp_path / f"{name}.wav"
        paths[name].write_bytes(content)
    paths["missing"] = tmp_path / "nope.wav"
    return paths


@pytest.mark.parametrize("case", ["not_a_wav", "truncated_header",
                                  "missing", "wrong_bits",
                                  "truncated_data"])
def test_native_rejects_malformed(tmp_path, case):
    assert _native_read(_native(), _bad_files(tmp_path)[case])[0] < 0


def test_native_extra_chunks_skipped(tmp_path):
    """LIST/INFO chunks before data are skipped."""
    sig = synth_speech_i16(1000, seed=1)
    data = sig.tobytes()
    body = (b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
            + b"LIST" + struct.pack("<I", 4) + b"INFO"
            + b"data" + struct.pack("<I", len(data)) + data)
    p = tmp_path / "chunks.wav"
    p.write_bytes(_pcm_header(body))
    n, rate, back = _native_read(_native(), p)
    assert n == len(sig) and rate == 16000
    np.testing.assert_array_equal(back, sig)


def test_native_wav_round_trip(tmp_path):
    """``wav_write`` then ``wav_read``, and both stdlib readers."""
    lib = _native()
    sig = synth_speech_i16(12345, seed=0)
    p = tmp_path / "n.wav"
    arr = np.ascontiguousarray(sig)
    assert lib.wav_write(str(p).encode(),
                         arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                         len(sig), 16000) == 0
    n, rate, back = _native_read(lib, p)
    assert n == len(sig) and rate == 16000
    np.testing.assert_array_equal(back, sig)
    for reader in (read_wav, jax_read_wav):
        got, r = reader(p)
        assert r == 16000
        np.testing.assert_array_equal(got, sig)


def test_python_reader_rejects_garbage(tmp_path):
    p = tmp_path / "g.wav"
    p.write_bytes(b"garbage" * 10)
    with pytest.raises(wave.Error):
        read_wav(p)


def test_python_reader_rejects_bad_rate(tmp_path):
    with wave.open(str(tmp_path / "rate.wav"), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(44100)
        wf.writeframes(b"\x00\x00" * 100)
    with pytest.raises(ValueError, match="unsupported rate"):
        read_wav(tmp_path / "rate.wav")


def test_python_reader_sampwidth_and_stereo(tmp_path):
    """8-bit PCM is refused; stereo keeps channel 0."""
    with wave.open(str(tmp_path / "w8.wav"), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(1)
        wf.setframerate(16000)
        wf.writeframes(bytes(64))
    with pytest.raises(ValueError, match="16-bit"):
        read_wav(tmp_path / "w8.wav")
    left = np.arange(100, dtype=np.int16)
    inter = np.empty(200, np.int16)
    inter[0::2], inter[1::2] = left, -left
    with wave.open(str(tmp_path / "st.wav"), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes(inter.tobytes())
    data, rate = read_wav(tmp_path / "st.wav")
    assert rate == 16000
    np.testing.assert_array_equal(data, left)


def test_write_wav_float_and_mono_guard(tmp_path):
    y = np.linspace(-1.0, 1.0, 64).astype(np.float32)
    write_wav(tmp_path / "f.wav", y)
    data, _ = read_wav(tmp_path / "f.wav")
    np.testing.assert_array_equal(data, (y * 32767.0).astype(np.int16))
    with pytest.raises(ValueError, match="mono"):
        write_wav(tmp_path / "bad.wav", np.zeros((10, 2), np.int16))


def test_read_wav_float_matches_jax(tmp_path):
    """int16 / 32768 as float32, the rate: equal to JAX's bit for bit."""
    sig = synth_speech_i16(5000, seed=2)
    sig[:3] = (-32768, 32767, 0)
    write_wav(tmp_path / "x.wav", sig, 8000)
    got, rate = read_wav_float(tmp_path / "x.wav")
    ref, ref_rate = jax_read_wav_float(tmp_path / "x.wav")
    assert got.dtype == np.float32 and rate == ref_rate == 8000
    np.testing.assert_array_equal(got, ref)
    assert got[0] == -1.0 and got[1] < 1.0
