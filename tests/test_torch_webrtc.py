"""The port's batched webrtcvad over stacked detector rows
(``mmla_audio_torch.vad.webrtc``) and its batched trim
(``vad/collector.py::vad_collect_rows``, ``vad_trim_batch``) against the JAX
package: decisions and every state slot bit for bit against the JAX engine
gathered and scattered by index as the JAX multiplexer does, and against
the transcription golden.  On the CPU the wrappers run their plain versions
(the native host engine per row, ``collect_mask`` per row); the kernels W1
and W2 are held against those on the card (``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.vad import collector as jax_collector
from mmla_audio_tpu.vad.webrtc import webrtc_init as jax_init
from mmla_audio_tpu.vad.webrtc import webrtc_vad_frames
from mmla_audio_torch import _build
from mmla_audio_torch.vad import collector, webrtc
from mmla_audio_torch.vad.native import NativeWebRtcVad
from tests.conftest import synth_speech_i16
from tests.golden.webrtc_vad_ref import WebRtcVadRef

torch.set_num_threads(1)

FL, T = 480, 85
N = FL * T


def _windows(seed: int) -> np.ndarray:
    """(7, N) int16: speech, quiet speech, noise, silence, a full-scale
    square wave (the Q-format products wrap), speech with a silent gap,
    loud noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(N) / 16000
    gap = synth_speech_i16(N, seed=seed + 2)
    gap[N // 3: 2 * N // 3] = 0
    return np.stack([
        synth_speech_i16(N, seed=seed),
        synth_speech_i16(N, seed=seed + 1) // 16,
        (rng.randn(N) * 300).astype(np.int16),
        np.zeros(N, np.int16),
        np.where(np.sin(2 * np.pi * 180 * t) > 0, 32767,
                 -32768).astype(np.int16),
        gap,
        np.clip(rng.randn(N) * 12000, -32768, 32767).astype(np.int16),
    ])


@jax.jit
def _jax_rows(x, states, idx):
    """The JAX multiplexer's use of the engine: gather the rows by index
    (clamped), run the vmapped engine, scatter back (out of range dropped)."""
    n = states.frame_counter.shape[0]
    rows = jax.tree_util.tree_map(lambda a: a[jnp.clip(idx, 0, n - 1)],
                                  states)
    dec, new = jax.vmap(lambda w, st: webrtc_vad_frames(w, st, mode=3))(
        x, rows)
    states = jax.tree_util.tree_map(lambda a, b: a.at[idx].set(b, mode="drop"),
                                    states, new)
    return dec, states


def _as_rows(states) -> np.ndarray:
    return webrtc.state_rows_from_jax(
        {k: np.asarray(v) for k, v in states._asdict().items()})


def test_rows_match_jax_engine_bit_for_bit():
    """Two windows in a row on 6 state rows: row 4 gets no window, two
    batch rows are padding (index >= 6), the rows arrive out of order; the
    second call starts from adapted state."""
    idx = np.array([3, 0, 5, 6, 1, 2, 9], np.int32)
    ours = webrtc.webrtc_init(6, "cpu")
    theirs = jax_init((6,))
    for call in range(2):
        x = _windows(seed=10 * call + 1)
        got = webrtc.webrtc_vad_rows(torch.from_numpy(x), ours, idx)
        ref, theirs = _jax_rows(jnp.asarray(x.astype(np.int32)), theirs,
                                jnp.asarray(idx))
        ref = np.asarray(ref)
        assert got.dtype == torch.uint8 and got.shape == (7, T)
        valid = idx < 6
        np.testing.assert_array_equal(got.numpy()[valid], ref[valid])
        assert not got.numpy()[~valid].any()          # padding decides 0
        np.testing.assert_array_equal(ours.numpy(), _as_rows(theirs))
    # the untouched row is still a fresh engine; the others moved
    np.testing.assert_array_equal(ours[4].numpy(),
                                  webrtc.webrtc_init(1, "cpu")[0].numpy())
    assert got.numpy()[0].any() and not got.numpy()[3].all()
    assert (ours.numpy()[[0, 1, 2, 3, 5]]
            != ours.numpy()[4]).any(axis=1).all()


def _golden_rows(signals, mode, frame_len, sample_rate):
    """Decisions and state rows of one golden engine a signal."""
    decs, rows = [], []
    for sig in signals:
        v = WebRtcVadRef(mode)
        decs.append([v.is_speech(sig[i * frame_len: (i + 1) * frame_len],
                                 sample_rate)
                     for i in range(len(sig) // frame_len)])
        rows.append(np.concatenate([
            v.downsampling_filter_states, v.upper_state, v.lower_state,
            v.hp_filter_state, v.noise_means, v.speech_means, v.noise_stds,
            v.speech_stds, v.low_value_vector, v.index_vector, v.mean_value,
            [v.frame_counter, v.over_hang, v.num_of_speech]]))
    return np.array(decs, np.uint8), np.array(rows, np.int32)


@pytest.mark.parametrize("mode,frame_len,sample_rate", [
    (3, 480, 16000), (0, 160, 16000), (2, 240, 8000)])
def test_rows_match_golden(mode, frame_len, sample_rate):
    x = _windows(seed=4)[[0, 4, 6], : 10 * frame_len]
    states = webrtc.webrtc_init(3, "cpu")
    got = webrtc.webrtc_vad_rows(torch.from_numpy(x), states,
                                 np.arange(3), mode=mode,
                                 frame_len=frame_len, sample_rate=sample_rate)
    ref_dec, ref_rows = _golden_rows(x, mode, frame_len, sample_rate)
    np.testing.assert_array_equal(got.numpy(), ref_dec)
    np.testing.assert_array_equal(states.numpy(), ref_rows)


def test_state_rows_round_trip():
    fresh = jax_init((2, 3))
    rows = webrtc.state_rows_from_jax(
        {k: np.asarray(v) for k, v in fresh._asdict().items()})
    assert rows.shape == (6, webrtc.WEBRTC_STATE_SLOTS)
    np.testing.assert_array_equal(rows, webrtc.webrtc_init(6, "cpu").numpy())
    adapted = np.asarray(webrtc.webrtc_init(2, "cpu")).copy()
    webrtc.webrtc_vad_rows(torch.from_numpy(_windows(seed=2)[:2]),
                           torch.from_numpy(adapted), [0, 1])
    back = webrtc.state_rows_to_jax(adapted)
    assert [k for k, _ in webrtc.STATE_FIELDS] == list(fresh._fields)
    for name, shape in webrtc.STATE_FIELDS:
        assert back[name].shape == (2,) + shape
    np.testing.assert_array_equal(webrtc.state_rows_from_jax(back), adapted)


def test_native_state_array_round_trip():
    """The host engine's state interchange: a state carried into a fresh
    engine decides the next window as the original engine does."""
    x = _windows(seed=3)
    a, b = NativeWebRtcVad(3), NativeWebRtcVad(3)
    a.decisions(x[0])
    b.state_array = a.state_array
    np.testing.assert_array_equal(b.state_array, a.state_array)
    np.testing.assert_array_equal(a.decisions(x[1]), b.decisions(x[1]))
    np.testing.assert_array_equal(b.state_array, a.state_array)
    with pytest.raises(ValueError, match="265 slots"):
        b.state_array = np.zeros(10, np.int32)


def test_rows_refuse_bad_calls():
    states = webrtc.webrtc_init(3, "cpu")
    x = torch.from_numpy(_windows(seed=1)[:3])
    with pytest.raises(ValueError, match="same state row"):
        webrtc.webrtc_vad_rows(x, states, [0, 1, 0])
    with pytest.raises(ValueError, match="non-negative"):
        webrtc.webrtc_vad_rows(x, states, [0, 1, -1])
    with pytest.raises(ValueError, match="frame length"):
        webrtc.webrtc_vad_rows(x, states, [0, 1, 2], frame_len=400)
    with pytest.raises(ValueError, match="int16"):
        webrtc.webrtc_vad_rows(x.float(), states, [0, 1, 2])
    # two padding rows may share an index; nothing is touched
    before = states.clone()
    webrtc.webrtc_vad_rows(x, states, [3, 3, 7])
    assert torch.equal(states, before)


def test_cpu_tensors_never_reach_a_kernel(monkeypatch):
    """The wrappers take their plain versions for CPU tensors: no CUDA
    library is asked for and no launch is counted."""
    def refuse(name):
        raise AssertionError(f"CPU tensors reached the {name} kernel")

    monkeypatch.setattr(_build, "cuda_library", refuse)
    launches = (webrtc.webrtc_vad_rows.launches,
                collector.vad_collect_rows.launches)
    states = webrtc.webrtc_init(2, "cpu")
    dec = webrtc.webrtc_vad_rows(torch.from_numpy(_windows(seed=5)[:2]),
                                 states, [1, 0])
    collector.vad_collect_rows(dec, torch.tensor([85, 40], dtype=torch.int32))
    assert (webrtc.webrtc_vad_rows.launches,
            collector.vad_collect_rows.launches) == launches


def _patterns(rng):
    runs = np.repeat(rng.rand(12) < 0.6, rng.randint(1, 15, 12))[:T]
    return np.stack([rng.rand(T) < 0.5, rng.rand(T) < 0.92,
                     np.pad(runs, (0, T - len(runs))), np.ones(T, bool),
                     np.zeros(T, bool)])


def test_collect_rows_match_collect_mask():
    rng = np.random.RandomState(0)
    dec = _patterns(rng)
    n_valid = np.array([85, 40, 9, 0, 85], np.int32)
    keep, kept = collector.vad_collect_rows(
        torch.from_numpy(dec.astype(np.uint8)), torch.from_numpy(n_valid))
    for b in range(len(dec)):
        ref = np.asarray(jax_collector.collect_mask(
            jnp.asarray(dec[b]), jnp.asarray(np.arange(T) < n_valid[b])))
        np.testing.assert_array_equal(keep[b].numpy(), ref)
        assert int(kept[b]) == int(ref.sum())


@pytest.mark.parametrize("n", [40960, 30001, 4800, 500])
def test_vad_trim_batch_matches_jax_per_row(n):
    rng = np.random.RandomState(n)
    dec = _patterns(rng)
    buf = np.stack([synth_speech_i16(40960, seed=s) for s in range(5)]) \
        .astype(np.float32)
    counts = np.array([n, n, 40960, n, 3000], np.int32)
    got, got_n = collector.vad_trim_batch(
        torch.from_numpy(buf), torch.from_numpy(counts),
        torch.from_numpy(dec))
    for b in range(5):
        ref, ref_n = jax_collector.vad_trim(
            jnp.asarray(buf[b]), jnp.asarray(counts[b]), jnp.asarray(dec[b]))
        assert int(got_n[b]) == int(ref_n)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))
