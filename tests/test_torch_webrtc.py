"""The port's batched webrtcvad over stacked detector rows
(``mmla_audio_torch.vad.webrtc``) and its batched trim
(``vad/collector.py::vad_collect_rows``, ``vad_trim_batch``) against the JAX
package: decisions and every state slot bit for bit against the JAX engine
gathered and scattered by index as the JAX multiplexer does, and against
the transcription golden.  On the CPU the wrappers run their plain versions
(the native host engine per row, ``collect_mask`` per row); the kernels W1
and W2 are held against those on the card (``tests/test_torch_cuda.py``).
A Python model of W2's warp kernel (32-frame ballot words, the ring's count
as a popcount of the last two words, the trigger machine, the keep bitmask
written a word at a time) is held equal to ``collect_mask``, and the plain
version to the independent golden ``tests/golden/vad_ref.py``."""

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
from tests.golden.vad_ref import vad_collector_indices
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


def _w2_warp_model(row, n_valid: int, ring: int = 10) -> np.ndarray:
    """``vad_collect_warp_kernel`` on one row of decisions (a ring of 1 ...
    32 frames): word w is the ballot of frames 32 w ... 32 w + 31 that are
    voiced and exist; bits 0-31 of ``dbits``/``kbits`` hold word w - 1 and
    bits 32-63 word w; the ring's voiced count is the popcount of the two
    words masked to frames [max(start, i - ring + 1), i]; a trigger sets
    the ring's keep bits at once; a word's keep bits are final once the
    machine has left it.  Returns keep ``(T,)`` bool."""
    T = len(row)
    nv = min(max(int(n_valid), 0), T)
    keep = np.zeros(T, bool)
    dbits = kbits = 0
    triggered, start = False, 0
    thresh = 0.9 * ring

    def flush(word: int, bits: int) -> None:
        for lane in range(32):
            if 32 * word + lane < T:
                keep[32 * word + lane] = bool(bits >> lane & 1)

    words = -(-T // 32)
    for w in range(words):
        base = 32 * w
        ballot = sum(1 << lane for lane in range(32)
                     if base + lane < nv and row[base + lane])
        dbits |= ballot << 32
        for i in range(base, min(base + 32, nv)):
            p = i - base + 32
            q = max(start, i - ring + 1) - base + 32
            assert 1 <= q <= p <= 63
            win = ((1 << (p + 1)) - 1) & ~((1 << q) - 1)
            voiced = bin(dbits & win).count("1")
            if not triggered:
                if voiced > thresh:
                    triggered, start = True, i + 1
                    kbits |= win
            else:
                kbits |= 1 << p
                if (p - q + 1 - voiced) > thresh:
                    triggered, start = False, i + 1
        if w > 0:
            flush(w - 1, kbits & 0xFFFFFFFF)
        dbits >>= 32
        kbits >>= 32
    if words:
        flush(words - 1, kbits & 0xFFFFFFFF)
    return keep


def _collect_ref(row, n_valid: int, ring: int = 10) -> np.ndarray:
    T = len(row)
    return collector.collect_mask(torch.from_numpy(np.asarray(row, bool)),
                                  torch.arange(T) < int(n_valid),
                                  ring).numpy()


def _valid_cases(T: int) -> tuple:
    """n_valid: negative, 0, 1, T and past T."""
    return (-3, 0, 1, T, T + 7)


@pytest.mark.parametrize("frames", [1, 31, 32, 33, 85, 1000])
def test_w2_warp_model_matches_collect_mask(frames):
    """The warp kernel's bitmask algorithm equals ``collect_mask`` at every
    n_valid case, on random rows of several densities, runs, alternation,
    all voiced and none, at rings of 1, 10 and 32 frames."""
    rng = np.random.RandomState(frames)
    runs = np.repeat(rng.rand(200) < 0.6, rng.randint(1, 25, 200))
    rows = [rng.rand(frames) < p for p in (0.2, 0.5, 0.8, 0.95)] + [
        np.resize(runs, frames), np.arange(frames) % 2 == 0,
        np.ones(frames, bool), np.zeros(frames, bool)]
    kept = 0
    for row in rows:
        for nv in _valid_cases(frames) + (int(rng.randint(0, frames + 1)),):
            for ring in (1, 10, 32):
                got = _w2_warp_model(row, nv, ring)
                np.testing.assert_array_equal(got, _collect_ref(row, nv,
                                                                ring))
                kept += int(got.sum())
    assert kept > 0


@pytest.mark.parametrize("seed", range(12))
def test_w2_warp_model_random_patterns(seed):
    """The IID patterns of ``tests/test_exactness_extra.py``'s
    ``test_collect_mask_pure_random_patterns``, through the warp kernel's
    model, against ``collect_mask`` and the golden."""
    rng = np.random.RandomState(100 + seed)
    T = rng.randint(10, 200)
    is_speech = rng.rand(T) < rng.choice([0.2, 0.5, 0.8, 0.95])
    expect = np.zeros(T, bool)
    expect[vad_collector_indices(list(is_speech))] = True
    np.testing.assert_array_equal(_w2_warp_model(is_speech, T), expect)
    np.testing.assert_array_equal(_collect_ref(is_speech, T), expect)


def test_w2_warp_model_alternating_edge():
    pattern = np.array([True, False] * 40)
    expect = np.zeros(80, bool)
    expect[vad_collector_indices(list(pattern))] = True
    np.testing.assert_array_equal(_w2_warp_model(pattern, 80), expect)


@pytest.mark.parametrize("seed", range(6))
def test_collect_rows_plain_matches_golden(seed):
    """``vad_collect_rows_plain`` against the independent transcription of
    the reference's collector (``tests/golden/vad_ref.py``): the random
    patterns of ``tests/test_exactness_extra.py`` and the alternating edge,
    each row cut at its n_valid (the golden sees only the frames that
    exist)."""
    rng = np.random.RandomState(200 + seed)
    T = int(rng.randint(10, 200))
    rows = [rng.rand(T) < p for p in (0.2, 0.5, 0.8, 0.95)] + [
        np.arange(T) % 2 == 0]
    n_valid = [T, int(rng.randint(0, T + 1)), 0, T + 3, -1]
    keep, kept = collector.vad_collect_rows_plain(
        torch.from_numpy(np.stack(rows)),
        torch.tensor(n_valid, dtype=torch.int32))
    for b, (row, nv) in enumerate(zip(rows, n_valid)):
        expect = np.zeros(T, bool)
        expect[vad_collector_indices(list(row[:max(nv, 0)]))] = True
        np.testing.assert_array_equal(keep[b].numpy(), expect)
        assert int(kept[b]) == int(expect.sum())
    assert int(kept.sum()) > 0
