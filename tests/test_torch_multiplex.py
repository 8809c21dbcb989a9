"""The port's multi-stream ``Multiplexer`` on the CPU: against the JAX
package's ``Multiplexer`` on the same weights and audio (labels, and the
stacked webrtcvad rows bit for bit), against the port's single-stream
session, and the cases of ``tests/test_multiplex.py`` that need no mesh
(bucket ladder, round-robin, ``min_fill``, row recycling and churn bounds,
the calibration cache, Python against native gather).

The JAX multiplexers are fed ring-less captures, which take its Python poll
loop: its native gather would load the JAX package's own library."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core import config as jax_config
from mmla_audio_tpu.inference import OverlapPredictor as JaxOverlapPredictor
from mmla_audio_tpu.inference import SpeakerPredictor as JaxSpeakerPredictor
from mmla_audio_tpu.streaming.multiplex import Multiplexer as JaxMultiplexer
from mmla_audio_tpu.vad.webrtc import webrtc_init as jax_webrtc_init
from mmla_audio_tpu.vad.webrtc import webrtc_vad_frames
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.analyze.logs import (OVERLAP_HEADER, SPEAKER_HEADER,
                                           parse_log)
from mmla_audio_torch.inference import (OverlapPredictor, SpeakerPredictor,
                                        WavLMPredictor)
from mmla_audio_torch.ops.denoise import quantize_i16, reduce_noise
from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                     speaker_state_dict_from_jax)
from mmla_audio_torch.streaming import multiplex as mx
from mmla_audio_torch.streaming.capture import (ArraySource, CaptureThread,
                                                PrefilledCapture)
from mmla_audio_torch.streaming.multiplex import Multiplexer
from mmla_audio_torch.streaming.session import (OverlapSession,
                                                SpeakerSession, WavLMSession,
                                                preprocess_windows)
from mmla_audio_torch.vad import webrtc
from tests.conftest import synth_speech_i16
from tests.test_torch_model import as_port, perturbed_tree
from tests.test_torch_speaker import perturbed_speaker_tree

torch.set_num_threads(1)

WIN = 40960
# narrow widths; input_scale 1/255 keeps the narrow model's LSTM out of
# saturation, so its probabilities depend on the window
CFG = jax_config.OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                                    input_scale=1 / 255)
SPEAKER = jax_config.SpeakerModelConfig(stage_filters=(8, 8, 16),
                                        lstm_units=8)
PORT_CFG = port_config.PipelineConfig(overlap_model=as_port(CFG))


def _noise(seed=0, amp=15):
    return (np.random.RandomState(seed).randn(160000) * amp).astype(np.int16)


class _Windows:
    """A ring-less capture handing out whole queued windows (both packages'
    multiplexers poll it through ``read_window``)."""

    def __init__(self, windows):
        self._w = list(windows)
        self.source = self

    @property
    def exhausted(self):
        return not self._w

    def read_window(self, n_samples, timeout=0.0):
        if not self._w:
            return None
        w = self._w.pop(0)
        assert len(w) == n_samples
        return w

    def stop(self):
        pass


@pytest.fixture(scope="module")
def overlap():
    """(JAX predictor, port predictor) of one perturbed narrow tree."""
    tree = perturbed_tree(CFG, seed=1)
    return (JaxOverlapPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                                model_cfg=CFG),
            OverlapPredictor(overlap_state_dict_from_jax(tree, as_port(CFG)),
                             as_port(CFG), device="cpu",
                             matmul_precision="highest"))


@pytest.fixture(scope="module")
def speaker():
    """A narrow speaker model with a 2-speaker sigmoid head, both packages."""
    tree = perturbed_speaker_tree(SPEAKER, head_units=2, seed=7)
    return (JaxSpeakerPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                                model_cfg=SPEAKER, head_units=2,
                                sigmoid_head=True),
            SpeakerPredictor(
                speaker_state_dict_from_jax(tree, as_port(SPEAKER), 2),
                as_port(SPEAKER), head_units=2, sigmoid_head=True,
                device="cpu"))


@pytest.fixture(scope="module")
def wavlm():
    """The tiny WavLM of ``tests/test_torch_wavlm.py``, the port's only."""
    from tests.test_torch_wavlm import TINY, seeded_state_dict

    return None, WavLMPredictor(seeded_state_dict(), TINY, device="cpu")


SESSIONS = {"overlap": OverlapSession, "speaker": SpeakerSession,
            "wavlm": WavLMSession}


def _conversations():
    """Three streams of three windows: speech, one silent window, speech at
    a quieter level."""
    return [[synth_speech_i16(WIN, seed=3 * s + w) // (1 + 3 * (w == 2))
             if (s + w) % 4 else np.zeros(WIN, np.int16)
             for w in range(3)] for s in range(3)]


def _serve_both(preds, kind, jax_cfg, port_cfg, tmp_path, bucket=2):
    """The same conversations and noise profiles through both packages'
    multiplexers (the port's streams on native rings)."""
    convs = _conversations()
    noises = [_noise(seed=s) for s in range(len(convs))]
    muxes = []
    for cls, pred, cfg, cap, extra in (
            (JaxMultiplexer, preds[0], jax_cfg, _Windows, {}),
            (Multiplexer, preds[1], port_cfg,
             lambda ws: PrefilledCapture(np.concatenate(ws)),
             {"device": "cpu"})):
        mux = cls(pred, tmp_path / cls.__module__, kind=kind, bucket=bucket,
                  cfg=cfg, **extra)
        for s, (ws, noise) in enumerate(zip(convs, noises)):
            mux.add_stream(f"s{s}", cap(ws), noise)
        assert mux.run_until_exhausted() == 9
        muxes.append(mux)
    return muxes


@pytest.mark.parametrize("kind,decision", [
    ("speaker", "webrtc"), ("overlap", "energy"), ("speaker", "energy")])
def test_matches_jax_multiplexer(overlap, speaker, kind, decision, tmp_path):
    """Labels per stream equal the JAX multiplexer's, and with webrtc the
    stacked detector rows equal JAX's bit for bit.  The live denoise is set
    to 0 passes here, so both packages hand the detector the same int16
    windows (the denoise is held against JAX within one quantization step by
    test_torch_denoise.py).  The overlap kind with webrtc runs the default
    chain in test_default_chain_matches_jax_multiplexer."""
    denoise = dataclasses.replace(jax_config.DenoiseConfig(), passes_live=0)
    vad = jax_config.VadConfig(decision=decision)
    jax_cfg = jax_config.PipelineConfig(overlap_model=CFG, denoise=denoise,
                                        vad=vad)
    port_cfg = dataclasses.replace(PORT_CFG, denoise=as_port(denoise),
                                   vad=as_port(vad))
    preds = overlap if kind == "overlap" else speaker
    ref, ours = _serve_both(preds, kind, jax_cfg, port_cfg, tmp_path)
    labels = [[r[1] for r in s.results] for s in ours.streams]
    assert labels == [[r[1] for r in s.results] for s in ref.streams]
    assert any("silent" in ls for ls in labels)
    assert any(lab != "silent" for ls in labels for lab in ls)
    for s in ours.streams:
        assert [r[:2] for r in parse_log(s.log.path)] == \
            [(i + 1, lab) for i, lab in enumerate(labels[s.index])]
    if decision == "webrtc":
        rows = webrtc.state_rows_from_jax({
            k: np.asarray(v) for k, v in ref._webrtc_states._asdict().items()})
        np.testing.assert_array_equal(ours._webrtc_states.numpy(), rows)
        assert ours._webrtc_n == ref._webrtc_n == 3
    else:
        assert ours._webrtc_states is None


def test_default_chain_matches_jax_multiplexer(overlap, tmp_path):
    """At the default live denoise the two packages' int16 windows may
    differ by one quantization step in a few samples, so each stream's
    detector row is held bit for bit against JAX's engine run over the
    port's own denoised windows; the labels against JAX's multiplexer."""
    ref, ours = _serve_both(overlap, "overlap",
                            jax_config.PipelineConfig(overlap_model=CFG),
                            PORT_CFG, tmp_path)
    assert [[r[1] for r in s.results] for s in ours.streams] == \
        [[r[1] for r in s.results] for s in ref.streams]
    frames = 85 * 480
    engine = jax.jit(webrtc_vad_frames, static_argnames=("mode",))
    for s, windows in zip(ours.streams, _conversations()):
        state = jax_webrtc_init()
        for w in windows:
            y = reduce_noise(torch.from_numpy(w.astype(np.float32)) / 32768.0,
                             torch.from_numpy(s.noise_thresh),
                             PORT_CFG.denoise,
                             passes=PORT_CFG.denoise.passes_live)
            i16 = quantize_i16(y).numpy()[:frames].astype(np.int32)
            _, state = engine(jnp.asarray(i16), state, mode=3)
        row = webrtc.state_rows_from_jax(
            {k: np.asarray(v) for k, v in state._asdict().items()})[0]
        np.testing.assert_array_equal(
            ours._webrtc_states[s.index].numpy(), row)


@pytest.mark.parametrize("decision", ["webrtc", "energy"])
def test_preprocess_windows_equals_single_window_chain(decision, tmp_path):
    """The batched chain (per-row denoise and energy thresholds, stacked
    detector rows, the keep masks' plain version, the batched compaction)
    equals each row through the single-window session chain, bit for bit,
    two windows in a row."""
    from mmla_audio_torch.streaming.session import StreamingSession

    cfg = dataclasses.replace(
        PORT_CFG, vad=port_config.VadConfig(decision=decision))
    windows = np.stack([synth_speech_i16(WIN, seed=s) for s in (1, 2, 3)])
    windows[1, :20000] = 0
    singles = []
    for s in range(3):
        sess = StreamingSession(None, tmp_path / f"s{s}", cfg=cfg,
                                device="cpu")
        sess.set_noise_profile(_noise(seed=s, amp=10 + 10 * s))
        singles.append(sess)
    idx = [2, 0, 3]
    states = webrtc.webrtc_init(4, "cpu") if decision == "webrtc" else None
    for _ in range(2):
        trimmed, n_out = preprocess_windows(
            torch.from_numpy(windows),
            torch.stack([s.noise_thresh for s in singles]),
            torch.tensor([s.vad_threshold_db for s in singles]), cfg,
            states=states, idx=idx if states is not None else None)
        for b, sess in enumerate(singles):
            ref, ref_n = sess.preprocess(windows[b])
            assert int(n_out[b]) == ref_n
            np.testing.assert_array_equal(trimmed[b].numpy(), ref.numpy())
    assert len(set(int(n) for n in n_out)) > 1
    if states is not None:
        for b, sess in enumerate(singles):
            np.testing.assert_array_equal(states[idx[b]].numpy(),
                                          sess._vad.state_array)
        np.testing.assert_array_equal(
            states[1].numpy(), webrtc.webrtc_init(1, "cpu")[0].numpy())


# -- the port on its own: the cases of tests/test_multiplex.py -------------

def _port_mux(overlap, tmp_path, n_streams=3, windows_each=2, bucket=4,
              **kw):
    mux = Multiplexer(overlap[1], tmp_path / "experiment", kind="overlap",
                      bucket=bucket, cfg=PORT_CFG, device="cpu", **kw)
    caps = []
    for s in range(n_streams):
        audio = np.concatenate([synth_speech_i16(WIN, seed=s * 10 + w)
                                for w in range(windows_each)])
        cap = CaptureThread(ArraySource(audio)).start()
        caps.append(cap)
        mux.add_stream(f"conv{s}", cap, _noise(seed=s))
    return mux, caps


def _stop(caps):
    for c in caps:
        c.stop()


def _spy_dispatch(mux):
    """Record (windows, bucket) of every dispatched batch."""
    dispatched = []
    orig = mux._dispatch_staged

    def spy():
        ready, fetch = orig()
        dispatched.append((len(ready), fetch.labels.shape[0]))
        return ready, fetch

    mux._dispatch_staged = spy
    return dispatched


def test_phase_counters_account_host_side_cost(overlap, tmp_path):
    mux, caps = _port_mux(overlap, tmp_path)
    total = mux.run_until_exhausted()
    _stop(caps)
    assert total == 6 and mux.windows_resolved == 6
    p = mux.phase_seconds
    assert all(v > 0.0 for v in p.values()), p
    assert mux.host_side_seconds() == \
        p["gather"] + p["stage"] + p["resolve_log"]
    mux.reset_phase_counters()
    assert mux.windows_resolved == 0
    assert all(v == 0.0 for v in mux.phase_seconds.values())


@pytest.mark.parametrize("kind", ["overlap", "speaker", "wavlm"])
def test_each_resolve_reads_its_own_batch(kind, request, tmp_path):
    """Every dispatched batch is resolved once, counted as ready or waited
    (on the CPU always ready), and each stream logs its labels in order:
    the labels its batches' programs returned, row for row."""
    pred = request.getfixturevalue(kind)[1]
    convs, noises = _conversations(), [_noise(seed=s) for s in range(3)]
    mux = Multiplexer(pred, tmp_path / "mux", bucket=2, cfg=PORT_CFG,
                      device="cpu")
    for s, (ws, noise) in enumerate(zip(convs, noises)):
        mux.add_stream(f"s{s}", PrefilledCapture(np.concatenate(ws)), noise)
    batches = []
    orig = mux._dispatch_staged

    def spy():
        ready, fetch = orig()
        batches.append((list(ready), fetch.labels.clone()))
        return ready, fetch

    mux._dispatch_staged = spy
    assert mux.run_until_exhausted() == 9
    assert mux._inflight is None
    assert (mux.fetch_ready, mux.fetch_waited) == (len(batches), 0)
    want = {id(s): [] for s in mux.streams}
    for ready, labels in batches:
        for i, stream in enumerate(ready):
            want[id(stream)].append(pred.label_name(int(labels[i]),
                                                    stream.label_names))
    for stream in mux.streams:
        assert [r[1] for r in stream.results] == want[id(stream)]
        assert [r[:2] for r in parse_log(stream.log.path)] == \
            [(i + 1, name) for i, name in enumerate(want[id(stream)])]


def test_inflight_record_sliced_logs_only_those_streams(overlap, tmp_path,
                                                        monkeypatch):
    """The in-flight record is ``(ready streams, fetch)``: resolving it with
    its streams sliced, as ``perfbench.faults.half_batch`` does, logs only
    those streams; the record is None whenever nothing is in flight."""
    from perfbench.faults import FAULTS

    mux = Multiplexer(overlap[1], tmp_path / "experiment", buckets=(4,),
                      cfg=PORT_CFG, device="cpu")
    for s in range(3):
        mux.add_stream(f"s{s}", PrefilledCapture(np.concatenate(
            [synth_speech_i16(WIN, seed=40 + 2 * s + w) for w in range(2)])),
            _noise(seed=s))
    assert mux._inflight is None and mux.tick() == 0
    record = mux._inflight
    assert isinstance(record, tuple) and len(record) == 2
    assert record[0] == mux.streams[:3] and record[1].labels.shape == (4,)
    FAULTS["half_batch"](monkeypatch)
    assert mux.tick() == 2                      # (3 + 1) // 2 of the batch
    assert [len(s.results) for s in mux.streams] == [1, 1, 0]
    logged = record[0][:2] + mux._inflight[0][:2]   # the gather rotates
    assert mux.flush() == 2
    assert mux._inflight is None
    want = [sum(s is t for t in logged) for s in mux.streams]
    assert [len(s.results) for s in mux.streams] == want != [2, 2, 2]
    assert [len(parse_log(s.log.path)) for s in mux.streams] == want
    assert mux.fetch_ready + mux.fetch_waited == 2


def test_multiplexer_overlap_streams(overlap, tmp_path):
    mux, caps = _port_mux(overlap, tmp_path)
    assert mux.run_until_exhausted() == 6
    _stop(caps)
    assert mux._batch_gather is not None          # native rings: one call
    for stream in mux.streams:
        assert len(stream.results) == 2
        rows = parse_log(stream.log.path)
        assert [r[0] for r in rows] == [1, 2]
        assert all(r[1] in ("non-overlapped", "overlapped", "silent")
                   for r in rows)
    assert len(list((tmp_path / "experiment" / "logs").glob("*.txt"))) == 3


@pytest.mark.parametrize("kind", ["overlap", "speaker", "wavlm"])
def test_matches_single_session(kind, request, tmp_path):
    """The batched chain and decision step equal the single-stream session
    of each kind, labels and the detector state (the session's native
    engine), window for window."""
    pred = request.getfixturevalue(kind)[1]
    convs, noises = _conversations(), [_noise(seed=s) for s in range(3)]
    mux = Multiplexer(pred, tmp_path / "mux", kind=kind, bucket=2,
                      cfg=PORT_CFG, device="cpu")
    for s, (ws, noise) in enumerate(zip(convs, noises)):
        mux.add_stream(f"s{s}", PrefilledCapture(np.concatenate(ws)), noise)
    assert mux.run_until_exhausted() == 9
    for s, stream in enumerate(mux.streams):
        cap = PrefilledCapture(np.concatenate(convs[s]))
        sess = SESSIONS[kind](pred, cap, tmp_path / f"single{s}",
                              cfg=PORT_CFG)
        sess.set_noise_profile(noises[s])
        single = [r[1] for r in sess.run(max_windows=3)]
        assert [r[1] for r in stream.results] == single
        np.testing.assert_array_equal(
            mux._webrtc_states[stream.index].numpy(), sess._vad.state_array)


@pytest.mark.parametrize("kind", ["overlap", "speaker", "wavlm"])
def test_kind_only_cross_checks_the_predictor(kind, request, tmp_path):
    """``kind=`` selects nothing: naming another kind than the predictor's
    raises, and left out the multiplexer serves the predictor's kind, its
    log schema and label names."""
    pred = request.getfixturevalue(kind)[1]
    for other in sorted({"overlap", "speaker", "wavlm"} - {kind}):
        with pytest.raises(ValueError, match="kind"):
            Multiplexer(pred, tmp_path / other, kind=other, device="cpu")
    mux = Multiplexer(pred, tmp_path / "own", bucket=2, cfg=PORT_CFG,
                      device="cpu")
    stream = mux.add_stream("s", PrefilledCapture(
        synth_speech_i16(WIN, seed=5)), _noise(seed=1))
    assert mux.run_until_exhausted() == 1
    assert stream.log.header == (SPEAKER_HEADER if kind == "speaker"
                                 else OVERLAP_HEADER)
    names = ("0", "1") if kind == "speaker" else \
        ("non-overlapped", "overlapped")
    assert stream.results[0][1] in names + ("silent",)


@pytest.mark.parametrize("kind", ["overlap", "speaker", "wavlm"])
def test_cfg_features_must_be_the_predictors(kind, request, tmp_path):
    """The multiplexer featurizes with the predictor's ``feat_cfg``: a
    ``cfg`` whose section of those features differs is refused, so one
    config decides the features and the gate; a section the predictor does
    not read (all of them for WavLM) may differ."""
    pred = request.getfixturevalue(kind)[1]
    for field in ("overlap_feature", "speaker_feature"):
        cfg = dataclasses.replace(PORT_CFG, **{field: dataclasses.replace(
            getattr(PORT_CFG, field), win_ms=30.0)})
        if field == pred.cfg_features:
            with pytest.raises(ValueError, match=field):
                Multiplexer(pred, tmp_path / field, cfg=cfg, device="cpu")
        else:
            Multiplexer(pred, tmp_path / field, cfg=cfg, device="cpu")


def test_multiplexer_speaker_kind(speaker, tmp_path):
    mux = Multiplexer(speaker[1], tmp_path / "experiment", kind="speaker",
                      bucket=2, cfg=PORT_CFG, device="cpu")
    cap = CaptureThread(ArraySource(synth_speech_i16(WIN, seed=9))).start()
    stream = mux.add_stream("s", cap, _noise(seed=1),
                            label_names={"0": "alice", "1": "bob"})
    assert mux.run_until_exhausted() == 1
    cap.stop()
    assert stream.results[0][1] in ("alice", "bob", "silent")


def test_energy_mode_speaker_numeric_labels(speaker, tmp_path):
    cfg = dataclasses.replace(PORT_CFG,
                              vad=port_config.VadConfig(decision="energy"))
    mux = Multiplexer(speaker[1], tmp_path / "experiment", kind="speaker",
                      bucket=8, cfg=cfg, device="cpu")
    assert not mux._use_webrtc
    caps = [CaptureThread(ArraySource(
        synth_speech_i16(WIN, seed=20 + s))).start() for s in range(2)]
    for s, cap in enumerate(caps):
        mux.add_stream(f"s{s}", cap, _noise(seed=1))
    assert mux.run_until_exhausted() == 2
    _stop(caps)
    for s in mux.streams:
        assert len(s.results) == 1
        assert s.results[0][1] in ("0", "1", "silent")


def test_bucket_ladder_and_nonblocking(overlap, tmp_path):
    """A stream with no data never stalls the tick; ready counts round up
    to the smallest sufficient bucket."""
    mux = Multiplexer(overlap[1], tmp_path / "experiment", kind="overlap",
                      buckets=(2, 4), cfg=PORT_CFG, device="cpu")
    rng = np.random.RandomState(0)
    dispatched = _spy_dispatch(mux)
    noise = (rng.randn(160000) * 20).astype(np.int16)
    for s in range(3):
        cap = CaptureThread(ArraySource(
            (rng.randn(WIN) * 3000).astype(np.int16))).start()
        mux.add_stream(f"s{s}", cap, noise)

    class _Starved:
        exhausted = False

        def read(self, n):
            time.sleep(0.01)
            return np.zeros(0, np.int16)

    mux.add_stream("starved", CaptureThread(_Starved()).start(), noise)
    for s in mux.streams[:3]:                   # let the rings fill
        while s.capture.ring.available < WIN:
            time.sleep(0.005)
    mux.tick()
    assert mux.flush() == 3
    assert dispatched[0] == (3, 4)              # 3 ready -> bucket 4
    assert mux.phase_seconds["gather"] < 2.0    # a poll, not a wait
    cap_new = CaptureThread(ArraySource(
        (rng.randn(WIN) * 3000).astype(np.int16))).start()
    mux.add_stream("late", cap_new, noise)
    while cap_new.ring.available < WIN:
        time.sleep(0.005)
    mux.tick()
    mux.flush()
    assert dispatched[-1] == (1, 2)             # only the late one -> 2
    for s in mux.streams:
        s.capture.stop()


def test_round_robin_fairness(overlap, tmp_path):
    """More ready streams than the bucket: rotation serves all of them."""
    mux = Multiplexer(overlap[1], tmp_path / "experiment", kind="overlap",
                      buckets=(2,), cfg=PORT_CFG, device="cpu")
    rng = np.random.RandomState(1)
    noise = (rng.randn(160000) * 20).astype(np.int16)
    for s in range(4):          # 4 streams, bucket 2: two ticks a round
        cap = CaptureThread(ArraySource(
            np.tile((rng.randn(WIN) * 3000).astype(np.int16), 2))).start()
        mux.add_stream(f"s{s}", cap, noise)
    assert mux.run_until_exhausted() == 8
    assert all(len(s.results) == 2 for s in mux.streams)
    for s in mux.streams:
        s.capture.stop()


def test_min_fill_accumulates_then_stall_drains(overlap, tmp_path):
    mux = Multiplexer(overlap[1], tmp_path / "experiment", kind="overlap",
                      buckets=(4,), min_fill=0.75, cfg=PORT_CFG,
                      device="cpu")
    dispatched = _spy_dispatch(mux)
    rng = np.random.RandomState(0)
    noise = (rng.randn(160000) * 20).astype(np.int16)
    for s in range(2):
        mux.add_stream(f"s{s}", PrefilledCapture(
            (rng.randn(WIN) * 3000).astype(np.int16)), noise)
    mux.tick()
    # 2 ready < 0.75 * 4 = 3: held, not dispatched
    assert dispatched == [] and len(mux._pending_streams) == 2
    mux.tick()                                  # nothing new: drain
    assert dispatched == [(2, 4)]
    assert mux.flush() == 2


def test_min_fill_run_until_exhausted_decides_everything(overlap, tmp_path):
    mux, caps = _port_mux(overlap, tmp_path, min_fill=1.0)
    assert mux.run_until_exhausted() == 6
    _stop(caps)
    assert all(len(s.results) == 2 for s in mux.streams)


def test_remove_stream_recycles_rows_bit_exactly(overlap, tmp_path):
    """Retired streams' slots and detector rows are reused, and a recycled
    row decides like a fresh engine: the same audio served by a fresh
    multiplexer gives the same labels and the same final row."""
    audio_b = np.concatenate([synth_speech_i16(WIN, seed=77),
                              synth_speech_i16(WIN, seed=78)])
    noise = _noise(seed=3)
    ref_mux = Multiplexer(overlap[1], tmp_path / "ref", kind="overlap",
                          bucket=2, cfg=PORT_CFG, device="cpu")
    assert ref_mux.cfg.vad.decision == "webrtc"
    s_ref = ref_mux.add_stream("ref", PrefilledCapture(audio_b), noise)
    ref_mux.run_until_exhausted()
    ref = [r[1] for r in s_ref.results]
    assert len(ref) == 2

    mux, caps = _port_mux(overlap, tmp_path, n_streams=2, bucket=2)
    mux.run_until_exhausted()
    old = list(mux.streams)
    for s in old:
        mux.remove_stream(s)
        mux.remove_stream(s)                    # idempotent
    late = mux.add_stream("late", PrefilledCapture(audio_b), noise)
    assert late.index == old[0].index           # slot recycled...
    assert len(mux.streams) == 2                # ...not appended
    assert mux.retired == [old[0]] and mux._retiring == [old[1]]
    np.testing.assert_array_equal(              # a fresh engine's row
        mux._webrtc_states[late.index].numpy(),
        webrtc.webrtc_init(1, "cpu")[0].numpy())
    mux.run_until_exhausted()
    _stop(caps)
    assert mux._webrtc_n <= 2                   # stacked state bounded
    assert [r[1] for r in late.results] == ref
    np.testing.assert_array_equal(mux._webrtc_states[late.index].numpy(),
                                  ref_mux._webrtc_states[0].numpy())
    assert len(old[0].results) == 2             # retired results intact


def test_remove_stream_defers_row_reuse_while_pending(overlap, tmp_path):
    """A retiring stream's row is not recycled while one of its windows is
    pending: that batch still writes the stream's detector row."""
    mux, caps = _port_mux(overlap, tmp_path, n_streams=2, windows_each=1,
                          min_fill=1.0)
    for s in mux.streams:                       # wait for the rings
        while s.capture.ring.available < WIN:
            time.sleep(0.005)
    mux.tick()                                  # gather both; no dispatch
    s0 = mux.streams[0]
    assert s0 in mux._pending_streams
    mux.remove_stream(s0)
    late = mux.add_stream("late", PrefilledCapture(
        synth_speech_i16(WIN, seed=99)), _noise(seed=9))
    assert late.index == 2                      # appended: row 0 unsafe
    assert mux.run_until_exhausted() == 3       # s0's window resolved
    assert len(s0.results) == 1                 # ...into the retired stream
    late2 = mux.add_stream("late2", PrefilledCapture(
        synth_speech_i16(WIN, seed=100)), _noise(seed=10))
    assert late2.index == s0.index              # now safe to recycle
    _stop(caps)


def test_churn_soak_state_stays_at_high_water(overlap, tmp_path):
    mux = Multiplexer(overlap[1], tmp_path / "experiment", kind="overlap",
                      bucket=4, cfg=PORT_CFG, device="cpu")
    noise = _noise(seed=3)
    all_streams = []

    def admit(gen, n):
        for i in range(n):
            all_streams.append(mux.add_stream(
                f"g{gen}_{i}", PrefilledCapture(
                    synth_speech_i16(WIN, seed=100 * gen + i)), noise))

    admit(0, 4)
    for gen in range(1, 4):
        assert mux.run_until_exhausted() == 4
        for s in list(mux.streams):
            mux.remove_stream(s)
        admit(gen, 4)
        assert len(mux.streams) == 4            # recycled, not grown
    assert mux.run_until_exhausted() == 4
    assert mux._webrtc_n <= 4 and len(mux._webrtc_states) == 4
    assert len(mux.retired) + len(mux._retiring) == 12
    assert all(len(s.results) == 1 for s in all_streams)


def test_churn_soak_host_objects_bounded(overlap, tmp_path):
    """``remove_stream(archive=False)`` and ``results_cap`` bound the host
    objects of a long churn; the TSV logs keep every window."""
    mux = Multiplexer(overlap[1], tmp_path / "experiment", kind="overlap",
                      bucket=4, results_cap=2, cfg=PORT_CFG, device="cpu")
    noise = _noise(seed=3)
    log_paths = []
    windows_each = 3                            # > results_cap

    def admit(gen, n):
        for i in range(n):
            audio = np.concatenate([
                synth_speech_i16(WIN, seed=100 * gen + 10 * i + w)
                for w in range(windows_each)])
            s = mux.add_stream(f"h{gen}_{i}", PrefilledCapture(audio), noise)
            log_paths.append(s.log.path)

    admit(0, 4)
    for gen in range(1, 4):
        assert mux.run_until_exhausted() == 4 * windows_each
        for s in list(mux.streams):
            mux.remove_stream(s, archive=False)
        admit(gen, 4)
        assert len(mux.streams) == 4
        assert len(mux.retired) == 0 and len(mux._retiring) <= 4
    assert mux.run_until_exhausted() == 4 * windows_each
    assert all(len(s.results) == 2 for s in mux.streams)
    assert len(log_paths) == 16
    for p in log_paths:
        assert len(parse_log(p)) == windows_each
    s0 = mux.streams[0]
    mux.remove_stream(s0, archive=False)
    mux.remove_stream(s0)                       # the first archive holds
    assert s0.archive is False and len(mux.retired) == 0


def test_results_cap_zero_keeps_nothing(overlap, tmp_path):
    """``results_cap=0`` keeps no in-memory tail (the JAX multiplexer tests
    the cap for truthiness and keeps everything); None keeps everything."""
    kept = {}
    for cap in (0, None):
        mux, caps = _port_mux(overlap, tmp_path / str(cap), n_streams=1,
                              results_cap=cap)
        assert mux.run_until_exhausted() == 2
        _stop(caps)
        stream = mux.streams[0]
        assert len(parse_log(stream.log.path)) == 2
        kept[cap] = len(stream.results)
    assert kept == {0: 0, None: 2}


def test_calibration_cache_shared_profile_computed_once(overlap, tmp_path,
                                                        monkeypatch):
    calls = []
    real = mx.noise_threshold
    monkeypatch.setattr(mx, "noise_threshold",
                        lambda nf, cfg: calls.append(1) or real(nf, cfg))
    mux = Multiplexer(overlap[1], tmp_path / "experiment", kind="overlap",
                      bucket=4, cfg=PORT_CFG, device="cpu")
    noise_a, noise_b = _noise(seed=1), _noise(seed=2)

    def cap():
        return PrefilledCapture(synth_speech_i16(WIN, seed=len(calls)))

    s0 = mux.add_stream("a0", cap(), noise_a)
    s1 = mux.add_stream("a1", cap(), noise_a.copy())     # same content
    assert len(calls) == 1
    assert s1.vad_threshold_db == s0.vad_threshold_db
    np.testing.assert_array_equal(s1.noise_thresh, s0.noise_thresh)
    s2 = mux.add_stream("b0", cap(), noise_b)            # other content
    assert len(calls) == 2
    assert not np.array_equal(s2.noise_thresh, s0.noise_thresh)
    mux.add_stream("a2", cap(), noise_a)                 # still cached
    assert len(calls) == 2 and len(mux._calib_cache) == 2
    # the same bytes as another dtype are another profile (the JAX
    # multiplexer's key is the bytes alone)
    s3 = mux.add_stream("a3", cap(), noise_a.view(np.uint16))
    assert len(calls) == 3
    assert not np.array_equal(s3.noise_thresh, s0.noise_thresh)
    # bounded: FIFO past 256 distinct profiles
    mux._calib_cache = {bytes([i % 256, i // 256]): None for i in range(256)}
    mux.add_stream("c0", cap(), noise_b)
    assert len(mux._calib_cache) == mx.CALIBRATION_CACHE == 256


def test_python_gather_matches_native(overlap, tmp_path):
    """Ring-less captures take the Python poll loop; it decides the same as
    the one-call native gather."""
    audio = [synth_speech_i16(WIN, seed=s) for s in range(3)]
    noise = _noise(seed=3)
    results = []
    for name, capture in (("nat", PrefilledCapture),
                          ("py", lambda a: _Windows([a]))):
        mux = Multiplexer(overlap[1], tmp_path / name, kind="overlap",
                          bucket=4, cfg=PORT_CFG, device="cpu")
        streams = [mux.add_stream(f"{name}{s}", capture(a), noise)
                   for s, a in enumerate(audio)]
        assert mux.run_until_exhausted() == 3
        assert (mux._batch_gather is not None) == (name == "nat")
        results.append([[r[1] for r in s.results] for s in streams])
    assert results[0] == results[1]


def test_refuses_bad_arguments(overlap, tmp_path):
    pred = overlap[1]
    with pytest.raises(ValueError, match="kind"):
        Multiplexer(pred, tmp_path, kind="other", device="cpu")
    with pytest.raises(ValueError, match="runs on"):
        Multiplexer(pred, tmp_path, device="cuda")
    with pytest.raises(ValueError, match="min_fill"):
        Multiplexer(pred, tmp_path, min_fill=1.5, device="cpu")
    with pytest.raises(ValueError, match="results_cap"):
        Multiplexer(pred, tmp_path, results_cap=-1, device="cpu")
