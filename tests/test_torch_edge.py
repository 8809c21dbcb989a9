"""The port's edge surfaces vs the JAX package: SSIM (against
``mmla_audio_tpu.ops.ssim`` within 1e-5, and against skimage's formula
evaluated directly in numpy), ``EdgeOverlapSession`` (labels and SSIM gate
against JAX's session on the same seeded weights and audio), the gate's
suspend/resume state machine with ``CaptureThread.suspend``/``resume``
(a capture created suspended adopted only by a gated session),
``EdgeSpeakerSession`` register -> train -> identify through the gate with
the timestamp-free log, ``HostPreprocessor`` (against the port's on-device
chain on the CPU bit for bit, and against JAX's chain with its pure-JAX
webrtc engine, the JAX host split's contract, without loading the JAX
package's native library), the session's telemetry, and
``TelemetryClient`` against a local stub server only.
"""

import http.server
import json
import threading
import time
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core import config as jax_config
from mmla_audio_tpu.inference import OverlapPredictor as JaxPredictor
from mmla_audio_tpu.ops.ssim import ssim as jax_ssim
from mmla_audio_torch.analyze.logs import parse_log
from mmla_audio_torch.analyze.telemetry import TelemetryClient
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.inference import OverlapPredictor
from mmla_audio_torch.ops.ssim import ssim
from mmla_audio_torch.params import overlap_state_dict_from_jax
from mmla_audio_torch.streaming.capture import ArraySource, CaptureThread
from mmla_audio_torch.streaming.edge import (EdgeOverlapSession,
                                             EdgeSpeakerSession, GateSource)
from tests.conftest import synth_speech_i16
from tests.test_torch_model import as_port, perturbed_tree

torch.set_num_threads(1)

CFG = jax_config.OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                                    input_scale=1 / 255)
WIN = 40960
NOISE = (np.random.RandomState(3).randn(160000) * 25).astype(np.int16)


def _ssim_numpy(a, b, data_range=255.0):
    """skimage's ``structural_similarity`` with uniform 7x7 windows,
    ``channel_axis=-1``, written out: every window's moments from its 49
    pixels directly, the ``n / (n - 1)`` covariance, the mean over windows
    and channels."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    H, W, C = a.shape
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    vals = []
    for c in range(C):
        for i in range(H - 6):
            for j in range(W - 6):
                x = a[i: i + 7, j: j + 7, c].ravel()
                y = b[i: i + 7, j: j + 7, c].ravel()
                mx, my = x.mean(), y.mean()
                vx, vy = x.var(ddof=1), y.var(ddof=1)
                cov = ((x - mx) * (y - my)).sum() / 48.0
                vals.append((2 * mx * my + c1) * (2 * cov + c2)
                            / ((mx * mx + my * my + c1) * (vx + vy + c2)))
    return float(np.mean(vals))


def test_ssim_matches_jax_and_skimage_formula():
    rng = np.random.RandomState(0)
    a = rng.rand(2, 20, 17, 3).astype(np.float32) * 255
    b = np.clip(a + rng.randn(*a.shape) * 30, 0, 255).astype(np.float32)
    got = ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2,)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    for k in range(2):
        assert abs(float(got[k]) - _ssim_numpy(a[k], b[k])) <= 1e-5
    same = ssim(torch.from_numpy(a[0]), torch.from_numpy(a[0]))
    assert abs(float(same) - 1.0) <= 1e-5


@pytest.fixture(scope="module")
def predictors():
    tree = perturbed_tree(CFG, seed=1)
    jax_pred = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                            model_cfg=CFG)
    pred = OverlapPredictor(overlap_state_dict_from_jax(tree, as_port(CFG)),
                            as_port(CFG), device="cpu",
                            matmul_precision="highest")
    return jax_pred, pred


def _edge_windows():
    rng = np.random.RandomState(0)
    return [synth_speech_i16(WIN, seed=2),
            (rng.randn(WIN) * 25).astype(np.int16),
            synth_speech_i16(WIN, seed=5) // 8,
            (rng.randn(WIN) * 25 + synth_speech_i16(WIN, seed=6) // 64
             ).astype(np.int16)]


def test_edge_overlap_session_matches_jax(predictors, tmp_path):
    from mmla_audio_tpu.streaming import capture as jax_capture
    from mmla_audio_tpu.streaming.edge import \
        EdgeOverlapSession as JaxEdgeSession

    windows = _edge_windows()
    samples = np.concatenate(windows)
    cap = jax_capture.CaptureThread(jax_capture.ArraySource(samples)).start()
    ref = JaxEdgeSession(predictors[0], cap, tmp_path / "jax",
                         cfg=jax_config.PipelineConfig(overlap_model=CFG))
    ref.set_noise_profile(NOISE)
    ref_rows = ref.run(max_windows=len(windows))
    cap.stop()

    cap = CaptureThread(ArraySource(samples)).start()
    sess = EdgeOverlapSession(
        predictors[1], cap, tmp_path / "torch",
        cfg=port_config.PipelineConfig(overlap_model=as_port(CFG)))
    sess.set_noise_profile(NOISE)
    sims = []
    rows = sess.run(max_windows=len(windows),
                    on_result=lambda *a: sims.append(sess.last_similarity))
    cap.stop()
    labels = [r[1] for r in rows]
    assert labels == [r[1] for r in ref_rows]
    assert "silent" in labels and set(labels) - {"silent"}
    assert [(i, lab) for i, lab, _ in parse_log(sess.log.path)] == \
        [(i + 1, lab) for i, lab in enumerate(labels)]
    for w, sim in zip(windows, sims):
        _, _, ref_sim = ref._fused(
            predictors[0].variables, jnp.asarray(w.astype(np.float32)),
            ref.noise_thresh, jnp.asarray(0.3, jnp.float32))
        assert (sim < 0.3) == (float(ref_sim) < 0.3)       # the same gate


def test_edge_overlap_after_the_denoise_matches_jax(predictors, tmp_path,
                                                     monkeypatch):
    """From the same x4-denoised window (JAX's), the rest of the edge
    chain: int16 re-quantization, both images, SSIM (within 1e-4: the two
    featurizers agree within one quantization step on < 2 % of pixels) and
    the model's probabilities (atol 1e-4).  End to end the two ×4 chains
    differ by a few int16 steps (a step left by one pass flips a mask bin
    of the next), so only the labels are held there."""
    from mmla_audio_tpu.ops.denoise import reduce_noise as jax_reduce
    from mmla_audio_tpu.ops.features import overlap_model_input as jax_image
    from mmla_audio_torch.streaming import edge

    cfg = port_config.PipelineConfig(overlap_model=as_port(CFG))
    sess = EdgeOverlapSession(predictors[1], None, tmp_path, cfg=cfg)
    sess.set_noise_profile(NOISE)
    nt = jnp.asarray(sess.noise_thresh.numpy())
    n = cfg.overlap_feature.n_samples
    for w in _edge_windows():
        y = jnp.asarray(w.astype(np.float32)) / 32768.0
        y_dn = jax_reduce(y, nt, passes=cfg.denoise.passes_edge)
        monkeypatch.setattr(edge, "reduce_noise", lambda *a, **k: (
            torch.from_numpy(np.array(y_dn))))
        name, probs = sess.process_window(w)
        img_dn = jax_image(jnp.round(y_dn * 32768.0).clip(-32768, 32767)
                           [:n] / 32768.0)
        sim = float(jax_ssim(jax_image(y[:n]), img_dn))
        ref = np.asarray(jax.nn.softmax(predictors[0].apply_model(
            predictors[0].variables, img_dn[None]), axis=-1))[0]
        assert abs(sess.last_similarity - sim) <= 1e-4
        np.testing.assert_allclose(probs, ref, atol=1e-4)
        assert name == ("silent" if sim < 0.3 else
                        ("non-overlapped", "overlapped")[int(np.argmax(ref))])


def test_edge_overlap_threshold_is_read_per_window(predictors, tmp_path):
    sess = EdgeOverlapSession(predictors[1], None, tmp_path,
                              cfg=port_config.PipelineConfig(
                                  overlap_model=as_port(CFG)))
    sess.set_noise_profile(NOISE)
    w = synth_speech_i16(WIN, seed=2)
    sess.ssim_threshold = -1.0
    assert sess.process_window(w)[0] != "silent"
    sess.ssim_threshold = 1.01
    assert sess.process_window(w)[0] == "silent"


@pytest.mark.parametrize("cls", [EdgeOverlapSession, EdgeSpeakerSession])
def test_edge_sessions_refuse_the_host_split(predictors, tmp_path, cls):
    with pytest.raises(ValueError, match="not supported on edge"):
        cls(predictors[1], None, tmp_path, host_preprocess=True)


def test_gate_source():
    g = GateSource(pressed=False)
    assert not g.pressed
    assert not g.wait_pressed(timeout=0.01)
    g.set_pressed(True)
    assert g.wait_pressed(timeout=0.01)


def test_capture_thread_suspend_resume():
    """Suspended before ``start()`` the producer reads nothing; a
    suspension clears the ring and suspends the source on the producer's
    own thread; ``resume`` resumes it."""
    calls = []

    class Source(ArraySource):
        def suspend(self):
            calls.append(("suspend", threading.current_thread().name))

        def resume(self):
            calls.append(("resume", threading.current_thread().name))

    src = Source(np.arange(20000, dtype=np.int16))
    cap = CaptureThread(src)
    cap.suspend()
    cap.start()
    time.sleep(0.05)
    assert cap.suspended and src.pos == 0 and cap.ring.available == 0
    cap.resume()
    got = cap.read_window(4000, timeout=2.0)
    np.testing.assert_array_equal(got, np.arange(4000, dtype=np.int16))
    assert not cap.suspended
    cap.stop()
    assert [c[0] for c in calls] == ["suspend", "resume"]
    assert all(c[1] != threading.current_thread().name for c in calls)


class _StubCapture:
    """A capture that records suspend/resume and gives a window per read."""

    def __init__(self, suspended=False, windows=3):
        self.suspended = suspended
        self.calls = []
        self.left = windows

    def suspend(self):
        self.suspended = True
        self.calls.append("suspend")

    def resume(self):
        self.suspended = False
        self.calls.append("resume")

    def read_window(self, n, timeout=0.0):
        if self.left == 0:
            return None
        self.left -= 1
        return synth_speech_i16(n, seed=self.left)


@pytest.mark.parametrize("gated", [True, False])
def test_run_adopts_a_suspended_capture_only_when_gated(predictors, tmp_path,
                                                        gated):
    from mmla_audio_torch.streaming.session import OverlapSession

    cap = _StubCapture(suspended=True, windows=2)
    cfg = port_config.PipelineConfig(overlap_model=as_port(CFG))
    sess = OverlapSession(predictors[1], cap, tmp_path, cfg=cfg,
                          gate=GateSource() if gated else None)
    sess.set_noise_profile(NOISE)
    assert len(sess.run(max_windows=2)) == 2
    assert cap.calls == (["resume"] if gated else [])


def test_gate_release_suspends_and_press_resumes(predictors, tmp_path):
    cap = _StubCapture(windows=2)
    gate = GateSource(pressed=False)
    sess = EdgeOverlapSession(predictors[1], cap, tmp_path, gate=gate,
                              cfg=port_config.PipelineConfig(
                                  overlap_model=as_port(CFG)))
    sess.set_noise_profile(NOISE)
    threading.Timer(0.3, gate.set_pressed, args=(True,)).start()
    t0 = time.monotonic()
    rows = sess.run(max_windows=2)
    assert time.monotonic() - t0 >= 0.25 and len(rows) == 2
    assert cap.calls == ["suspend", "resume"]


def test_edge_speaker_register_train_identify_through_gate(tmp_path):
    """The SI Pi composition: gated registration (waits for the button,
    resumes a capture created suspended) -> transfer-learn -> the identify
    step through the pinned program (compiled once, rebuilt after a new
    head) with the timestamp-free ``segment\\tspeaker`` log."""
    from mmla_audio_torch.inference import SpeakerPredictor
    from mmla_audio_torch.models.layers import keras_init_
    from mmla_audio_torch.models.speaker import SpeakerResBLSTM

    cfg = port_config.PipelineConfig(
        speaker_model=port_config.SpeakerModelConfig(
            stage_filters=(8, 8, 8), lstm_units=16, num_speakers=20),
        transfer=port_config.TransferConfig(
            phase1_epochs=30, phase1_lr=3e-3, phase2_epochs=0,
            max_retrain_rounds=1, accuracy_gate=0.0))
    base = keras_init_(SpeakerResBLSTM(cfg.speaker_model),
                       torch.Generator().manual_seed(0)).state_dict()
    pred = SpeakerPredictor(base, cfg.speaker_model, device="cpu")
    alice = synth_speech_i16(16000 * 8, seed=10)
    bob = synth_speech_i16(16000 * 8, seed=20) // 4
    cap = CaptureThread(ArraySource(np.concatenate([alice, bob])))
    cap.suspend()                               # boot state: button up
    cap.start()
    gate = GateSource(pressed=False)
    sess = EdgeSpeakerSession(pred, cap, tmp_path / "experiment", gate=gate,
                              cfg=cfg)
    sess.set_noise_profile(
        (np.random.RandomState(4).randn(160000) * 5).astype(np.int16))
    threading.Timer(0.2, gate.set_pressed, args=(True,)).start()
    t0 = time.monotonic()
    path = sess.register_speaker("alice", seconds=8)
    assert time.monotonic() - t0 >= 0.15        # waited for the gate
    sess.register_speaker("bob", seconds=8)
    cap.stop()
    from mmla_audio_torch.data.wavio import read_wav

    assert np.abs(read_wav(path)[0]).max() > 0  # real audio, not zeros
    sess.train_on_registered(base, seed=0)
    assert set(sess.speaker_id_dict.values()) == {"alice", "bob"}
    assert sess._aot is None

    cap2 = CaptureThread(ArraySource(synth_speech_i16(WIN * 3, seed=10)))
    cap2.suspend()
    cap2.start()
    sess.capture = cap2
    gate.set_pressed(False)
    threading.Timer(0.3, gate.set_pressed, args=(True,)).start()
    results = sess.run(max_windows=2)
    cap2.stop()
    assert len(results) == 2
    assert all(r[1] in ("alice", "bob", "silent") for r in results)
    assert sess._aot is not None
    lines = sess.log.path.read_text().strip().split("\n")
    assert lines[0] == "segment\tspeaker"
    assert all(len(ln.split("\t")) == 2 for ln in lines[1:])
    assert [(r[0], r[2]) for r in parse_log(sess.log.path)] == \
        [(1, ""), (2, "")]
    # the pinned step gives the eager session's answer
    w = synth_speech_i16(WIN, seed=11)
    eager = sess.predictor.score(*(lambda t, n: (
        t[None], torch.tensor([n], dtype=torch.int32)))(
        *sess.preprocess(w)))
    np.testing.assert_allclose(sess.process_window(w)[1],
                               eager[1][0].numpy(), atol=1e-6)


@pytest.fixture
def native():
    from mmla_audio_torch.vad.native import native_available

    if not native_available():
        pytest.skip("the native webrtcvad engine cannot build here")


def test_host_preprocessor_matches_the_device_chain_and_jax(native,
                                                          tmp_path):
    """The host split equals the port's on-device chain run on the CPU bit
    for bit (the same engine state carried over windows), and JAX's chain
    (``preprocess_window`` with its pure-JAX webrtc engine): equal kept
    counts, int16 within 1 step on <= 0.5 % of samples."""
    from mmla_audio_tpu.streaming.session import preprocess_window
    from mmla_audio_tpu.vad.webrtc import webrtc_init
    from mmla_audio_torch.streaming.hostpre import HostPreprocessor
    from mmla_audio_torch.streaming.session import OverlapSession

    cfg = port_config.PipelineConfig()
    host = HostPreprocessor(cfg)
    device_chain = OverlapSession(
        OverlapPredictor(overlap_state_dict_from_jax(
            perturbed_tree(CFG, seed=1), as_port(CFG)), as_port(CFG),
            device="cpu"), None, tmp_path, cfg=cfg, host_preprocess=False)
    device_chain.set_noise_profile(NOISE)
    host.set_noise_threshold(device_chain.noise_thresh)
    jcfg = jax_config.PipelineConfig()
    state = webrtc_init()
    nt = jnp.asarray(device_chain.noise_thresh.numpy())
    windows = [synth_speech_i16(WIN, seed=s) // d
               for s, d in ((1, 1), (2, 4), (3, 16))]
    for w in windows:
        got, n_out = host.window(w)
        ref, ref_n = device_chain.preprocess(w)
        assert n_out == ref_n and got.dtype == np.int16
        np.testing.assert_array_equal(got, ref.numpy().astype(np.int16))
        jt, jn, state = preprocess_window(
            jnp.asarray(w.astype(np.float32)), nt, 30.0, jcfg,
            webrtc_state=state)
        assert int(jn) == n_out
        diff = np.abs(got.astype(np.float32) - np.asarray(jt))
        assert diff.max() <= 1.0 and (diff > 0).mean() <= 0.005
    np.testing.assert_array_equal(host.vad.state_array,
                                  device_chain._vad.state_array)


def test_session_arrangements_agree(native, predictors, tmp_path):
    """``host_preprocess`` auto (the host split on a CPU device), True and
    False give the same labels and probabilities on the CPU; on a CUDA
    device ``"auto"`` keeps the chain on the card."""
    from mmla_audio_torch.streaming.session import (OverlapSession,
                                                     StreamingSession)

    cfg = port_config.PipelineConfig(overlap_model=as_port(CFG))
    out = []
    for arrangement, on_card in (("auto", "cuda"), (True, "cpu"),
                                 (False, "cuda")):
        # where a card session's chain runs (built without touching a card)
        # (each session claims a log of its own: a directory each)
        card = StreamingSession(None, tmp_path / f"card{len(out)}", cfg=cfg,
                                device="cuda", host_preprocess=arrangement)
        assert card.preprocess_device.type == on_card
        sess = OverlapSession(predictors[1], None, tmp_path / f"s{len(out)}",
                              cfg=cfg, host_preprocess=arrangement)
        assert sess.preprocess_device.type == "cpu"
        sess.set_noise_profile(NOISE)
        out.append([sess.process_window(synth_speech_i16(WIN, seed=s))
                    for s in (1, 2)])
    for other in out[1:]:
        for (name, probs), (ref_name, ref_probs) in zip(other, out[0]):
            assert name == ref_name
            np.testing.assert_array_equal(probs, ref_probs)
    with pytest.raises(ValueError, match="webrtc decision"):
        OverlapSession(predictors[1], None, tmp_path, host_preprocess=True,
                       cfg=port_config.PipelineConfig(
                           overlap_model=as_port(CFG),
                           vad=port_config.VadConfig(decision="energy")))


class _Stub(http.server.BaseHTTPRequestHandler):
    received = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        _Stub.received.append((self.path, self.headers["X-AIO-Key"],
                               json.loads(body)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture
def stub_server():
    _Stub.received = []
    server = http.server.HTTPServer(("127.0.0.1", 0), _Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/feed"
    server.shutdown()
    server.server_close()


def test_telemetry_client(stub_server):
    assert not TelemetryClient().enabled
    assert TelemetryClient(stub_server, "").send("x") is False
    t = TelemetryClient(stub_server, "key", timeout=2.0)
    p = t.format_payload("overlapped", datetime(2026, 1, 2, 3, 4, 5, 123456))
    assert p == '{"value": "overlapped", "created_at": "2026-01-02T03:04:05Z"}'
    assert t.send("overlapped", datetime(2026, 1, 2, 3, 4, 5)) is True
    assert t.sent == 1 and t.errors == 0
    assert _Stub.received == [("/feed", "key", {
        "value": "overlapped", "created_at": "2026-01-02T03:04:05Z"})]
    dead = TelemetryClient("http://127.0.0.1:1/none", "k", timeout=0.2)
    assert dead.send("x") is False and dead.errors == 1


def test_session_sends_each_logged_label(predictors, tmp_path, stub_server):
    from mmla_audio_torch.streaming.session import OverlapSession

    sess = OverlapSession(predictors[1], _StubCapture(windows=2), tmp_path,
                          cfg=port_config.PipelineConfig(
                              overlap_model=as_port(CFG)),
                          telemetry=TelemetryClient(stub_server, "key"))
    sess.set_noise_profile(NOISE)
    rows = sess.run(max_windows=2)
    assert [r[2]["value"] for r in _Stub.received] == [r[1] for r in rows]
