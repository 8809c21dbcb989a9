"""The port's main path end to end vs the JAX package: OverlapPredictor,
OverlapSession (against JAX's on-device arrangement, whose webrtc engine is
bit-identical to the port's native one), the CLI, and the rule that the
port never imports JAX."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core import config as jax_config
from mmla_audio_tpu.inference import OverlapPredictor as JaxPredictor
from mmla_audio_torch import cli
from mmla_audio_torch.analyze.logs import parse_log
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.data.wavio import write_wav
from mmla_audio_torch.inference import SILENT, OverlapPredictor
from mmla_audio_torch.params import overlap_state_dict_from_jax
from tests.conftest import synth_speech_i16
from tests.test_torch_model import as_port, perturbed_tree

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# narrow widths; input_scale 1/255 keeps the narrow model's LSTM out of
# saturation, so its probabilities depend on the window
CFG = jax_config.OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                                    input_scale=1 / 255)


@pytest.fixture(scope="module")
def predictors():
    tree = perturbed_tree(CFG, seed=1)
    jax_pred = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                            model_cfg=CFG)
    pred = OverlapPredictor(overlap_state_dict_from_jax(tree, as_port(CFG)),
                            as_port(CFG), device="cpu",
                            matmul_precision="highest")
    return jax_pred, pred


def test_predictor_matches_jax(predictors):
    jax_pred, pred = predictors
    buf = np.stack([synth_speech_i16(40960, seed=s) for s in (1, 2, 3)])
    n = np.array([40960, 30000, 3000], np.int32)
    ref_l, ref_p = jax_pred.predict(buf, n)
    labels, probs = pred.predict(buf, n)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_l))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_p), atol=1e-4)
    assert labels[2] == SILENT
    # single-window form and float32 input give the same answer
    l1, p1 = pred.predict(buf[0].astype(np.float32), 40960)
    assert l1 == labels[0]
    np.testing.assert_allclose(p1.numpy(), probs[0].numpy(), atol=1e-6)


def test_predictor_bf16_autocast(predictors):
    """compute_dtype=bfloat16 runs the model under autocast and still
    returns float32 probabilities close to the fp32 run."""
    pred = predictors[1]
    bf16 = OverlapPredictor(pred.model.state_dict(), as_port(CFG),
                            device="cpu", compute_dtype=torch.bfloat16)
    buf = np.stack([synth_speech_i16(40960, seed=s) for s in (1, 2)])
    n = np.array([40960, 40960], np.int32)
    _, ref = pred.predict(buf, n)
    _, got = bf16.predict(buf, n)
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0.05)


def test_apply_model_on_the_cpu_runs_eagerly(predictors):
    """On the CPU ``apply_model`` never captures a graph: every forward,
    the same shape again and again, counts ``eager`` and equals the
    model's own forward."""
    pred = OverlapPredictor(predictors[1].model.state_dict(), as_port(CFG),
                            device="cpu")
    x = torch.from_numpy((np.random.RandomState(5).rand(2, 128, 151, 3)
                          * 255).astype(np.float32))
    with torch.no_grad():
        ref = pred.model(x)
        for _ in range(3):
            assert torch.equal(pred.apply_model(x), ref)
    assert pred.graph_stats() == {"captures": 0, "replays": 0, "eager": 3}
    assert not pred._graphs


def test_predictor_refuses_non_default_feature_config(predictors):
    feat = port_config.OverlapFeatureConfig(flip_mel_axis=False)
    with pytest.raises(ValueError, match="requires png_quantize=True"):
        OverlapPredictor(predictors[1].model.state_dict(), as_port(CFG),
                         feat_cfg=feat, device="cpu")


def test_session_matches_jax_session(predictors, tmp_path):
    from mmla_audio_tpu.streaming import capture as jax_capture
    from mmla_audio_tpu.streaming.session import OverlapSession as JaxSession
    from mmla_audio_torch.streaming.capture import ArraySource, CaptureThread
    from mmla_audio_torch.streaming.session import OverlapSession

    samples = np.concatenate([synth_speech_i16(40960, seed=1),
                              np.zeros(40960, np.int16),
                              synth_speech_i16(40960, seed=2)])
    noise = (np.random.RandomState(3).randn(160000) * 20).astype(np.int16)
    cap = jax_capture.CaptureThread(jax_capture.ArraySource(samples)).start()
    # the JAX session's pure-JAX webrtc engine: its "auto" and True
    # arrangements would load the JAX package's native library
    ref = JaxSession(predictors[0], cap, tmp_path / "jax",
                     cfg=jax_config.PipelineConfig(overlap_model=CFG),
                     host_preprocess=False)
    ref.set_noise_profile(noise)
    ref_rows = ref.run(max_windows=3)
    cap.stop()

    cap = CaptureThread(ArraySource(samples)).start()
    sess = OverlapSession(
        predictors[1], cap, tmp_path / "torch",
        cfg=port_config.PipelineConfig(overlap_model=as_port(CFG)))
    sess.set_noise_profile(noise)
    rows = sess.run(max_windows=3)
    cap.stop()

    labels = [r[1] for r in rows]
    assert labels == [r[1] for r in ref_rows]
    assert labels[1] == "silent"
    logged = [(i, lab) for i, lab, _ in parse_log(sess.log.path)]
    assert logged == [(i, lab) for i, lab, _ in parse_log(ref.log.path)]
    assert logged == [(1, labels[0]), (2, labels[1]), (3, labels[2])]


def test_capture_sources_match_jax():
    from datetime import datetime

    from mmla_audio_tpu.streaming import capture as jax_capture
    from mmla_audio_torch.streaming.capture import (FakePCMSource,
                                                    PrefilledCapture)
    from mmla_audio_torch.streaming.session import session_stamp

    ours, theirs = FakePCMSource(seed=7), jax_capture.FakePCMSource(seed=7)
    for n in (16000, 2000, 40960):
        np.testing.assert_array_equal(ours.read(n), theirs.read(n))
    replay = FakePCMSource(seed=8).read(100000)
    cap = PrefilledCapture(replay)
    windows = [cap.read_window(40960) for _ in range(3)]
    np.testing.assert_array_equal(np.concatenate(windows[:2]),
                                  replay[:81920])
    assert windows[2] is None                   # sub-window tail dropped
    assert session_stamp(datetime(2026, 1, 2, 3, 4, 5, 123456)) == \
        "2026-01-02-03-04-05"


def test_cli_overlap_run(tmp_path, capsys):
    wav = tmp_path / "clip.wav"
    write_wav(wav, synth_speech_i16(30000, seed=5))
    cli.main(["overlap-run", "-f", str(wav), "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.search(r"^\[RESULT\] clip\.wav: (non-overlapped|overlapped)$",
                     out, re.M)


def test_cli_overlap_live_fake(tmp_path, capsys):
    cli.main(["overlap-live", "--fake", "--windows", "2", "--vad", "energy",
              "--calibrate-seconds", "1", "--root", str(tmp_path / "exp"),
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[INFO] window ") == 2
    logs = list((tmp_path / "exp" / "logs").glob("*.txt"))
    assert len(logs) == 1 and [r[0] for r in parse_log(logs[0])] == [1, 2]
    assert (tmp_path / "exp" / "Ambient_Noise.wav").exists()


@pytest.mark.parametrize("name", ["AudioConfig", "OverlapFeatureConfig",
                                  "VadConfig", "DenoiseConfig",
                                  "OverlapModelConfig",
                                  "SpeakerFeatureConfig",
                                  "SpeakerModelConfig",
                                  "OverlapTrainConfig", "SpeakerTrainConfig",
                                  "TransferConfig", "MeshConfig"])
def test_config_copy_matches_jax_package(name):
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    for prop in ("win_length", "hop_length", "feat_dim", "feature_shape",
                 "n_samples", "n_frames", "image_shape", "window_samples"):
        if hasattr(theirs, prop):
            assert getattr(ours(), prop) == getattr(theirs(), prop)


def test_pipeline_config_copy_is_a_subset_of_jax_package():
    ours, theirs = port_config.PipelineConfig(), jax_config.PipelineConfig()
    for field in dataclasses.fields(ours):
        assert dataclasses.asdict(getattr(ours, field.name)) == \
            dataclasses.asdict(getattr(theirs, field.name))


def test_port_imports_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "mmla_audio_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = (f"import sys, {', '.join(modules)}; bad = [m for m in "
            "sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'mmla_audio_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    pattern = re.compile(
        r"^\s*(import|from) (jax|flax|mmla_audio_tpu)\b|flax", re.M)
    files = sorted((REPO / "mmla_audio_torch").rglob("*")) + \
        [REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in files
                 if p.suffix in (".py", ".cu") and
                 pattern.search(p.read_text())]
    assert offenders == []


def test_silent_threshold_matches_jax():
    """A tuned gate (``cfg.vad.silent_samples`` passed through) gives the
    same labels in both predictors."""
    tree = perturbed_tree(CFG, seed=1)
    jax_pred = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                            model_cfg=CFG, silent_threshold=6000)
    pred = OverlapPredictor(overlap_state_dict_from_jax(tree, as_port(CFG)),
                            as_port(CFG), device="cpu", silent_threshold=6000)
    buf = np.stack([synth_speech_i16(40960, seed=s) for s in (4, 5)])
    n = np.array([5000, 7000], np.int32)
    labels, _ = pred.predict(buf, n)
    ref, _ = jax_pred.predict(buf, n)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref))
    assert labels[0] == SILENT and labels[1] != SILENT
