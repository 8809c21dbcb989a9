"""The port's registration surfaces vs the JAX package: corpus and clip
featurization, the feature cache read across packages, ``TimitCatalog``,
``SpeakerSession.register_speaker`` / ``train_on_registered`` end to end,
and the CLI's ``speaker-pretrain`` -> ``speaker-live --register`` ->
``speaker-post --weights``.

Features: rtol 1e-4 / atol 1e-3, as ``tests/test_torch_mfcc.py`` holds the
MFCC (the JAX package computes a clip through its 5 s bucketed windowed
program, the port on the clip itself).  The JAX session runs its
on-device arrangement (``host_preprocess=False``), whose pure-JAX webrtc
engine is bit-identical to the port's native one.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core import config as jax_config
from mmla_audio_tpu.data import corpus as jax_corpus
from mmla_audio_tpu.data.timit import TimitCatalog as JaxCatalog
from mmla_audio_tpu.train import checkpoints as jax_checkpoints
from mmla_audio_torch import cli
from mmla_audio_torch.analyze.logs import parse_log
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.data import corpus
from mmla_audio_torch.data.timit import TimitCatalog
from mmla_audio_torch.data.wavio import read_wav, write_wav
from mmla_audio_torch.inference import SpeakerPredictor
from mmla_audio_torch.params import (load_speaker_npz,
                                     speaker_state_dict_from_jax)
from mmla_audio_torch.streaming.capture import PrefilledCapture
from mmla_audio_torch.streaming.session import SpeakerSession
from mmla_audio_torch.train.checkpoints import (load_feature_cache,
                                                save_feature_cache)
from tests.conftest import synth_speech_i16
from tests.test_torch_model import as_port
from tests.test_torch_speaker import perturbed_speaker_tree

torch.set_num_threads(1)

SR = 16000
NARROW = jax_config.SpeakerModelConfig(stage_filters=(4, 4, 4),
                                       lstm_units=8)
NOISE = (np.random.RandomState(9).randn(160000) * 20).astype(np.int16)


def _corpus(root, lengths=(3.1, 1.2, 0.4)):
    """One synthetic enrollment clip per name, of ``lengths`` seconds; the
    names are not in sorted order of first appearance."""
    for i, (name, sec) in enumerate(zip(("carol", "alice", "bob"), lengths)):
        write_wav(root / f"{name}.wav",
                  synth_speech_i16(int(sec * SR), seed=20 + i))
    return root


def test_featurize_corpus_matches_jax(tmp_path):
    d = _corpus(tmp_path / "corpus")
    x, y, sid = corpus.featurize_corpus(d, device="cpu")
    rx, ry, rsid = jax_corpus.featurize_corpus(d)
    assert x.shape == rx.shape == (2 + 1 + 1, 256, 39)   # 3.1 s: 2 windows
    np.testing.assert_allclose(x, rx, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(y, ry)
    assert sid == rsid == {"0": "alice", "1": "bob", "2": "carol"}
    assert not x[1, 121:].any()            # a 1.2 s clip: 121 frames
    write_wav(d / "dave.wav", synth_speech_i16(SR, seed=1), 8000)
    with pytest.raises(ValueError, match="sample rate 8000"):
        corpus.featurize_corpus(d, device="cpu")


def test_featurize_clips_matches_jax():
    clips = [synth_speech_i16(int(sec * SR), seed=s)
             for s, sec in enumerate((3.0, 1.0, 2.6))]
    labels = ["s2", "s1", "s2"]
    x, y, sid = corpus.featurize_clips(clips, labels, dim=5, device="cpu")
    rx, ry, rsid = jax_corpus.featurize_clips(clips, labels, dim=5)
    np.testing.assert_allclose(x, rx, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(y, ry)
    assert sid == rsid and y.shape == (3, 5)


def test_feature_cache_is_read_across_packages(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 256, 39).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1, 1]]
    sid = {"0": "alice", "1": "bob"}
    save_feature_cache(tmp_path / "port.v1", x, y, sid)
    jax_checkpoints.save_feature_cache(tmp_path / "jax.v1", x, y, sid)
    for ours, theirs in (("port.v1", "jax.v1"), ("jax.v1.npz", "port.v1")):
        for got in (load_feature_cache(tmp_path / ours),
                    jax_checkpoints.load_feature_cache(tmp_path / theirs)):
            np.testing.assert_array_equal(got[0], x)
            np.testing.assert_array_equal(got[1], y)
            assert got[2] == sid
    assert (tmp_path / "port.v1.npz").exists()
    assert (tmp_path / "port.v1.json").exists()


def test_timit_catalog_matches_jax(tmp_path):
    flat = tmp_path / "flat"
    for name in ("fadg0_a", "fadg0_b", "mabc1_a"):
        write_wav(flat / f"{name}.wav", synth_speech_i16(400, seed=len(name)))
    data = tmp_path / "kaggle"
    rows = [("FADG0", "TRAIN/DR1/FADG0/SA1.WAV.wav", "TRUE"),
            ("FADG0", "TRAIN/DR1/FADG0/SA1.WAV", "FALSE"),
            ("MABC1", "TEST/DR2/MABC1/SX1.WAV.wav", "TRUE")]
    for i, (_, rel, conv) in enumerate(rows):
        if conv == "TRUE":
            write_wav(data / rel, synth_speech_i16(300, seed=i))
    labels = tmp_path / "labels.csv"
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["speaker_id", "path_from_data_dir", "is_converted_audio"])
        w.writerows(rows)
    for ours, theirs in (
            (TimitCatalog.from_flat_dir(flat), JaxCatalog.from_flat_dir(flat)),
            (TimitCatalog.from_labels_csv(labels, data),
             JaxCatalog.from_labels_csv(labels, data))):
        assert ours.entries == theirs.entries and ours.n_speakers == 2
        assert ours.statistics() == theirs.statistics()
        for i in range(3):
            sig, spk = ours.clip_loader(i, i)
            rsig, rspk = theirs.clip_loader(i, i)
            assert spk == rspk
            np.testing.assert_array_equal(sig, rsig)
        assert [(s, len(a), r) for s, a, r in ours.iter_clips()] == \
            [(s, len(a), r) for s, a, r in theirs.iter_clips()]


def test_register_and_train_match_jax_enrollment(tmp_path):
    """Two 3 s enrollments through both sessions' denoise, webrtc VAD and
    trim (the detector's state carried from the first into the second):
    corpus WAVs of the same length, each sample within the 1 LSB by which
    the two packages' denoise may round apart (``test_torch_denoise.py``);
    then the port's fine-tune (1 + 1 epochs) writes
    the cache, the id dict and the model, and identifies with the new
    2-unit sigmoid head."""
    from mmla_audio_tpu.streaming import capture as jax_capture
    from mmla_audio_tpu.streaming.session import SpeakerSession as JaxSession
    from mmla_audio_tpu.inference import SpeakerPredictor as JaxPredictor

    enroll = [synth_speech_i16(3 * SR, seed=s) for s in (30, 31)]
    enroll[0][SR:SR + SR // 2] = 0                     # a pause to trim
    ident = synth_speech_i16(2 * 40960, seed=32)
    samples = np.concatenate(enroll + [ident])
    tree = perturbed_speaker_tree(NARROW, seed=8)
    jcfg = jax_config.PipelineConfig(speaker_model=NARROW)
    ref = JaxSession(JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                                  model_cfg=NARROW),
                     jax_capture.PrefilledCapture(samples), tmp_path / "jax",
                     cfg=jcfg, host_preprocess=False)
    ref.set_noise_profile(NOISE)
    cfg = port_config.PipelineConfig(speaker_model=as_port(NARROW))
    sd = speaker_state_dict_from_jax(tree, as_port(NARROW))
    sess = SpeakerSession(SpeakerPredictor(sd, as_port(NARROW), device="cpu"),
                          PrefilledCapture(samples), tmp_path / "port",
                          cfg=cfg)
    sess.set_noise_profile(NOISE)
    for name in ("bob", "alice"):
        got = read_wav(sess.register_speaker(name, seconds=3))[0]
        want = read_wav(ref.register_speaker(name, seconds=3))[0]
        assert 0 < len(got) == len(want) < 3 * SR
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    acc = sess.train_on_registered(sd, epochs_override=(1, 1))
    root = sess.dirs.root
    assert 0.0 <= acc <= 1.0
    assert json.loads((root / "speaker_id_dict.json").read_text()) == \
        {"0": "alice", "1": "bob"} == sess.speaker_id_dict
    x, y, sid = load_feature_cache(root / "experiment_feature")
    assert x.shape[1:] == (256, 39) and y.shape[1] == 2 and sid == \
        sess.speaker_id_dict
    meta = json.loads((root / "model" / "metadata.json").read_text())
    assert meta["n_speakers"] == 2 and meta["accuracy"] == acc
    tree2, head = load_speaker_npz(root / "model" / "variables.npz",
                                   as_port(NARROW))
    assert head == 2 and sess.predictor.sigmoid_head
    assert sess.predictor.model.head.out_features == 2
    labels = [r[1] for r in sess.run(max_windows=2)]
    assert len(labels) == 2 and set(labels) <= {"alice", "bob", "silent"}


def test_cli_pretrain_register_then_post(tmp_path, capsys):
    """``speaker-pretrain`` on a flat directory (1 epoch) ->
    ``speaker-live --fake --register a b`` on its weights -> ``speaker-post
    --weights experiment/model/variables.npz``, all on the CPU at the
    default full width."""
    wavs = tmp_path / "wavs"
    for i, name in enumerate(("spk1_a", "spk1_b", "spk2_a")):
        write_wav(wavs / f"{name}.wav", synth_speech_i16(SR, seed=40 + i))
    base = tmp_path / "base"
    cli.main(["speaker-pretrain", "--wav-dir", str(wavs), "--out", str(base),
              "--epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "epoch 0:" in out and "[TIME] speaker-pretrain:" in out
    meta = json.loads((base / "metadata.json").read_text())
    assert meta == {"speakers": {"0": "spk1", "1": "spk2"}}
    assert load_speaker_npz(base / "variables.npz")[1] == 630

    root = tmp_path / "experiment"
    cli.main(["speaker-live", "--fake", "--register", "a", "b",
              "--enroll-seconds", "3", "--phase1-epochs", "1",
              "--phase2-epochs", "1", "--weights", str(base / "variables.npz"),
              "--windows", "1", "--calibrate-seconds", "1",
              "--root", str(root), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "registration accuracy:" in out and out.count("[INFO] window ") == 1
    for rel in ("corpus/a.wav", "corpus/b.wav", "experiment_feature.npz",
                "experiment_feature.json", "speaker_id_dict.json",
                "model/variables.npz", "model/metadata.json"):
        assert (root / rel).exists(), rel
    weights = root / "model" / "variables.npz"
    assert load_speaker_npz(weights)[1] == 2

    write_wav(root / "recordings" / "post-time" / "whole" / "zoom_c.wav",
              synth_speech_i16(6 * SR, seed=44))
    cli.main(["speaker-post", "--root", str(root), "--weights", str(weights),
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[INFO] weights: {weights}" in out
    rows = parse_log(root / "logs" / "zoom_c.txt")
    assert len(rows) == 3 and {r[1] for r in rows} <= {"a", "b", "silent"}
