"""The port's export surface (``mmla_audio_torch.export``) and the CLI
flags that use it, on the CPU: ``export_serving``/``load_serving`` round
trips (tensor for tensor, the model's kind read from the file),
``aot_compile`` (shape, dtype and device pinned; the same outputs as the
eager function) and ``parity_check`` (a mismatch caught), ``overlap-run
--parity``, and ``--ckpt`` on every command that takes it against
``--weights`` of the same weights, with its refusals.  On the card
``aot_compile`` captures a CUDA graph: ``chip_smoke.py`` phase 11.
"""

import re

import numpy as np
import pytest
import torch

from chip_smoke import seeded_tree
from mmla_audio_torch import cli
from mmla_audio_torch.core.config import (OverlapModelConfig,
                                          SpeakerModelConfig)
from mmla_audio_torch.data.wavio import write_wav
from mmla_audio_torch.export import (aot_compile, export_serving,
                                     load_serving, parity_check)
from mmla_audio_torch.inference import OverlapPredictor
from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                     overlap_tree_shapes, save_npz,
                                     speaker_state_dict_from_jax,
                                     speaker_tree_shapes)
from mmla_audio_torch.utils.experiment import bootstrap
from tests.conftest import synth_speech_i16

torch.set_num_threads(1)

NARROW = OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8)
SPEAKER = SpeakerModelConfig(stage_filters=(4, 8), blocks_per_stage=2,
                             lstm_units=4, num_speakers=5)


@pytest.fixture(scope="module")
def overlap_full():
    """The full-width overlap model's seeded tree and state dict (the
    CLI's configuration)."""
    tree = seeded_tree(overlap_tree_shapes(OverlapModelConfig()),
                       np.random.RandomState(0))
    return tree, overlap_state_dict_from_jax(tree, OverlapModelConfig())


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_export_load_roundtrip_overlap(tmp_path, overlap_full):
    _, sd = overlap_full
    export_serving(tmp_path / "bundle", sd, input_shape=(1, 40960),
                   model_name="overlap", extra_meta={"note": "x"})
    back, meta = load_serving(tmp_path / "bundle")
    assert meta == {"model": "overlap", "input_shape": [1, 40960],
                    "note": "x"}
    _equal(back, sd)


def test_export_load_roundtrip_speaker(tmp_path):
    tree = seeded_tree(speaker_tree_shapes(SPEAKER, 3),
                       np.random.RandomState(1))
    sd = speaker_state_dict_from_jax(tree, SPEAKER, 3)
    export_serving(tmp_path / "bundle", sd, input_shape=(1, 40960),
                   model_name="speaker", cfg=SPEAKER)
    back, meta = load_serving(tmp_path / "bundle", SPEAKER)
    assert meta["model"] == "speaker" and back["head.bias"].shape == (3,)
    _equal(back, sd)
    with pytest.raises(FileNotFoundError, match="no variables.npz"):
        load_serving(tmp_path)


def _predictor():
    tree = seeded_tree(overlap_tree_shapes(NARROW), np.random.RandomState(2))
    return OverlapPredictor(overlap_state_dict_from_jax(tree, NARROW),
                            NARROW, device="cpu", matmul_precision="highest")


def test_aot_compile_pins_the_signature():
    pred = _predictor()
    bufs = torch.from_numpy(np.stack([synth_speech_i16(40960, seed=s)
                                      for s in range(3)]))
    counts = torch.tensor([40960, 20000, 1000], dtype=torch.int32)
    compiled = aot_compile(pred.predict, bufs, counts)
    labels, probs = compiled(bufs, counts)
    ref_labels, ref_probs = pred.predict(bufs, counts)
    assert torch.equal(labels, ref_labels) and torch.equal(probs, ref_probs)
    parity_check(lambda b, n: pred.predict(b, n)[1],
                 lambda b, n: compiled(b, n)[1], (bufs, counts))
    with pytest.raises(ValueError, match="compiled for"):
        compiled(bufs[:2], counts[:2])
    with pytest.raises(ValueError, match="compiled for"):
        compiled(bufs.float(), counts)
    with pytest.raises(TypeError, match="tensors"):
        aot_compile(pred.predict, bufs.numpy(), counts)
    with pytest.raises(ValueError, match="several devices"):
        aot_compile(pred.predict, bufs, counts.to("meta"))


def test_parity_check_catches_mismatch():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3)
                         .astype(np.float32))
    compiled = aot_compile(lambda t: -t, x)
    with pytest.raises(AssertionError):
        parity_check(lambda t: t, compiled, (x,))


def test_cli_overlap_run_parity_and_ckpt(tmp_path, capsys, overlap_full):
    tree, sd = overlap_full
    wav = tmp_path / "clip.wav"
    write_wav(wav, synth_speech_i16(30000, seed=5))
    npz = tmp_path / "weights.npz"
    save_npz(tree, npz)
    export_serving(tmp_path / "ckpt", sd, input_shape=(1, 40960),
                   model_name="overlap")
    results = []
    for flags in (["--weights", str(npz)],
                  ["--ckpt", str(tmp_path / "ckpt"), "--parity"]):
        cli.main(["overlap-run", "-f", str(wav), "--device", "cpu"] + flags)
        out = capsys.readouterr().out
        results.append(re.findall(r"^\[RESULT\] clip\.wav: (\S+)$", out,
                                  re.M))
    assert "[INFO] AOT parity check passed" in out
    assert f"[INFO] weights: {tmp_path / 'ckpt' / 'variables.npz'}" in out
    assert results[0] == results[1] and len(results[0]) == 1


@pytest.mark.parametrize("argv,message", [
    (["overlap-run", "-f", "x.wav"], "holds no variables.npz"),
    (["overlap-post"], "holds no variables.npz"),
    (["speaker-post"], "holds no variables.npz"),
    (["overlap-live", "--fake"], "holds no variables.npz"),
    (["speaker-live", "--fake"], "holds no variables.npz"),
    (["overlap-run", "-f", "x.wav", "--weights", "w.npz"], "not both")])
def test_cli_refuses_a_ckpt_without_weights(tmp_path, argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(argv + ["--ckpt", str(tmp_path), "--device", "cpu",
                         "--root", str(tmp_path / "exp")])


def test_cli_post_with_ckpt_matches_weights(tmp_path, capsys, overlap_full):
    """``overlap-post --ckpt D`` (D from ``export_serving``) logs what
    ``--weights D/variables.npz`` logs."""
    tree, sd = overlap_full
    export_serving(tmp_path / "ckpt", sd, input_shape=(1, 40960),
                   model_name="overlap")
    logs = []
    for i, flags in enumerate((["--ckpt", str(tmp_path / "ckpt")],
                               ["--weights", str(tmp_path / "ckpt" /
                                                 "variables.npz")])):
        root = tmp_path / f"exp{i}"
        dirs = bootstrap(root)
        write_wav(dirs.post_whole / "audio_a.wav",
                  np.concatenate([synth_speech_i16(40000, seed=7),
                                  np.zeros(20000, np.int16),
                                  synth_speech_i16(30000, seed=8)]))
        cli.main(["overlap-post", "--root", str(root), "--device", "cpu",
                  "--vad", "energy"] + flags)
        capsys.readouterr()
        logs.append([ln.split("\t")[:2] for ln in
                     (dirs.logs / "audio_a.txt").read_text().splitlines()])
    assert logs[0] == logs[1] and len(logs[0]) > 2


def test_cli_speaker_live_with_ckpt(tmp_path, capsys):
    """A speaker checkpoint directory (head of 630, the base model's) as
    ``speaker-live --ckpt``."""
    cfg = SpeakerModelConfig()
    tree = seeded_tree(speaker_tree_shapes(cfg), np.random.RandomState(3))
    export_serving(tmp_path / "ckpt", speaker_state_dict_from_jax(tree, cfg),
                   input_shape=(1, 40960), model_name="speaker")
    cli.main(["speaker-live", "--fake", "--windows", "1", "--vad", "energy",
              "--calibrate-seconds", "1", "--root", str(tmp_path / "exp"),
              "--device", "cpu", "--ckpt", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert f"[INFO] weights: {tmp_path / 'ckpt' / 'variables.npz'}" in out
    assert out.count("[INFO] window ") == 1
