"""The port's speaker serving surfaces vs the JAX package: ``SpeakerSession``
(identify), ``speaker_post_analyze`` for both VAD decisions, the CLI's
``speaker-post`` and ``speaker-live --fake``, and every ported subcommand's
flags against the JAX parser.

The JAX session runs its on-device arrangement (``host_preprocess=False``):
its pure-JAX webrtc engine is bit-identical to the port's native one, and
its other arrangements would load the JAX package's native library.  Logs
are compared row for row: same labels, same indices, same timestamps.
"""

import argparse
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu import cli as jax_cli
from mmla_audio_tpu.analyze.post_time import \
    speaker_post_analyze as jax_speaker_post
from mmla_audio_tpu.core import config as jax_config
from mmla_audio_tpu.inference import SpeakerPredictor as JaxPredictor
from mmla_audio_tpu.utils.experiment import bootstrap as jax_bootstrap
from mmla_audio_torch import cli
from mmla_audio_torch.analyze.logs import parse_log
from mmla_audio_torch.analyze.post_time import (speaker_id_dict_from_corpus,
                                                speaker_post_analyze)
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.data.wavio import write_wav
from mmla_audio_torch.inference import SpeakerPredictor
from mmla_audio_torch.params import save_npz, speaker_state_dict_from_jax
from mmla_audio_torch.utils.experiment import bootstrap
from tests.conftest import synth_speech_i16
from tests.test_torch_model import as_port
from tests.test_torch_speaker import perturbed_speaker_tree

torch.set_num_threads(1)

T0 = datetime(2026, 1, 1)
NOISE = (np.random.RandomState(9).randn(160000) * 20).astype(np.int16)
NARROW = jax_config.SpeakerModelConfig(stage_filters=(8, 8, 16),
                                       lstm_units=8)
SR, WIN = 16000, 40960


@pytest.fixture(scope="module")
def predictors():
    """A narrow model with an enrolled 2-speaker sigmoid head, from one
    perturbed numpy tree."""
    tree = perturbed_speaker_tree(NARROW, head_units=2, seed=7)
    jax_pred = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                            model_cfg=NARROW, head_units=2, sigmoid_head=True)
    pred = SpeakerPredictor(
        speaker_state_dict_from_jax(tree, as_port(NARROW), 2),
        as_port(NARROW), head_units=2, sigmoid_head=True, device="cpu")
    return jax_pred, pred


def _conversation(seconds, silent_spans, seed):
    """Speech with zeroed spans (start, end) in seconds."""
    sig = synth_speech_i16(int(seconds * SR), seed=seed)
    for a, b in silent_spans:
        sig[int(a * SR):int(b * SR)] = 0
    return sig


def _experiment(root):
    """Two recordings and a 2-speaker corpus: the 6 s ``audio*`` one (3
    denoise passes) is silent after 2.56 s, so its second segment is silent
    and its last, partial slice silent too but never gated; the 12 s
    ``zoom*`` one is silent in its third segment."""
    whole = root / "recordings" / "post-time" / "whole"
    write_wav(whole / "audio_conv0.wav", _conversation(6, [(2.56, 6)], 0))
    write_wav(whole / "zoom_conv1.wav", _conversation(12, [(5.12, 7.68)], 1))
    for i, name in enumerate(("bob", "alice")):
        write_wav(root / "corpus" / f"{name}.wav",
                  synth_speech_i16(SR, seed=10 + i))


@pytest.mark.parametrize("decision", ["webrtc", "energy"])
def test_speaker_post_matches_jax(predictors, tmp_path, decision):
    jax_pred, pred = predictors
    jcfg = jax_config.PipelineConfig(
        vad=jax_config.VadConfig(decision=decision), speaker_model=NARROW)
    cfg = port_config.PipelineConfig(
        vad=port_config.VadConfig(decision=decision),
        speaker_model=as_port(NARROW))
    jdirs = jax_bootstrap(tmp_path / "jax")
    _experiment(jdirs.root)
    jlogs = jax_speaker_post(jdirs, jax_pred, cfg=jcfg, noise=NOISE,
                             start_time=T0)
    dirs = bootstrap(tmp_path / "port")
    _experiment(dirs.root)
    logs = speaker_post_analyze(dirs, pred, cfg=cfg, noise=NOISE,
                                start_time=T0)

    assert sorted(logs) == sorted(jlogs) == ["audio_conv0", "zoom_conv1"]
    for name in logs:
        rows = parse_log(logs[name])
        assert rows == parse_log(jlogs[name])
        assert logs[name].read_bytes() == jlogs[name].read_bytes()
        assert (dirs.charts / f"{name}.html").read_text() == \
            (jdirs.charts / f"{name}.html").read_text()
        assert rows[0][0] == 0
        assert rows[0][2] == "2026-01-01 00:00:02.560000"   # +2.56 s first
    short = [r[1] for r in parse_log(logs["audio_conv0"])]
    long = [r[1] for r in parse_log(logs["zoom_conv1"])]
    assert len(short) == 3 and len(long) == 5   # ceil(T / 256) slices
    # segment 1 of the short file and 2 of the long one are silent; the
    # short file's last slice is silent audio past its 2 whole segments,
    # which the gate never covers (the reference's behaviour)
    assert short[1] == "silent" and short[2] in ("alice", "bob")
    assert long[2] == "silent" and short[0] != "silent"
    assert speaker_id_dict_from_corpus(dirs.corpus) == {"0": "alice",
                                                        "1": "bob"}


def test_speaker_session_matches_jax(predictors, tmp_path):
    from mmla_audio_tpu.streaming import capture as jax_capture
    from mmla_audio_tpu.streaming.session import SpeakerSession as JaxSession
    from mmla_audio_torch.streaming.capture import ArraySource, CaptureThread
    from mmla_audio_torch.streaming.session import SpeakerSession

    samples = np.concatenate([synth_speech_i16(WIN, seed=1),
                              np.zeros(WIN, np.int16),
                              synth_speech_i16(WIN, seed=2)])
    names = {"0": "alice", "1": "bob"}
    cap = jax_capture.CaptureThread(jax_capture.ArraySource(samples)).start()
    ref = JaxSession(predictors[0], cap, tmp_path / "jax",
                     speaker_id_dict=names,
                     cfg=jax_config.PipelineConfig(speaker_model=NARROW),
                     host_preprocess=False)
    ref.set_noise_profile(NOISE)
    ref_rows = ref.run(max_windows=3)
    cap.stop()

    cap = CaptureThread(ArraySource(samples)).start()
    sess = SpeakerSession(
        predictors[1], cap, tmp_path / "torch", speaker_id_dict=names,
        cfg=port_config.PipelineConfig(speaker_model=as_port(NARROW)))
    sess.set_noise_profile(NOISE)
    rows = sess.run(max_windows=3)
    cap.stop()

    labels = [r[1] for r in rows]
    assert labels == [r[1] for r in ref_rows]
    assert labels[1] == "silent" and labels[0] in names.values()
    logged = [(i, lab) for i, lab, _ in parse_log(sess.log.path)]
    assert logged == [(i, lab) for i, lab, _ in parse_log(ref.log.path)]
    assert logged == [(1, labels[0]), (2, labels[1]), (3, labels[2])]
    assert sess.log.path.read_text().startswith("segment\tspeaker\t")


def test_cli_speaker_post(tmp_path, capsys):
    """The head is as wide as the corpus (2, sigmoid); ``--weights`` with
    another width is refused before anything runs."""
    root = tmp_path / "experiment"
    _experiment(root)
    cli.main(["speaker-post", "--root", str(root), "--device", "cpu",
              "--vad", "energy"])
    out = capsys.readouterr().out
    assert "[TIME] speaker-post:" in out and "zoom_conv1" in out
    rows = parse_log(root / "logs" / "zoom_conv1.txt")
    assert len(rows) == 5
    assert {r[1] for r in rows} <= {"alice", "bob", "silent"}
    assert (root / "charts" / "zoom_conv1.html").exists()
    tree = perturbed_speaker_tree(head_units=3, seed=1)
    save_npz(tree, tmp_path / "w3.npz")
    with pytest.raises(SystemExit, match="3 units.*2 speakers"):
        cli.main(["speaker-post", "--root", str(root), "--device", "cpu",
                  "--weights", str(tmp_path / "w3.npz")])


def test_cli_speaker_live_fake(tmp_path, capsys):
    cli.main(["speaker-live", "--fake", "--windows", "2", "--vad", "energy",
              "--calibrate-seconds", "1", "--root", str(tmp_path / "exp"),
              "--device", "cpu", "--precision", "default"])
    out = capsys.readouterr().out
    assert out.count("[INFO] window ") == 2
    logs = list((tmp_path / "exp" / "logs").glob("*.txt"))
    assert len(logs) == 1 and [r[0] for r in parse_log(logs[0])] == [1, 2]
    assert logs[0].read_text().startswith("segment\tspeaker\t")


# speaker-live --register runs: tests/test_torch_register.py.  Without
# --fake the live commands open the microphone, which needs pyaudio (not
# installed here); --host-preprocess is refused together with --edge.
@pytest.mark.parametrize("argv,message", [
    (["speaker-live"], "needs the pyaudio package"),
    (["overlap-live"], "needs the pyaudio package"),
    (["overlap-live", "--fake", "--edge", "--host-preprocess"],
     "not supported with --edge"),
    (["speaker-live", "--fake", "--edge", "--host-preprocess"],
     "not supported with --edge")])
def test_cli_refuses_what_is_not_ported(tmp_path, argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(argv + ["--root", str(tmp_path), "--device", "cpu"])


class _Parsed(Exception):
    pass


def _flags(main, monkeypatch):
    """{subcommand: its option strings} of a CLI's parser."""
    parsers = []

    def grab(self, *args, **kwargs):
        parsers.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main([])
    sub = next(a for a in parsers[0]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {o: a for a in p._actions for o in a.option_strings
                   if o not in ("-h", "--help")}
            for name, p in sub.choices.items()}


# JAX flags the port does not take, by subcommand: none is left
NOT_YET = {cmd: set() for cmd in (
    "setup", "overlap-live", "speaker-live", "overlap-post", "speaker-post",
    "overlap-run", "speaker-pretrain", "synth-corpus", "overlap-train",
    "charts")}
# the port's own: the device, the .npz weights, and the seed (random init,
# and the order of training) where the JAX command has none
OWN = {"setup": set(), "charts": set(),
       "overlap-live": {"--device", "--weights"},
       "speaker-live": {"--device", "--weights"},
       "overlap-post": {"--device", "--weights", "--seed"},
       "speaker-post": {"--device", "--weights", "--seed"},
       "overlap-run": {"--device", "--weights", "--seed"},
       "speaker-pretrain": {"--device"},
       "synth-corpus": set(),
       "overlap-train": {"--device", "--seed"}}


@pytest.mark.parametrize("cmd", sorted(NOT_YET))
def test_cli_flags_match_jax(cmd, monkeypatch):
    ours = _flags(cli.main, monkeypatch)[cmd]
    theirs = _flags(jax_cli.main, monkeypatch)[cmd]
    assert set(theirs) - set(ours) == NOT_YET[cmd]
    assert set(ours) - set(theirs) == OWN[cmd]
    for flag in set(ours) & set(theirs):          # every JAX value taken
        if theirs[flag].choices:
            assert set(theirs[flag].choices) <= set(ours[flag].choices)
    if "--precision" in ours:
        assert ours["--precision"].default == theirs["--precision"].default


@pytest.mark.parametrize("name,want", [("default", "auto"), ("auto", "auto"),
                                       ("highest", "highest"), ("fast", None)])
def test_cli_precision_names(name, want):
    assert cli._matmul_precision(argparse.Namespace(precision=name)) == want
