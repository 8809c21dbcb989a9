"""Sessions named by ``now=``: two port sessions (overlap and speaker)
consuming the same audio concurrently, each with its own log (the
counterpart of ``tests/test_full_pipeline.py::
test_concurrent_sessions_full_pipeline``); two sessions given the same
``now`` (the second raises at construction, the first keeps one header);
``now`` names the log and the recording directory as the JAX package's
``session_stamp(now)`` does."""

import threading
from datetime import datetime

import numpy as np
import pytest
import torch

from mmla_audio_tpu.streaming.session import session_stamp as jax_stamp
from mmla_audio_torch.analyze.charts import visualize_all
from mmla_audio_torch.analyze.logs import parse_log
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.inference import OverlapPredictor, SpeakerPredictor
from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                     speaker_state_dict_from_jax)
from mmla_audio_torch.streaming.capture import ArraySource, CaptureThread
from mmla_audio_torch.streaming.edge import EdgeSpeakerSession
from mmla_audio_torch.streaming.session import (OverlapSession,
                                                SpeakerSession,
                                                session_stamp)
from tests.conftest import synth_speech_i16
from tests.test_torch_inference import CFG
from tests.test_torch_model import as_port, perturbed_tree
from tests.test_torch_speaker import perturbed_speaker_tree
from tests.test_torch_speaker_post import NARROW

torch.set_num_threads(1)

NOISE = (np.random.RandomState(1).randn(160000) * 15).astype(np.int16)
NAMES = {"0": "alice", "1": "bob"}


@pytest.fixture(scope="module")
def predictors():
    overlap = OverlapPredictor(
        overlap_state_dict_from_jax(perturbed_tree(CFG, seed=1),
                                    as_port(CFG)), as_port(CFG),
        device="cpu")
    speaker = SpeakerPredictor(
        speaker_state_dict_from_jax(
            perturbed_speaker_tree(NARROW, head_units=2, seed=7),
            as_port(NARROW), 2),
        as_port(NARROW), head_units=2, sigmoid_head=True, device="cpu")
    return overlap, speaker


def _sessions(predictors, root, audio, now_ov, now_sp):
    ov_cap = CaptureThread(ArraySource(audio)).start()
    sp_cap = CaptureThread(ArraySource(audio)).start()
    try:
        ov = OverlapSession(predictors[0], ov_cap, root, now=now_ov,
                            cfg=port_config.PipelineConfig(
                                overlap_model=as_port(CFG)))
        sp = SpeakerSession(predictors[1], sp_cap, root, now=now_sp,
                            speaker_id_dict=NAMES,
                            cfg=port_config.PipelineConfig(
                                speaker_model=as_port(NARROW)))
    except BaseException:
        ov_cap.stop()
        sp_cap.stop()
        raise
    return (ov, ov_cap), (sp, sp_cap)


def test_concurrent_sessions_full_pipeline(predictors, tmp_path):
    """Two sessions (overlap + speaker) with distinct ``now`` consume the
    same audio on two threads: two logs, each parsed, 3 rows each."""
    audio = np.concatenate([synth_speech_i16(40960, seed=s)
                            for s in range(3)])
    root = tmp_path / "experiment"
    (ov, ov_cap), (sp, sp_cap) = _sessions(
        predictors, root, audio, datetime(2026, 1, 1, 10, 0, 0),
        datetime(2026, 1, 1, 11, 0, 0))
    ov.set_noise_profile(NOISE)
    sp.set_noise_profile(NOISE)
    results = {}

    def run(name, sess):
        results[name] = sess.run(max_windows=3)

    threads = [threading.Thread(target=run, args=("ov", ov)),
               threading.Thread(target=run, args=("sp", sp))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    ov_cap.stop()
    sp_cap.stop()

    assert len(results["ov"]) == 3 and len(results["sp"]) == 3
    logs = sorted((root / "logs").glob("*.txt"))
    assert [p.name for p in logs] == ["2026-01-01-10-00-00.txt",
                                      "2026-01-01-11-00-00.txt"]
    for log, rows in zip(logs, (results["ov"], results["sp"])):
        assert [r[:2] for r in parse_log(log)] == [r[:2] for r in rows]
    assert logs[0].read_text().startswith("segment\toverlap")
    assert logs[1].read_text().startswith("segment\tspeaker")
    charts = visualize_all(root / "logs", root / "charts", kind="overlap")
    assert len(charts) == 2
    for c in charts:
        assert "<svg" in c.read_text()


def test_sessions_with_one_now_refuse_the_second(predictors, tmp_path):
    """The same ``now`` twice under one root: the second session raises
    ``FileExistsError`` when it is built, before it captures anything; the
    first session's log holds one header and parses."""
    audio = synth_speech_i16(2 * 40960, seed=4)
    root = tmp_path / "experiment"
    now = datetime(2026, 1, 1, 10, 0, 0)
    with pytest.raises(FileExistsError, match="give each session its own"):
        _sessions(predictors, root, audio, now, now)
    logs = list((root / "logs").glob("*.txt"))
    assert [p.name for p in logs] == ["2026-01-01-10-00-00.txt"]
    assert parse_log(logs[0]) == []
    assert logs[0].read_text().count("segment") == 1
    # an edge session too, and a distinct now still works
    with pytest.raises(FileExistsError):
        EdgeSpeakerSession(predictors[1], None, root, now=now)
    other = EdgeSpeakerSession(predictors[1], None, root,
                               now=datetime(2026, 1, 1, 10, 0, 1))
    assert other.log.path.read_text() == "segment\tspeaker\n"


def test_now_names_the_log_and_the_recordings(predictors, tmp_path):
    now = datetime(2026, 3, 4, 5, 6, 7, 890123)
    sess = OverlapSession(predictors[0], None, tmp_path, now=now,
                          save_recordings=True)
    stamp = session_stamp(now)
    assert stamp == jax_stamp(now) == "2026-03-04-05-06-07"
    assert sess.log.path == tmp_path / "logs" / f"{stamp}.txt"
    assert sess.rec_dir == tmp_path / "recordings" / "real-time" / stamp \
        / "wav"
    assert sess.rec_dir.is_dir()
    assert sess.log.path.read_text().startswith("segment\toverlap")
