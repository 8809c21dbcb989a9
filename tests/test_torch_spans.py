"""The port's program spans and counters (``utils/timers.py``): under
``torch.profiler`` a session and a multiplexer emit their named spans,
nested as the modules' docstrings say; with no profiler running no
``record_function`` is entered; ``phase_seconds`` keeps its five phases;
the log-handle LRU, the calibration cache and the builds count what they
do; set-up spans add to the process's record once however they nest."""

from collections import OrderedDict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmla_audio_torch import _build
from mmla_audio_torch.analyze import logs as logs_mod
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.inference import OverlapPredictor, SpeakerPredictor
from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                     speaker_state_dict_from_jax)
from mmla_audio_torch.streaming.capture import PrefilledCapture
from mmla_audio_torch.streaming.multiplex import Multiplexer
from mmla_audio_torch.streaming.session import OverlapSession, SpeakerSession
from mmla_audio_torch.utils import timers
from tests.conftest import synth_speech_i16
from tests.test_torch_inference import CFG
from tests.test_torch_model import as_port, perturbed_tree
from tests.test_torch_speaker import perturbed_speaker_tree
from tests.test_torch_speaker_post import NARROW

torch.set_num_threads(1)

WIN = 40960
NOISE = (np.random.RandomState(1).randn(160000) * 15).astype(np.int16)
PHASES = {"gather": "mux.gather", "stage": "mux.stage",
          "dispatch": "mux.dispatch", "resolve_fetch": "mux.fetch",
          "resolve_log": "mux.log"}
PROGRAM = ("session.", "mux.", "chain.", "model.", "logs.", "setup.")


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
    return {"overlap": overlap, "speaker": speaker}


def _audio(windows, seed=0):
    return np.concatenate([synth_speech_i16(WIN, seed=seed + w)
                           for w in range(windows)])


def _session(predictors, kind, root, windows=3):
    if kind == "overlap":
        sess = OverlapSession(predictors[kind],
                              PrefilledCapture(_audio(windows)), root,
                              cfg=port_config.PipelineConfig(
                                  overlap_model=as_port(CFG)))
    else:
        sess = SpeakerSession(predictors[kind],
                              PrefilledCapture(_audio(windows)), root,
                              speaker_id_dict={"0": "a", "1": "b"},
                              cfg=port_config.PipelineConfig(
                                  speaker_model=as_port(NARROW)))
    sess.set_noise_profile(NOISE)
    return sess


def _mux(predictors, root, streams=3, windows=2):
    mux = Multiplexer(predictors["overlap"], root, kind="overlap", bucket=4,
                      cfg=port_config.PipelineConfig(
                          overlap_model=as_port(CFG)), device="cpu")
    for s in range(streams):
        mux.add_stream(f"s{s}", PrefilledCapture(_audio(windows, 10 * s)),
                       NOISE)
    return mux


def _traced(fn):
    """``fn()`` under the profiler: (its result, the program's spans as
    (start, end, name))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.name.startswith(PROGRAM)]
    return out, spans


def _of(spans, name):
    return [s for s in spans if s[2] == name]


def _all_inside(inner, outer) -> bool:
    return all(any(o[0] <= s and e <= o[1] for o in outer)
               for s, e, _ in inner)


@pytest.mark.parametrize("kind", ["overlap", "speaker"])
def test_session_spans_nest_in_the_window(predictors, kind, tmp_path):
    sess = _session(predictors, kind, tmp_path / kind)
    seen = []
    results, spans = _traced(lambda: sess.run(
        on_result=lambda *a: seen.append(a)))
    assert len(results) == len(seen) == 3
    windows = _of(spans, "session.window")
    # three windows, then the read that finds the capture's end
    assert len(windows) == len(_of(spans, "session.read")) == 4
    chains = _of(spans, "session.chain")
    predicts = _of(spans, "session.predict")
    for name in ("session.chain", "session.vad_fetch", "session.vad_engine",
                 "session.trim", "session.predict", "session.probs_fetch",
                 "session.log", "session.callback"):
        assert len(_of(spans, name)) == 3, name
        assert _all_inside(_of(spans, name), windows), name
    for name in ("session.vad_fetch", "session.vad_engine", "session.trim"):
        assert _all_inside(_of(spans, name), chains), name
    for name in ("model.features", "model.forward", "model.labels"):
        assert len(_of(spans, name)) == 3, name
        assert _all_inside(_of(spans, name), predicts), name


def test_multiplexer_spans_nest_in_their_phases(predictors, tmp_path):
    mux = _mux(predictors, tmp_path / "mux")
    total, spans = _traced(mux.run_until_exhausted)
    assert total == 6
    dispatches = _of(spans, "mux.dispatch")
    assert dispatches and len(_of(spans, "mux.stage")) == len(dispatches)
    assert len(_of(spans, "mux.fetch")) == len(_of(spans, "mux.log")) \
        == len(dispatches)
    assert _of(spans, "mux.gather")
    for name in ("chain.denoise", "chain.detect", "chain.trim",
                 "model.features", "model.forward", "model.labels"):
        assert len(_of(spans, name)) == len(dispatches), name
        assert _all_inside(_of(spans, name), dispatches), name
    forwards = _of(spans, "model.forward")
    assert len(_of(spans, "model.stage")) == 3 * len(dispatches)
    assert len(_of(spans, "model.lstm")) == len(dispatches)
    assert _all_inside(_of(spans, "model.stage") + _of(spans, "model.lstm"),
                       forwards)
    # each stream's first append opens its log
    reopens = _of(spans, "logs.reopen")
    assert len(reopens) == 3 and _all_inside(reopens, _of(spans, "mux.log"))


@pytest.mark.parametrize("path", ["session", "multiplexer"])
def test_no_record_function_without_a_profiler(predictors, path, tmp_path,
                                               monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)

    def serve(root):
        if path == "session":
            return len(_session(predictors, "overlap", root).run())
        return _mux(predictors, root).run_until_exhausted()

    assert serve(tmp_path / "off") > 0
    assert not [n for n in entered if n.startswith(PROGRAM)]
    _traced(lambda: serve(tmp_path / "on"))
    assert [n for n in entered if n.startswith(PROGRAM)]


def test_phase_seconds_keep_their_five_phases(predictors, tmp_path):
    """Traced or not, ``phase_seconds`` is the plain dict of its five
    phases, each phase's span beside its interval."""
    mux = _mux(predictors, tmp_path / "a")
    mux.run_until_exhausted()
    assert type(mux.phase_seconds) is dict
    assert list(mux.phase_seconds) == list(PHASES)
    untraced = dict(mux.phase_seconds)
    mux = _mux(predictors, tmp_path / "b")
    _, spans = _traced(mux.run_until_exhausted)
    assert list(mux.phase_seconds) == list(PHASES)
    for key, name in PHASES.items():
        assert untraced[key] > 0.0
        # the interval holds its span
        assert mux.phase_seconds[key] * 1e6 >= sum(
            e - s for s, e, _ in _of(spans, name)) > 0, key


def test_log_handle_counters(tmp_path, monkeypatch):
    monkeypatch.setattr(logs_mod, "_MAX_OPEN_HANDLES", 2)
    monkeypatch.setattr(logs_mod, "_OPEN_HANDLES", OrderedDict())
    a, b, c = (logs_mod.SessionLog(tmp_path / f"{n}.txt") for n in "abc")
    before = logs_mod.handle_stats()
    for log in (a, b, a, c, b):
        log.append("overlapped")
    after = logs_mod.handle_stats()
    # a, b open; a found; c opens and evicts b; b opens again, evicts a
    assert {k: after[k] - before[k] for k in after} == \
        {"hits": 1, "misses": 4, "evictions": 2}
    for log in (a, b, c):
        log.close()
    assert [r[0] for r in logs_mod.parse_log(b.path)] == [1, 2]


def test_calibration_cache_counters_and_set_up_spans(predictors, tmp_path):
    setup0 = timers.setup_seconds()
    stream0 = timers.PROGRAM.totals["setup.stream"]
    counts0 = dict(timers.PROGRAM.counts)
    mux = _mux(predictors, tmp_path / "mux", streams=3)
    assert (mux.calib_misses, mux.calib_hits) == (1, 2)
    mux.add_stream("other", PrefilledCapture(_audio(1)), NOISE[::2].copy())
    assert (mux.calib_misses, mux.calib_hits) == (2, 2)
    counts = timers.PROGRAM.counts
    assert counts["setup.stream"] - counts0.get("setup.stream", 0) == 4
    assert counts["setup.calibrate"] - counts0.get("setup.calibrate", 0) \
        == 2
    # a calibration inside add_stream counts once in the process's seconds
    assert timers.setup_seconds() - setup0 == pytest.approx(
        timers.PROGRAM.totals["setup.stream"] - stream0, rel=1e-6)


def test_build_counters_say_found_the_second_time(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_build_dir", tmp_path / "fresh")
    compiles, found = _build.compiles, _build.found
    kernels = timers.PROGRAM.counts["setup.kernels"]
    build = _build.host_library.__wrapped__       # past the process's cache
    build()
    name = next((tmp_path / "fresh").glob("libmmla_host-*.so")).name
    assert (_build.compiles - compiles, _build.found - found) == (1, 0)
    assert _build.outcomes[name] == "compiled"
    build()
    assert (_build.compiles - compiles, _build.found - found) == (1, 1)
    assert timers.PROGRAM.counts["setup.kernels"] - kernels == 2
