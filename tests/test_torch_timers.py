"""The port's ``utils/timers.py`` against the JAX package's (the
counterpart of ``tests/test_datasets_profiler.py``'s timer and trace cases),
``overlap-run``'s ``[TIME]`` stages against JAX's, and ``__version__``.

Both CLIs run a narrow seeded predictor here (each CLI's predictor factory
is replaced), so the comparison is of the stages each one times, not of
its speed.
"""

import re
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import mmla_audio_tpu
from mmla_audio_tpu import cli as jax_cli
from mmla_audio_tpu.core.config import OverlapModelConfig
from mmla_audio_tpu.inference import OverlapPredictor as JaxPredictor
from mmla_audio_tpu.utils import timers as jax_timers
import mmla_audio_torch
from mmla_audio_torch import cli
from mmla_audio_torch.data.wavio import write_wav
from mmla_audio_torch.inference import OverlapPredictor
from mmla_audio_torch.params import overlap_state_dict_from_jax
from mmla_audio_torch.utils.timers import RtfMeter, StageTimer, device_trace
from tests.conftest import synth_speech_i16
from tests.test_torch_model import as_port, perturbed_tree

REPO = Path(__file__).resolve().parent.parent


def test_stage_timer_and_rtf_meter_match_jax():
    """The same recorded latencies give the same summary, RTF and p50."""
    ours, theirs = StageTimer(), jax_timers.StageTimer()
    for t in (ours, theirs):
        for _ in range(2):
            with t.stage("x"):
                pass
    assert ours.summary()["x"]["count"] == theirs.summary()["x"]["count"] == 2
    assert ours.summary().keys() == theirs.summary().keys()
    m, ref = RtfMeter(2.56), jax_timers.RtfMeter(2.56)
    for seconds, batch in ((0.256, 10), (0.1, 3), (0.5, 1)):
        m.record(seconds, batch)
        ref.record(seconds, batch)
    assert m.rtf == ref.rtf and m.p50_ms == ref.p50_ms == 256.0
    one = RtfMeter(2.56)
    one.record(0.256, batch=10)
    assert abs(one.rtf - 100.0) < 1e-6


def test_rtf_meter_window_context_and_empty_meters():
    """``window`` records on an exceptional exit too; empty meters read 0."""
    m = RtfMeter(window_seconds=2.56)
    assert m.rtf == 0.0 and m.p50_ms == 0.0
    with m.window(batch=4):
        pass
    with pytest.raises(ValueError):
        with m.window(batch=2):
            raise ValueError("boom")
    assert len(m.latencies) == 2 and m.windows == [4, 2]
    assert m.rtf > 0.0 and m.p50_ms >= 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """A trace file of the block's operators in ``log_dir``."""
    with device_trace(tmp_path / "trace") as prof:
        torch.mm(torch.ones(64, 64), torch.ones(64, 64)).sum()
    files = list((tmp_path / "trace").glob("trace-*.json"))
    assert len(files) == 1 and "aten::mm" in files[0].read_text()
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_overlap_run_times_jax_stages(tmp_path, capsys, monkeypatch):
    """``overlap-run``'s ``[TIME]`` stages are JAX's, in JAX's order;
    ``--parity`` adds the port's ``aot_compile``; both label the clip
    alike."""
    cfg = OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8)
    tree = perturbed_tree(cfg, seed=0)
    monkeypatch.setattr(
        jax_cli, "_predictor_overlap", lambda *a, **kw: JaxPredictor(
            jax.tree_util.tree_map(jnp.asarray, tree), model_cfg=cfg))
    monkeypatch.setattr(
        cli, "_overlap_predictor", lambda args, c: OverlapPredictor(
            overlap_state_dict_from_jax(tree, as_port(cfg)), as_port(cfg),
            device=args.device))
    wav = tmp_path / "clip.wav"
    write_wav(wav, synth_speech_i16(40960, seed=3))

    def run(main, argv):
        main(["overlap-run", "-f", str(wav)] + argv)
        out = capsys.readouterr().out
        return (re.findall(r"^\[TIME\] (\S+): [\d.]+ ms$", out, re.M),
                re.findall(r"^\[RESULT\] clip\.wav: (\S+)$", out, re.M))

    ref_stages, ref_labels = run(jax_cli.main,
                                 ["--root", str(tmp_path / "exp")])
    stages, labels = run(cli.main, ["--device", "cpu"])
    assert stages == ref_stages == ["model_load", "wav_load",
                                    "predict_compile_and_run",
                                    "predict_steady"]
    assert labels == ref_labels and len(labels) == 1
    parity, _ = run(cli.main, ["--device", "cpu", "--parity"])
    assert parity == ref_stages + ["aot_compile"]


def test_version_matches_jax_and_pyproject():
    with open(REPO / "pyproject.toml", "rb") as f:
        project = tomllib.load(f)["project"]["version"]
    assert mmla_audio_torch.__version__ == mmla_audio_tpu.__version__ \
        == project == "0.1.0"
