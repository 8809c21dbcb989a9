"""The port's post-time overlap path vs the JAX package: standardize and
segment, ``overlap_post_analyze`` on the same recordings and weights (the
weights travel through the flat ``.npz``), the charts' HTML, ``SessionLog``,
and the CLI's ``overlap-post`` and ``charts``."""

from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.analyze import charts as jax_charts
from mmla_audio_tpu.analyze.logs import SessionLog as JaxLog
from mmla_audio_tpu.analyze.post_time import \
    overlap_post_analyze as jax_overlap_post
from mmla_audio_tpu.data import standardize as jax_std
from mmla_audio_tpu.inference import OverlapPredictor as JaxPredictor
from mmla_audio_tpu.utils.experiment import bootstrap as jax_bootstrap
from mmla_audio_torch import cli
from mmla_audio_torch.analyze import charts
from mmla_audio_torch.analyze.logs import SessionLog, parse_log
from mmla_audio_torch.analyze.post_time import overlap_post_analyze
from mmla_audio_torch.core.config import VadConfig
from mmla_audio_torch.data import standardize
from mmla_audio_torch.data.wavio import read_wav, write_wav
from mmla_audio_torch.inference import OverlapPredictor
from mmla_audio_torch.params import (load_overlap_npz,
                                     overlap_state_dict_from_jax, save_npz)
from mmla_audio_torch.utils.experiment import bootstrap
from tests.conftest import synth_speech_i16
from tests.test_torch_inference import CFG
from tests.test_torch_model import as_port, perturbed_tree

torch.set_num_threads(1)

T0 = datetime(2026, 1, 1)
NOISE = (np.random.RandomState(9).randn(160000) * 20).astype(np.int16)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A perturbed JAX tree written as the flat .npz with np.savez."""
    tree = perturbed_tree(CFG, seed=4)
    path = tmp_path_factory.mktemp("w") / "overlap.npz"
    np.savez(path, **_flatten(tree))
    return tree, path


def _recordings(root, files):
    for name, seconds, seed in files:
        write_wav(root / "recordings" / "post-time" / "whole" / name,
                  synth_speech_i16(16000 * seconds, seed=seed))


def test_npz_weights_round_trip(weights, tmp_path):
    tree, path = weights
    loaded = load_overlap_npz(path, as_port(CFG))
    sd = overlap_state_dict_from_jax(loaded, as_port(CFG))
    ref = overlap_state_dict_from_jax(tree, as_port(CFG))
    assert all(torch.equal(sd[k], ref[k]) for k in ref)
    save_npz(loaded, tmp_path / "again.npz")
    with np.load(tmp_path / "again.npz") as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    bad = _flatten(tree)
    del bad["params/head/bias"]
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="mismatch"):
        load_overlap_npz(tmp_path / "bad.npz", as_port(CFG))


def test_overlap_post_matches_jax(weights, tmp_path):
    """Same recordings (an ``audio*`` file with 3 denoise passes, a
    ``zoom*`` file with none), noise and weights: identical log rows and
    charts.  The standardized ``zoom*`` audio is identical; the ``audio*``
    audio is held within 1 % in RMS: each denoise pass agrees with JAX's
    within 1 LSB (test_standardize_matches_jax), but the gate's next pass
    turns a few 1-LSB differences into up to ~20 LSB, in JAX as in the
    port."""
    tree, path = weights
    files = [("audio_conv0.wav", 6, 0), ("zoom_conv1.wav", 3, 1)]
    jdirs = jax_bootstrap(tmp_path / "jax")
    _recordings(jdirs.root, files)
    jpred = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                         model_cfg=CFG)
    jlogs = jax_overlap_post(jdirs, jpred, noise=NOISE, start_time=T0)

    dirs = bootstrap(tmp_path / "port")
    _recordings(dirs.root, files)
    pred = OverlapPredictor(
        overlap_state_dict_from_jax(load_overlap_npz(path, as_port(CFG)),
                                    as_port(CFG)),
        as_port(CFG), device="cpu", matmul_precision="highest")
    logs = overlap_post_analyze(dirs, pred, noise=NOISE, start_time=T0)

    assert sorted(logs) == sorted(jlogs) == ["audio_conv0", "zoom_conv1"]
    for name in logs:
        rows = parse_log(logs[name])
        assert rows == parse_log(jlogs[name])
        assert len(rows) == {"audio_conv0": 4, "zoom_conv1": 2}[name]
        assert rows[1][2] == "2026-01-01 00:00:01.500000"
        assert logs[name].read_bytes() == jlogs[name].read_bytes()
        got = read_wav(dirs.post_standardized / f"{name}.wav")[0]
        ref = read_wav(jdirs.post_standardized / f"{name}.wav")[0]
        diff = got.astype(np.float64) - ref
        if name.startswith("zoom"):
            assert not diff.any()
        else:
            assert np.sqrt(np.mean(diff ** 2)) <= \
                0.01 * np.sqrt(np.mean(ref.astype(np.float64) ** 2))
        assert (dirs.charts / f"{name}.html").read_text() == \
            (jdirs.charts / f"{name}.html").read_text()


def test_overlap_post_empty_recording_and_rerun(weights, tmp_path):
    """A recording shorter than one segment yields a header-only log; a
    rerun truncates the previous log instead of appending to it."""
    tree, _ = weights
    dirs = bootstrap(tmp_path / "e")
    _recordings(dirs.root, [("audio_short.wav", 1, 3),
                            ("zoom_long.wav", 3, 4)])
    pred = OverlapPredictor(overlap_state_dict_from_jax(tree, as_port(CFG)),
                            as_port(CFG), device="cpu")
    for _ in range(2):
        logs = overlap_post_analyze(dirs, pred, start_time=T0,
                                    make_charts=False)
    assert parse_log(logs["audio_short"]) == []
    assert logs["audio_short"].read_text() == \
        "segment\toverlapped degree\ttimestamp\n"
    assert [r[0] for r in parse_log(logs["zoom_long"])] == [0, 1]


@pytest.mark.parametrize("case", ["resample_gain", "denoise",
                                  "denoise_second_pass", "vad_energy",
                                  "vad_webrtc"])
def test_standardize_matches_jax(case):
    """Denoise within 1 LSB on <= 0.5 % of samples (the tolerance of
    tests/test_torch_denoise.py), pass by pass: the second pass of the port
    runs on JAX's first-pass output and is held against JAX's two passes."""
    sig48 = synth_speech_i16(48000 * 2, sr=48000, seed=7)
    sig = synth_speech_i16(16000 * 3, seed=8)
    sig[16000:24000] //= 200                          # a quiet stretch
    if case == "resample_gain":
        kw, y, sr = dict(dbfs=-20.0), sig48, 48000
    elif case == "denoise":
        kw, y, sr = dict(noise=NOISE, noise_passes=1), sig, 16000
    elif case == "denoise_second_pass":
        kw, y, sr = dict(noise=NOISE, noise_passes=1), sig, 16000
        # JAX's first pass as its second pass sees it: rounded to int16
        from mmla_audio_tpu.ops import denoise as jax_denoise

        thr = jax_denoise.noise_threshold(jnp.asarray(NOISE / 32768.0))
        first = np.asarray(jax_denoise.quantize_i16(jax_denoise.reduce_noise(
            jnp.asarray(y / 32768.0, jnp.float32), thr))).astype(np.int16)
        got = standardize.standardize_audio(first, sr, device="cpu", **kw)
        ref = jax_std.standardize_audio(y, sr, noise=NOISE, noise_passes=2)
        diff = np.abs(got.astype(np.int32) - ref)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
        return
    else:
        decision = case.split("_")[1]
        kw, y, sr = dict(silence_remove=True, noise=NOISE), sig, 16000
        kw_jax = dict(kw)
        from mmla_audio_tpu.core.config import VadConfig as JaxVad

        kw_jax["vad_cfg"] = JaxVad(decision=decision)
        kw["vad_cfg"] = VadConfig(decision=decision)
    got = standardize.standardize_audio(y, sr, device="cpu", **kw)
    ref = jax_std.standardize_audio(y, sr, **(kw_jax if case.startswith(
        "vad") else kw))
    assert got.dtype == ref.dtype == np.int16
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int32) - ref)
    if case == "denoise":
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    else:
        assert diff.max() == 0
    if case.startswith("vad"):
        assert 0 < len(got) < len(sig)


@pytest.mark.parametrize("n", [0, 23999, 24000, 60001])
def test_segment_signal_matches_jax(n):
    y = np.arange(n, dtype=np.int16)
    got = standardize.segment_signal(y, 16000, 1.5, 1.5)
    ref = jax_std.segment_signal(y, 16000, 1.5, 1.5)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.array_equal(got, ref)


def test_resample_and_gain_match_jax():
    y = np.random.RandomState(0).randn(4410).astype(np.float32)
    np.testing.assert_array_equal(standardize.resample(y, 44100, 16000),
                                  jax_std.resample(y, 44100, 16000))
    np.testing.assert_array_equal(standardize.apply_gain_dbfs(y * 1e3, -12.0),
                                  jax_std.apply_gain_dbfs(y * 1e3, -12.0))


def _write_logs(log_cls, root):
    """The same rows through both SessionLogs: a post-time batch, a live
    append, a rerun that truncates, and a resumed log."""
    a = log_cls(root / "a.txt", kind="overlap", start_index=0, overwrite=True)
    a.ensure_header()
    a.append_batch(["overlapped", "non-overlapped", "overlapped"], T0, 1.5)
    a = log_cls(root / "a.txt", kind="overlap", start_index=0, overwrite=True)
    a.append_batch(["non-overlapped", "silent"], T0, 1.5)
    b = log_cls(root / "b.txt", kind="speaker")
    b.append("alice", datetime(2026, 1, 1, 0, 0, 2, 560000))
    b = log_cls.resume(root / "b.txt", kind="speaker")
    b.append("bob", datetime(2026, 1, 1, 0, 0, 5, 120000))
    return [(root / f).read_bytes() for f in ("a.txt", "b.txt")]


def test_session_log_matches_jax(tmp_path):
    got = _write_logs(SessionLog, tmp_path / "port")
    ref = _write_logs(JaxLog, tmp_path / "jax")
    assert got == ref
    assert [r[0] for r in parse_log(tmp_path / "port" / "a.txt")] == [0, 1]
    assert [r[0] for r in parse_log(tmp_path / "port" / "b.txt")] == [1, 2]


def test_chart_html_matches_jax(tmp_path):
    log = SessionLog(tmp_path / "c.txt", start_index=0)
    labels = ["overlapped", "non-overlapped", "silent", "overlapped"] * 5
    log.append_batch(labels, T0, 1.5)
    rows = parse_log(tmp_path / "c.txt")
    for title in ("Overlap Degree", "x <&> y"):
        assert charts.render_chart_html(rows, title) == \
            jax_charts.render_chart_html(rows, title)
    assert charts.render_chart_html([], "empty") == \
        jax_charts.render_chart_html([], "empty")
    got = charts.visualize_all(tmp_path, tmp_path / "port")
    ref = jax_charts.visualize_all(tmp_path, tmp_path / "jax")
    assert [p.read_text() for p in got] == [p.read_text() for p in ref]


def test_cli_overlap_post_and_charts(tmp_path, capsys):
    root = tmp_path / "experiment"
    _recordings(root, [("audio_conv0.wav", 3, 5)])
    # the CLI builds the default full-width model: write its weights
    from mmla_audio_torch.core.config import OverlapModelConfig
    from mmla_audio_torch.params import overlap_tree_shapes

    rng = np.random.RandomState(0)

    def fill(node):
        return {k: fill(v) if isinstance(v, dict) else
                rng.uniform(0.5, 1.0, v).astype(np.float32)
                for k, v in node.items()}

    save_npz(fill(overlap_tree_shapes(OverlapModelConfig())),
             tmp_path / "full.npz")
    cli.main(["overlap-post", "--root", str(root), "--device", "cpu",
              "--weights", str(tmp_path / "full.npz")])
    out = capsys.readouterr().out
    assert "[INFO] weights:" in out and "audio_conv0" in out
    rows = parse_log(root / "logs" / "audio_conv0.txt")
    assert [r[0] for r in rows] == [0, 1]
    (root / "charts" / "audio_conv0.html").unlink()
    cli.main(["charts", "--root", str(root)])
    assert "Overlap Degree" in (root / "charts" / "audio_conv0.html"
                                ).read_text()
