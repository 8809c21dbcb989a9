"""The harness's arithmetic, generators, counts and import rules."""

import ast
import math
import sys
from pathlib import Path

import numpy as np
import torch

from perfbench import counts, gen, harness
from perfbench.drivers import Run
from perfbench.reference import overlap
from perfbench.tests.test_perfbench_reference import (OVERLAP_FEATURE,
                                                      OVERLAP_MODEL,
                                                      SPEAKER_FEATURE,
                                                      SPEAKER_MODEL)

ROOT = Path(harness.ROOT)


class _Ctx:
    def __init__(self, run):
        self.run = run


def test_p95_counts_every_window_and_unlabelled_ones_as_missing():
    p95 = harness.reader("decision_p95_ms")
    run = Run(seconds=10.0, latencies=[0.01] * 90 + [0.02] * 5
              + [math.inf] * 5)
    # nearest rank 95 of 100 is the 95th value: the last labelled 0.02
    assert p95(_Ctx(run)) == 20.0
    run.latencies = [0.01] * 90 + [math.inf] * 10
    # a missing window at the 95th rank reads as the longest wait given
    assert p95(_Ctx(run)) == 10.0
    assert harness.percentile([3, 1, 2], 50) == 2


def test_rate_is_the_work_over_the_whole_window():
    run = Run(seconds=12.5, labelled=5000)
    assert harness.reader("windows_per_s")(_Ctx(run)) == 400.0
    run.notes["setup_s"] = 9.5
    assert harness.reader("setup_s")(_Ctx(run)) == 9.5


def test_every_metric_of_the_manifest_has_its_reader():
    bench = harness.manifest()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]


def test_generators_follow_the_seed():
    a = gen.conversations(2 ** 40 + 7, 3, 2.0)
    b = gen.conversations(2 ** 40 + 7, 3, 2.0)
    c = gen.conversations(2 ** 40 + 8, 3, 2.0)
    np.testing.assert_array_equal(a.audio, b.audio)
    assert not np.array_equal(a.audio, c.audio)
    for x, y in zip(a.noise, b.noise):
        np.testing.assert_array_equal(x, y)
    spec = overlap.param_spec(OVERLAP_MODEL)
    w1, w2 = gen.weights(spec, 5, "cpu"), gen.weights(spec, 5, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in spec)
    assert not torch.equal(w1["stem.weight"],
                           gen.weights(spec, 6, "cpu")["stem.weight"])
    assert float(w1["blocks.0.bn0.running_var"].min()) >= 0.5


def test_counts_against_hand_counts():
    # the overlap model: three stages of (pooling block + two fused blocks)
    H, W, f = [128, 64, 32], [151, 76, 38], [32, 64, 128]
    c_in = [16, 32, 64]
    flop = 2 * 3 * 16 * 128 * 151
    for s in range(3):
        Ho, Wo = (H[s] + 1) // 2, (W[s] + 1) // 2
        flop += 2 * c_in[s] * f[s] * Ho * Wo
        flop += 2 * 9 * c_in[s] * f[s] * H[s] * W[s]
        flop += 2 * 4 * f[s] * f[s] * H[s] * W[s]
        flop += 2 * 26 * f[s] * f[s] * Ho * Wo
    flop += 2 * 19 * 2 * (128 * 1024 + 256 * 1024) + 2 * 512 * 2
    assert counts.model_flops("overlap", OVERLAP_MODEL,
                              OVERLAP_FEATURE) == flop
    assert 1.7e9 < flop < 1.9e9
    # B3: 129.5 MFLOP a sample at (32, 64, 76), as the kernel table has it
    assert counts.of("overlap").b3_shapes(OVERLAP_MODEL, OVERLAP_FEATURE) == \
        [(32, 64, 76)] * 2 + [(64, 32, 38)] * 2 + [(128, 16, 19)] * 2
    assert counts.block_work(1, 32, 64, 76)[0] == 129_499_136
    sp = counts.model_flops("speaker", SPEAKER_MODEL, SPEAKER_FEATURE)
    hand = 2 * 39 * 32 * 4 * 256
    for C, c0, L in ((32, 32, 128), (64, 32, 64), (128, 64, 32)):
        hand += 2 * c0 * C * L + 2 * 3 * c0 * C * L + 2 * 3 * C * C * L
        hand += 2 * 2 * (2 * 3 * C * C * L)
    hand += 2 * 8 * 2 * (128 * 1024 + 256 * 1024) + 2 * 512 * 4
    assert sp == hand
    # D1 at one 40,960-sample window padded 2,864 a side: 183 frames
    assert counts.denoise_pad() == 2864
    flop, nbytes = counts.d1_work(1, 40960 + 2 * 2864)
    assert nbytes == 4 * 46688 + 2 * (4 * 183 * 2 * 513) + 4 * 183 * 1024
    assert counts.FP32_FLOP_S == 165e12


def test_denoise_pad_is_the_programs():
    from mmla_audio_torch.core.config import DenoiseConfig
    from mmla_audio_torch.ops.denoise import _chunk_pad

    assert counts.denoise_pad() == _chunk_pad(DenoiseConfig(), 16000)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package_or_benchmarks():
    sources = [p for p in ROOT.rglob("*.py") if "tests" not in p.parts]
    assert sources
    for p in sources:
        bad = _imports(p) & set(harness.FORBIDDEN)
        assert not bad, (p, bad)
        assert "benchmarks/" not in p.read_text(), p
    # the reference imports nothing of the program either
    for p in (ROOT / "reference").glob("*.py"):
        assert "mmla_audio_torch" not in _imports(p), p


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping_like", "mmla_audio_tpu_torch", "benchmarksx"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "mmla_audio_tpu.ops", object())
    assert harness.forbidden_modules() == ["jax", "mmla_audio_tpu"]
