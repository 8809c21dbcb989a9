"""The ``conformer`` kind (wav2vec 2.0 Conformer Large as the overlap
detector) and its readers.

On the CPU: the reference's parameters are the program's state dict at
the published widths; the benchmark's reference, the tests' reference and
the program agree at a tiny width; the counts against hand counts; the
cell ``w2v2_conformer_large.backlog`` rehearsed end to end at a tiny width
(the configuration's model cut in the test, the traffic as the other
rehearsals cut it) comes out correct, and not correct with the model in
bf16 (the control), the positional term ``(q + v) . p`` dropped, the
position table read one position off, or the BatchNorm's running
statistics ignored; the readers on hand-built contexts, and None where the
program keeps no span or counter of theirs.  On the card (``cuda``), at the
published widths: a short run of the cell is correct and the bf16 control
is not, and the run is not correct under each of the three faults."""

import argparse
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import check, counts, gen, harness
from perfbench.drivers import Run, Tracer
from perfbench.reference import conformer as ref
from perfbench.tests.test_perfbench_wavlm import _ev, _trace_ctx

CELL = "w2v2_conformer_large.backlog"
# a tiny width of the same architecture (the conv kernels and strides and
# the depthwise kernel 31 kept), small enough for a rehearsal on the CPU
TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 128, "conv_dim": [32] * 7,
        "classifier_proj_size": 16}
SMALL = {"streams": 8, "buckets": [8], "warmup_ticks": 1,
         "check_streams": 8, "check_windows": 3, "pool_conversations": 4}


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _tiny_config():
    _, config, _ = harness.cell(harness.manifest(), CELL)
    config["model"] = dict(config["model"], **TINY)
    return config


def test_param_spec_is_the_programs_state_dict():
    from mmla_audio_torch.core.config import ConformerConfig
    from mmla_audio_torch.models.conformer import (
        Wav2Vec2ConformerForSequenceClassification)

    from perfbench.system import fields

    _, config, _ = harness.cell(harness.manifest(), CELL)
    with torch.device("meta"):
        model = Wav2Vec2ConformerForSequenceClassification(
            fields(ConformerConfig, config["model"]))
    spec = ref.param_spec(config["model"])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: shape for k, (shape, _) in spec.items()}
    # ~610 M parameters (2.44 GB in float32)
    n = sum(torch.Size(shape).numel() for shape, _ in spec.values())
    assert 6.0e8 < n < 6.2e8


def test_weights_draw_positive_variances_and_nonzero_position_biases():
    m = _tiny_config()["model"]
    sd = gen.weights(ref.param_spec(m), 2 ** 33 + 3, "cpu")
    var = sd["encoder.layers.1.conv_module.batch_norm.running_var"]
    assert (var >= 0.5).all() and (var < 2.0).all()
    for name in ("pos_bias_u", "pos_bias_v"):
        b = sd[f"encoder.layers.0.self_attn.{name}"]
        assert b.shape == (4, 16) and (b != 0).all()
        # Xavier's variance over (heads, head size), 2 / (4 + 16)
        assert 0.05 < float(b.var()) < 0.2


def test_references_and_program_agree_at_a_tiny_width():
    from mmla_audio_torch.core.config import ConformerConfig
    from mmla_audio_torch.inference import ConformerPredictor

    from perfbench.system import fields
    from tests import conformer_reference as tests_ref

    m = _tiny_config()["model"]
    cfg = fields(ConformerConfig, m)
    sd = gen.weights(ref.param_spec(m), 2 ** 33 + 5, "cpu")
    pred = ConformerPredictor(sd, cfg, device="cpu")
    pool = gen.conversations(7, 2, 6.0)
    trimmed = pool.audio[:, :40960].astype("int16")
    kept = [40960, 9000]
    trimmed[1, 9000:] = 0
    x = ref.inputs(trimmed, kept, m["input_eps"], "cpu")
    with torch.no_grad():
        got = pred.apply_model(x)
    want = ref.forward(sd, x[:, :-1], kept, m)
    other = tests_ref.forward(sd, x[:, :-1], kept, cfg)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert (other - want).abs().max() <= 1e-5 * want.abs().max()


def test_counts_against_hand_counts():
    from perfbench.counts import conformer

    _, config, _ = harness.cell(harness.manifest(), CELL)
    m, f = config["model"], config["feature"]
    # conv encoder 12.55, projection 0.13, 24 layers at 6.233 GFLOP (FFNs
    # 4.261, q/k/v/out 1.065, conv module 0.807, attention 0.099), head
    assert counts.model_flops("conformer", m, f) == pytest.approx(162.35e9,
                                                                  rel=1e-3)
    assert conformer.a2_shape(m, f) == (127, 16, 64, 24)
    flop, nbytes = conformer.a2_work(64, 127, 16, 64)
    assert flop == 6 * 64 * 16 * 127 * 127 * 64
    assert nbytes == 4 * (4 * 64 * 16 * 127 * 64 + 16 * 253 * 64
                          + 2 * 16 * 64 + 64)


def _rehearse(seed=2 ** 33 + 17, control=False):
    work, _, traffic = harness.cell(harness.manifest(), CELL)
    traffic.update(SMALL)
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=3.0,
                              trace=0)
    out, _ = harness.run_cell(work, _tiny_config(), traffic, args,
                              time.perf_counter(), torch.device("cpu"),
                              control=control)
    return out


def test_rehearsal_is_correct_and_the_bf16_control_is_not():
    out = _rehearse(control=True)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "cpu" and out["metrics"] == {}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out["checks"]) == ["missing", "denoise_mismatch",
                                   "trim_mismatch", "feature_mismatch",
                                   "rounding_ratio", "label_mismatch",
                                   "compared"]
    limits = {n: c["limit"] for n, c in out["checks"].items()}
    ctl = [(n, out["control"][n], limits[n]) for n in limits]
    assert not check.passed(ctl), ctl


def _positional_dropped(mp):
    """The positional term (q + v) . p of every layer's scores left out."""
    from mmla_audio_torch.models import conformer

    real = conformer.conformer_attention
    mp.setattr(conformer, "conformer_attention",
               lambda q, k, v, u, w, p, lens: real(q, k, v, u, w,
                                                   torch.zeros_like(p), lens))


def _table_shifted(mp):
    """Every layer's position table read one position off."""
    from mmla_audio_torch.models import conformer

    real = conformer.conformer_attention
    mp.setattr(conformer, "conformer_attention",
               lambda q, k, v, u, w, p, lens: real(
                   q, k, v, u, w, torch.cat([p[:, 1:], p[:, -1:]], 1)
                   .contiguous(), lens))


class _NoRunningStats:
    """``torch.nn.functional`` with BatchNorm's running statistics replaced
    by zero means and unit variances."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def batch_norm(x, mean, var, *a, **kw):
        return torch.nn.functional.batch_norm(
            x, torch.zeros_like(mean), torch.ones_like(var), *a, **kw)


def _running_stats_ignored(mp):
    """The conv modules' BatchNorm without its running statistics."""
    from mmla_audio_torch.models import conformer

    mp.setattr(conformer, "F", _NoRunningStats())


FAULTS = [_positional_dropped, _table_shifted, _running_stats_ignored]
FAULT_IDS = ["positional_dropped", "table_shifted", "running_stats_ignored"]


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_rehearsal_without_a_part_of_the_mechanism_is_not_correct(
        monkeypatch, fault):
    """Each fault moves the tiny model's logits past the limit of the TF32
    yardstick's rounding: ``rounding_ratio`` is what fails."""
    fault(monkeypatch)
    out = _rehearse()
    assert not out["correct"], out["checks"]
    ratio = out["checks"]["rounding_ratio"]
    assert ratio["value"] > ratio["limit"], out["checks"]


def test_readers_find_nothing_without_the_programs_spans_or_kernels():
    ctx = harness.Context(Run(seconds=1.0), None, {})
    ctx.system = SimpleNamespace(pred=object(), kind="conformer",
                                 model={}, feature={}, config={})
    for name in ("a2_roofline", "conv_module_dev_ms.conformer",
                 "mfu.w2v2_conformer_large.backlog", "a1_roofline"):
        assert harness.reader(name)(ctx) is None, name
    # the WavLM kind has no A2
    ctx.system.kind = "wavlm"
    assert harness.reader("a2_roofline")(ctx) is None


def test_conv_module_reader_counts_the_kernels_launched_in_its_spans():
    events = [_ev(Tracer.OPEN, 0, 1), _ev(Tracer.CLOSE, 1000, 1001),
              _ev("model.layer", 10, 90),
              _ev("model.conv_module", 20, 40),
              _ev("aten::mm", 22, 24, [("gemm_kernel", 30)]),
              _ev("aten::conv2d", 25, 26, [("depthwise_kernel", 12)]),
              _ev("mmla_audio::conformer_attention", 15, 16,
                  [("conformer_attention_kernel", 50)]),
              _ev("model.conv_module", 60, 70),
              _ev("aten::silu", 61, 62, [("silu_kernel", 8)])]
    ctx = _trace_ctx(events, windows=2)
    assert harness.reader("conv_module_dev_ms.conformer")(ctx) == \
        pytest.approx((30 + 12 + 8) / 2 / 1e3)


def test_a2_roofline_reads_a2s_kernels_at_the_traced_batches():
    ctx = harness.Context(Run(seconds=1.0), None, {})
    ctx.device_events = [(0, 200, "void conformer_attention_kernel<false>"),
                         (300, 400, "gemm_kernel")]
    ctx.traced_batches = [64, 8]
    _, config, _ = harness.cell(harness.manifest(), CELL)
    ctx.system = SimpleNamespace(kind="conformer", model=config["model"],
                                 feature=config["feature"], config=config)
    least = 0.0
    for b in (64, 8):
        flop, nbytes = counts.of("conformer").a2_work(b, 127, 16, 64)
        least += 24 * max(nbytes / counts.HBM_BYTES_S,
                          flop / counts.TF32_FLOP_S)
    assert harness.reader("a2_roofline")(ctx) == pytest.approx(
        least / 200e-6 * 100)


def _card_run(card, seed, control=False):
    from mmla_audio_torch import _build
    from mmla_audio_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(harness.CACHE)
    _build.cuda_libraries()
    work, config, traffic = harness.cell(harness.manifest(), CELL)
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=3.0,
                              trace=0)
    out, _ = harness.run_cell(work, config, traffic, args,
                              time.perf_counter(), card, control=control)
    print(f"{CELL} seed {seed}: correct {out['correct']}, checks "
          f"{ {n: c['value'] for n, c in out['checks'].items()} }"
          + (f", control {out['control']}" if control else ""))
    return out


@pytest.mark.cuda
def test_card_run_is_correct_and_the_bf16_control_is_not(card):
    out = _card_run(card, 2 ** 31 + 7, control=True)
    assert out["correct"], out["checks"]
    limits = {n: c["limit"] for n, c in out["checks"].items()}
    ctl = [(n, out["control"][n], limits[n]) for n in limits]
    assert not check.passed(ctl), ctl


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_card_run_without_a_part_of_the_mechanism_is_not_correct(
        card, monkeypatch, fault):
    fault(monkeypatch)
    out = _card_run(card, 2 ** 31 + 11)
    assert not out["correct"], out["checks"]
