"""The ``wavlm`` kind (WavLM Large as the overlap detector) and its readers.

On the CPU: the reference's parameters are the program's state dict at
the published widths; the reference and the program agree at a tiny
width; the counts against hand counts; the cell ``wavlm_large.backlog``
rehearsed end to end at a tiny width (the configuration's model cut in
the test, the traffic as the other rehearsals cut it) comes out correct,
and not correct with an answer altered, every layer's gate dropped or the
bucket table shifted by one; the readers on hand-built contexts, and None
where the program keeps no span or counter of theirs.  On the card
(``cuda``), at the published widths: a short run of the cell is correct
and the bf16 control is not, and the run is not correct with the gate
dropped or the bucket table shifted."""

import argparse
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import counts, gen, harness
from perfbench.drivers import Run, Tracer
from perfbench.launched import device_us_inside
from perfbench.reference import wavlm as ref

CELL = "wavlm_large.backlog"
# a tiny width of the same architecture (buckets, distance, the conv
# kernels and strides kept), small enough for a rehearsal on the CPU
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
    from mmla_audio_torch.core.config import WavLMConfig
    from mmla_audio_torch.models.wavlm import WavLMForSequenceClassification

    from perfbench.system import fields

    _, config, _ = harness.cell(harness.manifest(), CELL)
    with torch.device("meta"):
        model = WavLMForSequenceClassification(
            fields(WavLMConfig, config["model"]))
    spec = ref.param_spec(config["model"])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: shape for k, (shape, _) in spec.items()}
    # 316 M parameters
    n = sum(torch.Size(shape).numel() for shape, _ in spec.values())
    assert 3.1e8 < n < 3.2e8


def test_reference_matches_the_program_at_a_tiny_width():
    from mmla_audio_torch.core.config import WavLMConfig
    from mmla_audio_torch.inference import WavLMPredictor

    from perfbench.system import fields

    m = _tiny_config()["model"]
    sd = gen.weights(ref.param_spec(m), 2 ** 33 + 5, "cpu")
    pred = WavLMPredictor(sd, fields(WavLMConfig, m), device="cpu")
    pool = gen.conversations(7, 2, 6.0)
    trimmed = pool.audio[:, :40960].astype("int16")
    kept = [40960, 9000]
    trimmed[1, 9000:] = 0
    x = ref.inputs(trimmed, kept, m["input_eps"], "cpu")
    with torch.no_grad():
        got = pred.apply_model(x)
    want = ref.forward(sd, x[:, :-1], kept, m)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_counts_against_hand_counts():
    from perfbench.counts import wavlm

    _, config, _ = harness.cell(harness.manifest(), CELL)
    m, f = config["model"], config["feature"]
    assert wavlm.frames(m, 40960) == 127
    # conv encoder 12.55, positional conv 2.13, 24 layers at 3.26 GFLOP
    assert counts.model_flops("wavlm", m, f) == pytest.approx(93.23e9,
                                                              rel=1e-3)
    assert wavlm.a1_shape(m, f) == (127, 16, 64, 24)
    flop, nbytes = wavlm.attn_work(64, 127, 16, 64)
    assert flop == 4 * 64 * 16 * 127 * 127 * 64
    assert nbytes == 4 * (4 * 64 * 16 * 127 * 64 + 64 * 16 * 127
                          + 16 * 253 + 64)


def _rehearse(seed=2 ** 33 + 17):
    work, _, traffic = harness.cell(harness.manifest(), CELL)
    traffic.update(SMALL)
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=3.0,
                              trace=0)
    out, _ = harness.run_cell(work, _tiny_config(), traffic, args,
                              time.perf_counter(), torch.device("cpu"))
    return out


def test_rehearsal_is_correct_and_reports_no_device_number():
    out = _rehearse()
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "cpu" and out["metrics"] == {}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out["checks"]) == ["missing", "denoise_mismatch",
                                   "trim_mismatch", "feature_mismatch",
                                   "rounding_ratio", "label_mismatch",
                                   "compared"]


def _gate_dropped(mp):
    """Every layer's gate of the position bias held at 1."""
    from mmla_audio_torch.models import wavlm

    real = wavlm.wavlm_attention
    mp.setattr(wavlm, "wavlm_attention", lambda q, k, v, gate, *a: real(
        q, k, v, torch.ones_like(gate), *a))


def _buckets_shifted(mp):
    """Layer 0's bucket table read one bucket on."""
    from mmla_audio_torch.models import wavlm

    real = wavlm.relative_position_bucket
    mp.setattr(wavlm, "relative_position_bucket", lambda rel, nb, md: (
        real(rel, nb, md) + 1).clamp(max=nb - 1))


def _answer_altered(mp):
    """The first logit moved by a tenth of the batch's largest."""
    from mmla_audio_torch.inference import WavLMPredictor

    real = WavLMPredictor.apply_model

    def apply_model(self, x, model=None):
        logits = real(self, x, model)
        bump = torch.zeros_like(logits[:1])
        bump[0, 0] = 0.1
        return logits + bump * logits.abs().amax()
    mp.setattr(WavLMPredictor, "apply_model", apply_model)


def test_an_altered_answer_is_not_correct(monkeypatch):
    _answer_altered(monkeypatch)
    out = _rehearse()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_gate_dropped, _buckets_shifted],
                         ids=["gate_dropped", "buckets_shifted"])
def test_rehearsal_without_the_gate_or_with_shifted_buckets_is_not_correct(
        monkeypatch, fault):
    """With the bucket table at its N(0, 1) the faults move the tiny
    model's logits 20-36 times the TF32 yardstick's rounding."""
    fault(monkeypatch)
    out = _rehearse()
    assert not out["correct"], out["checks"]
    assert out["checks"]["rounding_ratio"]["value"] > 5, out["checks"]


def _ev(name, start, end, kernels=()):
    """A host event with the kernels it launched, (name, microseconds)."""
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CPU, is_user_annotation=False,
        kernels=[SimpleNamespace(name=n, device=0, duration=d)
                 for n, d in kernels])


def _trace_ctx(events, windows=2):
    ctx = harness.Context(Run(seconds=1.0), None, {})
    ctx.run = Run(seconds=1.0)
    ctx.run.trace = {"events": events}
    ctx.traced_windows = windows
    return ctx


def test_device_time_of_kernels_launched_inside_a_span():
    """An operator's kernels count for the span it started in, whenever
    they ran; operators outside the traced stretch and copies left out."""
    events = [_ev(Tracer.OPEN, 0, 1), _ev(Tracer.CLOSE, 1000, 1001),
              _ev("model.layers", 10, 50), _ev("model.layer", 12, 30),
              _ev("aten::mm", 14, 16, [("gemm_kernel", 60)]),
              _ev("aten::copy_", 20, 21, [("Memcpy DtoD", 10)]),
              _ev("aten::add", 60, 61, [("add_kernel", 10)]),
              _ev("model.layers", 1002, 1050),
              _ev("aten::mm", 1004, 1006, [("gemm_kernel", 60)])]
    ctx = _trace_ctx(events)
    assert device_us_inside(ctx, "model.layers") == 60
    assert device_us_inside(ctx, "model.encoder") is None
    assert harness.reader("layers_dev_ms.wavlm")(ctx) == \
        pytest.approx(60 / 2 / 1e3)


def test_readers_find_nothing_without_the_programs_spans_or_counters():
    ctx = harness.Context(Run(seconds=1.0), None, {})
    ctx.system = SimpleNamespace(pred=object(), kind="wavlm",
                                 model={}, feature={}, config={})
    for name in ("encoder_dev_ms.wavlm", "layers_dev_ms.wavlm",
                 "pad_share.wavlm", "a1_roofline",
                 "mfu.wavlm_large.backlog"):
        assert harness.reader(name)(ctx) is None, name
    # a span, but no operator with kernels linked to it
    ctx = _trace_ctx([_ev(Tracer.OPEN, 0, 1), _ev(Tracer.CLOSE, 99, 100),
                      _ev("model.encoder", 10, 50), _ev("aten::mm", 20, 30)])
    assert harness.reader("encoder_dev_ms.wavlm")(ctx) is None


def test_pad_share_reads_the_frame_counter():
    ctx = harness.Context(Run(seconds=1.0), None, {})
    ctx.system = SimpleNamespace(pred=SimpleNamespace(frame_stats=lambda: {
        "batches": 2, "computed": 2 * 64 * 127, "valid": 12_000}))
    assert harness.reader("pad_share.wavlm")(ctx) == pytest.approx(
        (16_256 - 12_000) / 16_256 * 100)


@pytest.mark.cuda
def test_card_run_is_correct_and_the_bf16_control_is_not(card):
    from mmla_audio_torch import _build
    from mmla_audio_torch.utils.compile_cache import enable_compile_cache

    from perfbench import check

    enable_compile_cache(harness.CACHE)
    _build.cuda_libraries()
    work, config, traffic = harness.cell(harness.manifest(), CELL)
    args = argparse.Namespace(workload=CELL, seed=2 ** 31 + 7, seconds=3.0,
                              trace=0)
    out, _ = harness.run_cell(work, config, traffic, args,
                              time.perf_counter(), card, control=True)
    assert out["correct"], out["checks"]
    limits = {n: c["limit"] for n, c in out["checks"].items()}
    ctl = [(n, out["control"][n], limits[n]) for n in limits]
    assert not check.passed(ctl), ctl


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [_gate_dropped, _buckets_shifted],
                         ids=["gate_dropped", "buckets_shifted"])
def test_card_run_without_the_gate_or_with_shifted_buckets_is_not_correct(
        card, monkeypatch, fault):
    from mmla_audio_torch import _build
    from mmla_audio_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(harness.CACHE)
    _build.cuda_libraries()
    fault(monkeypatch)
    work, config, traffic = harness.cell(harness.manifest(), CELL)
    args = argparse.Namespace(workload=CELL, seed=2 ** 31 + 11, seconds=3.0,
                              trace=0)
    out, _ = harness.run_cell(work, config, traffic, args,
                              time.perf_counter(), card)
    assert not out["correct"], out["checks"]
