"""Kernel E1's reader (``e1_roofline``) and its count
(``counts/wavlm_conv.py``), on the CPU: the count against a hand count at
WavLM Large's published widths, the reader on hand-built traces, and None
where no E1 kernel ran (as at a program without E1)."""

from types import SimpleNamespace

import pytest

from perfbench import counts, harness
from perfbench.counts.wavlm_conv import conv_encoder_work
from perfbench.drivers import Run

CELL = "wavlm_large.backlog"


def _model():
    _, config, _ = harness.cell(harness.manifest(), CELL)
    return config


def test_conv_encoder_work_against_a_hand_count():
    config = _model()
    m, f = config["model"], config["feature"]
    # 40,960 samples -> 8,191, 4,095, 2,047, 1,023, 511, 255, 127 frames
    per_window = 2 * (512 * 10 * 8191 + 512 * 512 * 3 * (4095 + 2047 + 1023
                                                         + 511)
                      + 512 * 512 * 2 * (255 + 127))
    params = 512 * 10 + 6 * 512 * 512 * 3 - 2 * 512 * 512 + 7 * 2 * 512
    for batch in (1, 64):
        flop, nbytes = conv_encoder_work(m, f, batch)
        assert flop == batch * per_window
        assert nbytes == 4 * (batch * 40960 + params + batch * 127 * 512)
    assert per_window == pytest.approx(12.56e9, rel=1e-3)
    # the products bind at B = 64: 1.62 ms at TF32's peak, 0.014 of bytes
    flop, nbytes = conv_encoder_work(m, f, 64)
    assert flop / counts.TF32_FLOP_S > 100 * nbytes / counts.HBM_BYTES_S
    # a bias a layer adds its vector to the bytes
    flop_b, nbytes_b = conv_encoder_work(dict(m, conv_bias=True), f, 64)
    assert (flop_b, nbytes_b) == (flop, nbytes + 4 * 7 * 512)


def _ctx(kernels, batches, config=None):
    """A traced context: device kernels (name, microseconds) back to back,
    the traced batches, the cell's system."""
    config = config or _model()
    ctx = harness.Context(Run(seconds=1.0), None, {})
    t = 0
    for name, us in kernels:
        ctx.device_events.append((t, t + us, name))
        t += us
    ctx.traced_batches = list(batches)
    ctx.system = SimpleNamespace(kind="wavlm", model=config["model"],
                                 feature=config["feature"], config=config)
    return ctx


GEMM = "void (anonymous namespace)::wavlm_conv_gemm_kernel<false>(...)"
SAMPLES = "void (anonymous namespace)::wavlm_conv_samples_kernel<4>(...)"


def test_e1_roofline_reads_the_e1_kernels_against_the_count():
    config = _model()
    read = harness.reader("e1_roofline")
    ctx = _ctx([(SAMPLES, 500), (GEMM, 5500), ("wavlm_attention_kernel", 90),
                ("sm90_xmma_gemm", 700)], [64], config)
    flop, _ = conv_encoder_work(config["model"], config["feature"], 64)
    least = flop / counts.TF32_FLOP_S
    assert read(ctx) == pytest.approx(least / 6000e-6 * 100)
    # two batches of 64 and 8 in the same E1 time
    ctx = _ctx([(GEMM, 6000)], [64, 8], config)
    flop8, _ = conv_encoder_work(config["model"], config["feature"], 8)
    assert read(ctx) == pytest.approx(
        (flop + flop8) / counts.TF32_FLOP_S / 6000e-6 * 100)
    # TF32 not allowed: the products at 3xTF32's peak
    fp32 = dict(config, matmul_precision="fp32")
    ctx = _ctx([(GEMM, 6000)], [64], fp32)
    assert read(ctx) == pytest.approx(
        flop / counts.FP32_FLOP_S / 6000e-6 * 100)


def test_e1_roofline_is_none_without_e1_kernels():
    """A program without E1 (the conv encoder on cuDNN and aten) has
    nothing to read, nor a run that traced no batch."""
    read = harness.reader("e1_roofline")
    assert read(_ctx([("cutlass_tensorop_s1688fprop_analytic", 900),
                      ("vectorized_layer_norm_kernel", 300)], [64])) is None
    assert read(_ctx([(GEMM, 6000)], [])) is None
    ctx = harness.Context(Run(seconds=1.0), None, {})
    ctx.system = SimpleNamespace(kind="wavlm", model={}, feature={},
                                 config={})
    assert read(ctx) is None
