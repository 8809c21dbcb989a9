"""Tests that need the card: the CUDA kernels (featurizer, one window and
grouped, on speech, silence and a clipped sine; fused residual block; the
batched webrtcvad engine W1 and the collector W2; the denoise's D1 and D2;
the GMM VAD's adaptation scan G1)
against their plain versions, the block's dispatch rule, the predictor on
the card against the CPU, the multiplexer's launches, the denoise of a
window equal in a batch and alone, and the predictor captured as a CUDA
graph by ``export.aot_compile``.

This file imports neither JAX nor tests/conftest.py, so it runs where JAX is
not installed:  python -m pytest --noconftest tests/test_torch_cuda.py
Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from mmla_audio_torch.core.config import (OverlapFeatureConfig,
                                          OverlapModelConfig)
from mmla_audio_torch.inference import OverlapPredictor
from mmla_audio_torch.models.overlap import (OverlapResBLSTM, ResBlock2D,
                                             keras_init_)
from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
from mmla_audio_torch.ops.cuda_resblock import (block_route,
                                                fused_resblock_cuda,
                                                fused_resblock_plain)
from mmla_audio_torch.ops.features import overlap_model_input
from mmla_audio_torch.precision import fp32_policy

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _audio(batch, n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    y = np.sin(2 * np.pi * rng.uniform(80, 2000, (batch, 1)) * t) \
        + 0.3 * rng.randn(batch, n)
    return (0.3 * y / np.abs(y).max(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("batch,n", [(1, 24000), (64, 24000), (200, 24000),
                                     (480, 24000), (3, 10000), (2, 40960)])
def test_kernel_matches_plain(device, batch, n):
    y = torch.from_numpy(_audio(batch, n)).to(device)
    before = overlap_model_input_cuda.launches
    got = overlap_model_input_cuda(y)
    torch.cuda.synchronize()
    assert overlap_model_input_cuda.launches == before + 1
    diff = (got - overlap_model_input(y)).abs()
    # one quantization step on < 2 % of pixels (float-boundary pixels)
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) < 0.02


def test_kernel_rejects_wrong_dtype(device):
    with pytest.raises(TypeError):
        overlap_model_input_cuda(torch.zeros(24000, dtype=torch.float64,
                                             device=device))


def test_predictor_card_matches_cpu(device):
    cfg = OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             input_scale=1 / 255)
    sd = keras_init_(OverlapResBLSTM(cfg),
                     torch.Generator().manual_seed(0)).state_dict()
    buf = (_audio(4, 40960, seed=1) * 20000).astype(np.int16)
    n = np.array([40960, 30000, 20000, 3000], np.int32)
    preds = [OverlapPredictor(sd, cfg, device=d, matmul_precision="highest")
             for d in (device, "cpu")]
    (lc, pc), (l0, p0) = (p.predict(buf, n) for p in preds)
    np.testing.assert_allclose(pc.cpu().numpy(), p0.numpy(), atol=1e-4)
    np.testing.assert_array_equal(lc.cpu().numpy(), l0.numpy())


@pytest.mark.parametrize("batch,time_dim,group", [
    (6, 150, 4),        # partial last group
    (4, 151, 2),        # 152 frames: none duplicated
    (480, 150, 2),      # the post-time batch, every G
    (480, 150, 4),
])
def test_grouped_kernel_matches_one_window(device, batch, time_dim, group):
    cfg = OverlapFeatureConfig(time_dim=time_dim)
    y = torch.from_numpy(_audio(batch, cfg.n_samples, seed=batch)).to(device)
    before = overlap_model_input_cuda.launches_grouped
    got = overlap_model_input_cuda(y, cfg, group=group)
    torch.cuda.synchronize()
    assert overlap_model_input_cuda.launches_grouped == before + 1
    assert torch.equal(got, overlap_model_input_cuda(y, cfg, group=1))
    diff = (got - overlap_model_input(y, cfg)).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) < 0.02


@pytest.mark.parametrize("sample_rate", [4000, 8000, 12800, 24000])
def test_kernel_other_window_lengths(device, sample_rate):
    """The butterflies of radix 2, 4 and 3: FFT plans (5, 5, 2), (5, 5, 4),
    (5, 4, 8) and (3, 5, 5, 4) of 25 ms windows at these rates."""
    cfg = OverlapFeatureConfig(sample_rate=sample_rate)
    y = torch.from_numpy(_audio(3, cfg.n_samples, seed=2)).to(device)
    got = overlap_model_input_cuda(y, cfg)
    assert torch.equal(got, overlap_model_input_cuda(y, cfg, group=2))
    diff = (got - overlap_model_input(y, cfg)).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) < 0.02


@pytest.mark.parametrize("kw", [dict(sample_rate=14000),   # (5, 5, 7)
                                dict(win_ms=25.5),         # (3, 17, 4)
                                dict(sample_rate=22000)])  # (5, 5, 11)
def test_kernel_generic_radix_windows(device, kw):
    """The generic butterfly stage: windows whose half has a prime factor
    of 7, 11 or 17, at the budget of the other sample rates."""
    cfg = OverlapFeatureConfig(**kw)
    y = torch.from_numpy(_audio(3, cfg.n_samples, seed=4)).to(device)
    before = overlap_model_input_cuda.launches
    got = overlap_model_input_cuda(y, cfg)
    torch.cuda.synchronize()
    assert overlap_model_input_cuda.launches == before + 1
    diff = (got - overlap_model_input(y, cfg)).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) < 0.02


def test_kernel_refuses_non_kernel_window(device):
    """A window whose half has a prime factor of 7 (350 = 2 * 5^2 * 7) now
    runs on the card; one above the limit (460 = 2^2 * 5 * 23) raises
    there; neither falls back to the plain version."""
    cfg = OverlapFeatureConfig(sample_rate=14000)
    y = torch.zeros(2, cfg.n_samples, device=device)
    before = overlap_model_input_cuda.launches
    assert overlap_model_input_cuda(y, cfg).shape == (2, 128, 151, 3)
    assert overlap_model_input_cuda.launches == before + 1
    cfg = OverlapFeatureConfig(sample_rate=18400)
    y = torch.zeros(2, cfg.n_samples, device=device)
    with pytest.raises(ValueError, match="above 17"):
        overlap_model_input_cuda(y, cfg)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_kernel_silence_and_clipped_sine(device, group):
    """An all-zero window (dB floor: every G/B pixel 255, no crossings) and
    a full-scale sine clipped at +-1 (the window's max is the dB ref)."""
    t = np.arange(24000) / 16000
    sine = np.clip(1.5 * np.sin(2 * np.pi * 440.0 * t), -1.0, 1.0)
    y = torch.from_numpy(np.stack([np.zeros_like(sine), sine]).astype(
        np.float32)).to(device)
    got = overlap_model_input_cuda(y, group=group)
    assert bool((got[0, ..., 1:] == 255).all())
    assert bool((got[0, ..., 0] == 0).all())
    assert torch.equal(got, overlap_model_input_cuda(y, group=1))
    diff = (got - overlap_model_input(y)).abs()
    assert float(diff.max()) <= 1.0
    assert float((diff > 0).float().mean()) < 0.02


def _block_operands(C, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=0.1):
        return torch.randn(*shape, generator=g) * scale

    k1 = r(3, 3, C, C, scale=(2 / (9 * C)) ** 0.5)
    k2 = r(4, 1, C, C, scale=(2 / (4 * C)) ** 0.5)
    return (k1, r(C), k2, r(C), 1 + r(C), r(C), 1 + r(C), r(C))


@pytest.mark.parametrize("C,H,W", [
    (32, 64, 76), (64, 32, 38), (128, 16, 19),        # the full-width model
    (8, 9, 11), (16, 20, 23), (24, 7, 6), (48, 12, 9),  # tensor cores, C < 32
    (40, 5, 33),                                      # and C % 32 != 0
    (4, 10, 7), (12, 8, 9), (6, 5, 13), (3, 7, 5),    # FFMA, Q = 4, 4, 2, 1
    (128, 64, 76), (256, 16, 19), (544, 6, 5),        # narrow column tiles
])
@pytest.mark.parametrize("batch", [1, 8])
def test_fused_block_matches_plain(device, C, H, W, batch):
    ops = [a.to(device) for a in _block_operands(C, seed=C)]
    x = torch.randn(batch, C, H, W, generator=torch.Generator().manual_seed(1)
                    ).to(device)
    before = fused_resblock_cuda.launches, fused_resblock_cuda.launches_mma
    with fp32_policy(False):
        got = fused_resblock_cuda(x, *ops)
        ref = fused_resblock_plain(x, *ops)
    torch.cuda.synchronize()
    assert fused_resblock_cuda.launches == before[0] + 1
    assert fused_resblock_cuda.launches_mma == before[1] + (
        block_route(C) == "mma")
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_resblock_dispatch_rule(device):
    block = ResBlock2D(32, 32).to(device)
    x = torch.randn(2, 32, 8, 6, device=device)
    before = fused_resblock_cuda.launches
    with torch.no_grad():
        block.train()(x)                               # batch statistics
        block.eval()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            block(x)
    block(x)                                           # autograd recording
    assert fused_resblock_cuda.launches == before
    with torch.no_grad(), fp32_policy(False):
        fused = block(x)
        unfused = block.forward_unfused(x)
    assert fused_resblock_cuda.launches == before + 1
    assert float((fused - unfused).abs().max()) <= \
        1e-4 * float(unfused.abs().max())


def test_training_launches_the_fused_block_only_in_evaluation(device):
    """The dispatch rule in training: ``Trainer.train_step`` (train mode,
    autograd) launches no fused block; ``Trainer.evaluate`` and
    ``OverlapTrainer.evaluation`` launch one per non-pooling block (6) per
    chunk of rows, on channels-last images (a gather's or a
    concatenation's layout) too."""
    from mmla_audio_torch.core.config import OverlapTrainConfig
    from mmla_audio_torch.train.losses import keras_categorical_crossentropy
    from mmla_audio_torch.train.optimizers import adadelta
    from mmla_audio_torch.train.overlap_trainer import OverlapTrainer
    from mmla_audio_torch.train.trainer import Trainer

    cfg = OverlapModelConfig(stage_filters=(8, 16, 16), lstm_units=8)
    model = keras_init_(OverlapResBLSTM(cfg), torch.Generator().manual_seed(0))
    tr = Trainer(model, adadelta(1e-2), keras_categorical_crossentropy,
                 device=device)
    g = torch.Generator().manual_seed(1)
    x = (torch.rand(10, 128, 151, 3, generator=g) * 255).to(device)
    y = torch.eye(2)[torch.arange(10) % 2].to(device)
    before = fused_resblock_cuda.launches_mma
    tr.train_step(x[:8], y[:8], torch.ones(8, device=device))
    torch.cuda.synchronize()
    assert fused_resblock_cuda.launches_mma == before
    loss, _ = tr.evaluate(x, y, batch_size=4)               # 4 + 4 + 2 rows
    assert fused_resblock_cuda.launches_mma == before + 6 * 3
    assert np.isfinite(loss)
    ot = OverlapTrainer(cfg, OverlapTrainConfig(eval_batch_size=4),
                        device=device)
    x_last = x.cpu().contiguous()                   # channels-last storage
    ev = ot.evaluation(tr.variables_of(), x_last, y.cpu().numpy())
    assert fused_resblock_cuda.launches_mma == before + 6 * 6
    assert ev["confusion"].sum() == 10


def _vad_windows(count, seed, n=85 * 480):
    """int16 windows: speech-like tones with silent stretches, noise, a
    full-scale square wave."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    out = (_audio(count, n, seed) * 30000).astype(np.int16)
    out[::4, n // 3: 2 * n // 3] = 0
    out[1::4] = (rng.randn(n) * 300).astype(np.int16)
    out[2::4] = np.where(np.sin(2 * np.pi * 180 * t) > 0, 32767, -32768)
    return out


def _hold_w1_against_host(device, windows, n_states, idx, **geometry):
    """W1 and the host engine from the same fresh rows, one window of
    ``windows`` after another: decisions and every state row bit for bit
    after each, one launch each.  Returns the host's last decisions and
    rows."""
    from mmla_audio_torch.vad.webrtc import (webrtc_init, webrtc_vad_rows,
                                             webrtc_vad_rows_plain)

    plain = webrtc_init(n_states, "cpu")
    card = plain.to(device)
    for x in windows:
        x = torch.from_numpy(x)
        ref = webrtc_vad_rows_plain(x, plain, idx, **geometry)
        before = webrtc_vad_rows.launches
        got = webrtc_vad_rows(x.to(device), card, idx, **geometry)
        torch.cuda.synchronize()
        assert webrtc_vad_rows.launches == before + 1
        assert torch.equal(got.cpu(), ref)
        assert torch.equal(card.cpu(), plain)
    return ref, plain


@pytest.mark.parametrize("frame_len,sample_rate", [
    (480, 16000), (320, 16000), (160, 16000), (240, 8000), (160, 8000),
    (80, 8000)])
@pytest.mark.parametrize("batch", [1, 8, 64, 512])
def test_webrtc_rows_kernel_matches_host_engine(device, batch, frame_len,
                                                sample_rate):
    """W1 against the host engine at every frame length and rate the
    engine takes: three windows in a row, rows out of order, two padding
    rows, one state row named by no batch row; decisions and every state
    row bit for bit after each window."""
    from mmla_audio_torch.vad.webrtc import webrtc_init

    rng = np.random.RandomState(batch)
    if batch == 1:
        n_states, idx = 2, np.array([1], np.int32)
    else:
        n_states = batch - 1
        idx = rng.permutation(np.concatenate(
            [np.arange(1, n_states), [n_states, n_states + 3]])).astype(
                np.int32)
    ref, plain = _hold_w1_against_host(
        device, [_vad_windows(batch, seed=10 * batch + w) for w in range(3)],
        n_states, idx, frame_len=frame_len, sample_rate=sample_rate)
    assert torch.equal(plain[0], webrtc_init(1, "cpu")[0])   # never named
    if batch > 1:
        assert ref.any() and not ref.all()


def test_webrtc_rows_kernel_silence_and_clipped_squares(device):
    """Rows of silence, of sparse one-step impulses and of full-scale
    clipped squares: the silent frames keep the total power at or under
    kMinEnergy, so the GMM is skipped (the frame counter, slot 262, does
    not move) while the squares saturate every band; bit for bit."""
    n, t = 85 * 480, np.arange(85 * 480) / 16000
    rng = np.random.RandomState(0)
    x = np.zeros((8, n), np.int16)
    x[2:4] = (rng.rand(2, n) < 0.002) * rng.choice([-2, -1, 1, 2], (2, n))
    for r, hz in zip(range(4, 8), (60, 180, 1000, 3900)):
        x[r] = np.where(np.sin(2 * np.pi * hz * t) >= 0, 32767, -32768)
    idx = np.arange(8, dtype=np.int32)
    ref, plain = _hold_w1_against_host(
        device, [x, np.roll(x, 1234, axis=1)], 8, idx)
    assert not ref[:2].any()
    assert int(plain[0, 262]) == int(plain[1, 262]) == 0
    assert (plain[4:, 262] > 0).all()


def test_webrtc_rows_kernel_refuses_shared_rows(device):
    from mmla_audio_torch.vad.webrtc import webrtc_init, webrtc_vad_rows

    x = torch.zeros((2, 4800), dtype=torch.int16, device=device)
    with pytest.raises(ValueError, match="same state row"):
        webrtc_vad_rows(x, webrtc_init(2, device), [1, 1])
    with pytest.raises(ValueError, match="on the host"):
        webrtc_vad_rows(x, webrtc_init(2, device),
                        torch.tensor([0, 1], device=device))


@pytest.mark.parametrize("frames", [1, 31, 32, 33, 85, 1000])
def test_collect_rows_kernel_matches_plain(device, frames):
    """W2 against collect_mask per row, bool and uint8 decisions, at n_valid
    negative, 0, 1, T, past T and random, B up to 4,096 (the largest batch
    at T = 85, a live window's frames), rings of 10 (the warp kernel) and
    40 frames (the thread-a-row kernel)."""
    from mmla_audio_torch.vad.collector import (vad_collect_rows,
                                                vad_collect_rows_plain)

    rng = np.random.RandomState(frames)
    for batch in (1, 7, 96, 4096 if frames == 85 else 512):
        dec = torch.from_numpy(rng.rand(batch, frames)
                               < rng.uniform(0.1, 0.97, (batch, 1)))
        dec[::5] = torch.arange(frames) % 2 == 0
        cases = np.stack([np.full(batch, -3), np.zeros(batch, int),
                          np.ones(batch, int), np.full(batch, frames),
                          np.full(batch, frames + 4),
                          rng.randint(0, frames + 1, batch)])
        n_valid = torch.from_numpy(
            cases[np.arange(batch) % 6, np.arange(batch)].astype(np.int32))
        for ring in (10, 40):
            ref_keep, ref_kept = vad_collect_rows_plain(dec, n_valid, ring)
            for d in (dec, dec.to(torch.uint8)):
                before = vad_collect_rows.launches
                keep, kept = vad_collect_rows(d.to(device),
                                              n_valid.to(device), ring)
                torch.cuda.synchronize()
                assert vad_collect_rows.launches == before + 1
                assert torch.equal(keep.cpu(), ref_keep)
                assert torch.equal(kept.cpu(), ref_kept)
            if ring == 10 and batch >= 96 and frames >= 31:
                assert ref_keep.any() and not ref_keep.all()


def test_collect_rows_one_launch_bool_view(device):
    """One ``vad_collect_rows`` call is one launch and runs one kernel on
    the card, W2's: the keep mask is the kernel's own uint8 output viewed
    as bool (its storage is the B x T bytes W2 wrote), with no conversion
    kernel for bool decisions or for the result."""
    from torch.profiler import ProfilerActivity, profile

    from mmla_audio_torch.vad.collector import vad_collect_rows

    dec = torch.from_numpy(np.random.RandomState(3).rand(64, 85) < 0.8)
    n_valid = torch.full((64,), 85, dtype=torch.int32, device=device)
    for d in (dec.to(device), dec.to(device, torch.uint8)):
        torch.cuda.synchronize()
        before = vad_collect_rows.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            keep, kept = vad_collect_rows(d, n_valid)
            torch.cuda.synchronize()
        assert vad_collect_rows.launches == before + 1
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        assert len(kernels) == 1 and "vad_collect" in kernels[0], kernels
        assert keep.dtype == torch.bool and keep.shape == (64, 85)
        assert keep.untyped_storage().nbytes() == 64 * 85
        assert set(keep.view(torch.uint8).unique().tolist()) <= {0, 1}
        assert kept.dtype == torch.int32 and bool(keep.any())


def test_vad_trim_batch_card_matches_cpu(device):
    from mmla_audio_torch.vad.collector import vad_trim_batch

    rng = np.random.RandomState(1)
    buf = torch.from_numpy(_vad_windows(6, seed=3, n=40960)).float()
    dec = torch.from_numpy(rng.rand(6, 85) < 0.8)
    n = torch.tensor([40960, 30001, 4800, 500, 40960, 20000],
                     dtype=torch.int32)
    ref, ref_n = vad_trim_batch(buf, n, dec)
    got, got_n = vad_trim_batch(buf.to(device), n.to(device),
                                dec.to(device))
    assert torch.equal(got.cpu(), ref) and torch.equal(got_n.cpu(), ref_n)


def test_cpu_tensors_never_reach_the_vad_kernels(device):
    """With a card present, CPU tensors still take the plain versions."""
    from mmla_audio_torch.vad.collector import vad_collect_rows
    from mmla_audio_torch.vad.webrtc import webrtc_init, webrtc_vad_rows

    before = (webrtc_vad_rows.launches, vad_collect_rows.launches)
    dec = webrtc_vad_rows(torch.from_numpy(_vad_windows(2, seed=4)),
                          webrtc_init(2, "cpu"), [0, 1])
    keep, _ = vad_collect_rows(dec, torch.tensor([85, 85], dtype=torch.int32))
    assert keep.device.type == "cpu"
    assert (webrtc_vad_rows.launches, vad_collect_rows.launches) == before


def test_multiplexer_launches_each_kernel_once_a_batch(device, tmp_path):
    """The multiplexer on the card: every dispatched batch launches W1, W2
    and the featurizer once and the fused block once per non-pooling
    block; the labels equal the CPU multiplexer's on the same audio."""
    import dataclasses

    from mmla_audio_torch.core.config import PipelineConfig
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.multiplex import Multiplexer
    from mmla_audio_torch.vad.collector import vad_collect_rows
    from mmla_audio_torch.vad.webrtc import webrtc_vad_rows

    mcfg = OverlapModelConfig(stage_filters=(8, 8, 8), lstm_units=8,
                              input_scale=1 / 255)
    cfg = dataclasses.replace(PipelineConfig(), overlap_model=mcfg)
    sd = keras_init_(OverlapResBLSTM(mcfg),
                     torch.Generator().manual_seed(0)).state_dict()
    audio = [(_audio(1, 3 * 40960, seed=s)[0] * 20000).astype(np.int16)
             for s in range(3)]
    noise = (np.random.RandomState(3).randn(160000) * 15).astype(np.int16)
    labels = {}
    for dev in (device, torch.device("cpu")):
        pred = OverlapPredictor(sd, mcfg, device=dev,
                                matmul_precision="highest")
        mux = Multiplexer(pred, tmp_path / dev.type, buckets=(2, 4),
                          cfg=cfg, device=dev)
        streams = [mux.add_stream(f"s{i}", PrefilledCapture(a), noise)
                   for i, a in enumerate(audio)]
        batches = []
        orig = mux._dispatch_staged

        def spy():
            batches.append(1)
            return orig()

        mux._dispatch_staged = spy
        before = (webrtc_vad_rows.launches, vad_collect_rows.launches,
                  overlap_model_input_cuda.launches,
                  fused_resblock_cuda.launches_mma)
        assert mux.run_until_exhausted() == 9
        after = (webrtc_vad_rows.launches, vad_collect_rows.launches,
                 overlap_model_input_cuda.launches,
                 fused_resblock_cuda.launches_mma)
        n = len(batches) if dev.type == "cuda" else 0
        assert [a - b for a, b in zip(after, before)] == [n, n, n, 6 * n]
        labels[dev.type] = [[r[1] for r in s.results] for s in streams]
    assert len(batches) >= 3
    assert labels["cuda"] == labels["cpu"]


def test_multiplexer_dispatch_does_not_wait_for_the_card(device, tmp_path):
    """A tick's gather and dispatch (the copies, W1, W2, the featurizer and
    the model) enqueue without a synchronizing call: only the next tick's
    label fetch waits for the card."""
    import dataclasses

    from mmla_audio_torch.core.config import PipelineConfig
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.multiplex import Multiplexer

    mcfg = OverlapModelConfig(stage_filters=(8, 8, 8), lstm_units=8)
    cfg = dataclasses.replace(PipelineConfig(), overlap_model=mcfg)
    sd = keras_init_(OverlapResBLSTM(mcfg),
                     torch.Generator().manual_seed(0)).state_dict()
    pred = OverlapPredictor(sd, mcfg, device=device)
    mux = Multiplexer(pred, tmp_path, bucket=2, cfg=cfg, device=device)
    noise = (np.random.RandomState(3).randn(160000) * 15).astype(np.int16)
    for s in range(2):
        mux.add_stream(f"s{s}", PrefilledCapture(
            (_audio(1, 3 * 40960, seed=s)[0] * 20000).astype(np.int16)),
            noise)
    assert mux.tick() == 0 and mux.flush() == 2      # warm: caches, plans
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert mux.tick() == 0                       # gather + dispatch
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert mux._inflight is not None
    assert mux.tick() == 2 and mux.flush() == 2


# -- the denoise kernels: D1 (a real FFT a frame) and D2 (banded smoothing) --

def _denoise_input(batch, seed, n=40960):
    from mmla_audio_torch.core.config import DenoiseConfig
    from mmla_audio_torch.ops.denoise import noise_threshold

    rng = np.random.RandomState(seed)
    y = _audio(batch, n, seed) * rng.uniform(0.05, 1.0, (batch, 1)) \
        + rng.randn(batch, n) * 1e-3
    noise = (rng.randn(32000) * 1e-3).astype(np.float32)
    return (torch.from_numpy(y.astype(np.float32)),
            noise_threshold(torch.from_numpy(noise), DenoiseConfig()))


@pytest.mark.parametrize("batch,passes", [(1, 1), (8, 1), (64, 1), (512, 1),
                                          (8, 4)])
def test_denoise_batch_equals_each_window_alone(device, batch, passes):
    from mmla_audio_torch.ops.denoise import reduce_noise

    y, nt = _denoise_input(batch, seed=batch)
    y, nt = y.to(device), nt.to(device)
    got = reduce_noise(y, nt, passes=passes)
    rows = range(batch) if batch <= 64 else (0, 1, 200, 383, 510, 511)
    for b in rows:
        assert torch.equal(reduce_noise(y[b], nt, passes=passes), got[b])


def test_denoise_batch_equals_alone_with_bucket_padding(device):
    """The multiplexer's shape: 5 streams padded to a bucket of 8 with zero
    rows, a threshold per row (zero for padding)."""
    from mmla_audio_torch.ops.denoise import reduce_noise

    y, nt = _denoise_input(8, seed=3)
    y[5:] = 0
    nts = torch.stack([nt * (1 + 0.1 * b) for b in range(8)])
    nts[5:] = 0
    y, nts = y.to(device), nts.to(device)
    got = reduce_noise(y, nts[:, None, :])
    for b in range(5):
        assert torch.equal(reduce_noise(y[b], nts[b]), got[b])


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_d1_fft_matches_plain(device, batch):
    """D1's forward and inverse FFT kernels against the plain dense
    products (``torch.matmul``, IEEE fp32) on live windows: within 2e-5 of
    max |ref| (the fp32 products err near 1e-6); against the same products
    in float64 within 1e-7 of max |ref| (D1 computes in float64 and rounds
    each output once to float32, at most 2^-24 of it); the inverse ignores
    the imaginary parts at DC and Nyquist, as the inverse bases do; one
    launch each."""
    from mmla_audio_torch.ops import denoise as dn

    y, _ = _denoise_input(batch, seed=7)
    y = y.to(device)
    before = (dn.stft_ri.launches, dn.istft_frames.launches)
    with fp32_policy(False):
        re, im = dn.stft_ri(y, 1024, 256)
        pre, pim = dn.stft_ri_plain(y, 1024, 256)
        pim = pim.clone()
        pim[..., [0, 512]] += 0.25
        fr = dn.istft_frames(pre, pim, 1024)
        pfr = dn.istft_frames_plain(pre, pim, 1024)
    torch.cuda.synchronize()
    assert (dn.stft_ri.launches, dn.istft_frames.launches) == \
        (before[0] + 1, before[1] + 1)
    for got, ref in ((re, pre), (im, pim), (fr, pfr)):
        assert got.shape == ref.shape
    pim[..., [0, 512]] -= 0.25
    for got, ref in ((re, pre), (im, pim), (fr, pfr)):
        assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    xre, xim = dn.stft_ri_plain(y.double(), 1024, 256)
    xfr = dn.istft_frames_plain(pre.double(), pim.double(), 1024)
    for got, ref in ((re, xre), (im, xim), (fr, xfr)):
        assert float((got.double() - ref).abs().max()) <= \
            1e-7 * float(ref.abs().max())


@pytest.mark.parametrize("frames", [1, 6, 7, 15, 64, 65, 183, 1000])
def test_smooth_mask_matches_dense(device, frames):
    from mmla_audio_torch.core.config import DenoiseConfig
    from mmla_audio_torch.ops import denoise as dn

    mask = torch.from_numpy(np.random.RandomState(frames).rand(
        3, frames, 513).astype(np.float32)).to(device)
    before = dn.smooth_mask.launches
    got = dn.smooth_mask(mask, DenoiseConfig(), 16000)
    assert dn.smooth_mask.launches == before + 1
    ref = dn.smooth_mask_plain(mask, DenoiseConfig(), 16000)
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("frames", [1, 65, 183])
def test_smooth_mask_other_taps_match_dense(device, frames):
    """Odd tap counts other than (33, 7) (here (19, 13)) take the generic
    kernel: one launch, within 1e-6 of the dense pair."""
    from mmla_audio_torch.core.config import DenoiseConfig
    from mmla_audio_torch.ops import denoise as dn

    cfg = DenoiseConfig(freq_mask_smooth_hz=300.0, time_mask_smooth_ms=100.0)
    assert tuple(map(len, dn._smoothing_taps(cfg, 16000, device))) == (19, 13)
    mask = torch.from_numpy(np.random.RandomState(frames).rand(
        3, frames, 513).astype(np.float32)).to(device)
    before = dn.smooth_mask.launches
    got = dn.smooth_mask(mask, cfg, 16000)
    assert dn.smooth_mask.launches == before + 1
    ref = dn.smooth_mask_plain(mask, cfg, 16000)
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("groups", [1, 3, 64, 512])
def test_smooth_mask_batch_equals_alone(device, groups):
    """D2 of a batch equals each window smoothed alone bit for bit, at T =
    183 (a live window, no multiple of any strip), though the plan picks
    other strips and tiles for the batch and for one window."""
    from mmla_audio_torch.core.config import DenoiseConfig
    from mmla_audio_torch.ops import denoise as dn
    from mmla_audio_torch.ops.cuda_denoise import smooth_plan

    mask = torch.from_numpy(np.random.RandomState(groups).rand(
        groups, 183, 513).astype(np.float32)).to(device)
    got = dn.smooth_mask(mask, DenoiseConfig(), 16000)
    picks = sorted({0, groups // 2, groups - 1})
    for g in picks:
        alone = dn.smooth_mask(mask[g:g + 1], DenoiseConfig(), 16000)
        assert torch.equal(alone[0].view(torch.int32),
                           got[g].view(torch.int32))
    if groups >= 64:
        assert smooth_plan(groups, 183, 513) != smooth_plan(1, 183, 513)


def test_card_denoise_never_reaches_the_plain_versions(device, monkeypatch):
    from mmla_audio_torch.ops import denoise as dn

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    y, nt = _denoise_input(2, seed=9)          # the profile on the CPU
    for name in ("stft_ri_plain", "istft_frames_plain", "smooth_mask_plain",
                 "_smoothing_matrices"):
        monkeypatch.setattr(dn, name, refuse)
    before = (dn.stft_ri.launches, dn.istft_frames.launches,
              dn.smooth_mask.launches)
    dn.noise_threshold(y[0].to(device))
    dn.reduce_noise(y.to(device), nt.to(device), passes=3)
    assert (dn.stft_ri.launches, dn.istft_frames.launches,
            dn.smooth_mask.launches) == (before[0] + 4, before[1] + 3,
                                         before[2] + 3)


def test_denoise_kernels_refuse_float64(device):
    from mmla_audio_torch.core.config import DenoiseConfig
    from mmla_audio_torch.ops import denoise as dn

    with pytest.raises(TypeError, match="float32"):
        dn.stft_ri(torch.zeros(4000, dtype=torch.float64, device=device),
                   1024, 256)
    with pytest.raises(TypeError, match="float32"):
        dn.istft_frames(torch.zeros((4, 513), dtype=torch.float64,
                                    device=device),
                        torch.zeros((4, 513), device=device), 1024)
    with pytest.raises(TypeError, match="float32"):
        dn.smooth_mask(torch.zeros((4, 513), dtype=torch.float64,
                                   device=device), DenoiseConfig(), 16000)
    with pytest.raises(ValueError, match="built for n_fft 1024"):
        dn.stft_ri(torch.zeros(4000, device=device), 512, 128)


def test_aot_compile_captures_the_predictor(device):
    """``export.aot_compile`` on the card: a CUDA graph of the predictor
    (featurizer B1, the fused blocks B3, cuDNN's LSTM) whose replay gives
    eager's labels and probabilities and refuses another batch."""
    from mmla_audio_torch.export import aot_compile

    cfg = OverlapModelConfig(stage_filters=(8, 8, 16), lstm_units=16)
    pred = OverlapPredictor(keras_init_(
        OverlapResBLSTM(cfg), torch.Generator().manual_seed(0)).state_dict(),
        cfg, device=device, matmul_precision="highest")
    bufs = torch.from_numpy((_audio(4, 40960) * 20000).astype(np.int16)
                            ).to(device)
    counts = torch.tensor([40960, 30000, 20000, 3000], dtype=torch.int32,
                          device=device)
    ref = pred.predict(bufs, counts)
    before = (overlap_model_input_cuda.launches,
              fused_resblock_cuda.launches)
    compiled = aot_compile(pred.predict, bufs, counts)
    # the warm-up and the capture each launch B1 once and B3 six times
    assert (overlap_model_input_cuda.launches - before[0],
            fused_resblock_cuda.launches - before[1]) == (2, 12)
    for _ in range(2):
        labels, probs = compiled(bufs, counts)
        assert torch.equal(labels, ref[0])
        torch.testing.assert_close(probs, ref[1], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="compiled for"):
        compiled(bufs[:2], counts[:2])


# -- data parallelism: the mesh multiplexer, NCCL at world size 1 -----------

def test_make_mesh_without_a_card_raises(monkeypatch):
    """``make_mesh()`` spans this process's cards and has no CPU fallback
    (runs without a card too)."""
    from mmla_audio_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_mesh_multiplexer_one_card_equals_unsplit(device, tmp_path):
    """On the card: a one-device mesh is the ``mesh=None`` path (the same
    launches, labels and detector rows), and a mesh that lists the card
    twice splits each batch in two (twice the launches of every kernel)
    with the same labels and rows, D1 and D2 being batch-invariant."""
    import dataclasses

    from mmla_audio_torch.core.config import PipelineConfig
    from mmla_audio_torch.ops.denoise import smooth_mask
    from mmla_audio_torch.parallel import make_mesh
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.multiplex import Multiplexer
    from mmla_audio_torch.vad.collector import vad_collect_rows
    from mmla_audio_torch.vad.webrtc import webrtc_vad_rows

    mcfg = OverlapModelConfig(stage_filters=(8, 8, 8), lstm_units=8,
                              input_scale=1 / 255)
    cfg = dataclasses.replace(PipelineConfig(), overlap_model=mcfg)
    sd = keras_init_(OverlapResBLSTM(mcfg),
                     torch.Generator().manual_seed(0)).state_dict()
    pred = OverlapPredictor(sd, mcfg, device=device,
                            matmul_precision="highest")
    noise = (np.random.RandomState(3).randn(160000) * 15).astype(np.int16)
    counters = (webrtc_vad_rows, vad_collect_rows, overlap_model_input_cuda,
                smooth_mask)
    runs = {}
    for name, mesh in (("none", None), ("one", make_mesh()),
                       ("twice", make_mesh(devices=[device, device]))):
        mux = Multiplexer(pred, tmp_path / name, bucket=4, cfg=cfg,
                          device=device, mesh=mesh)
        streams = [mux.add_stream(f"s{i}", PrefilledCapture(
            (_audio(1, 3 * 40960, seed=i)[0] * 20000).astype(np.int16)),
            noise) for i in range(4)]
        before = [c.launches for c in counters] + \
            [fused_resblock_cuda.launches_mma]
        assert mux.run_until_exhausted() == 12
        after = [c.launches for c in counters] + \
            [fused_resblock_cuda.launches_mma]
        runs[name] = ([[r[1] for r in s.results] for s in streams],
                      mux._webrtc_states.cpu(),
                      [a - b for a, b in zip(after, before)])
    for name in ("one", "twice"):
        assert runs[name][0] == runs["none"][0], name
        assert torch.equal(runs[name][1], runs["none"][1]), name
    assert runs["one"][2] == runs["none"][2]
    assert runs["twice"][2] == [2 * n for n in runs["none"][2]]
    assert min(runs["none"][2]) > 0


def test_initialize_nccl_world_of_one(device):
    """``initialize`` with NCCL at world size 1 (this machine's one card),
    ``global_mesh`` carrying the group, an all-reduce through it."""
    import socket

    import torch.distributed as tdist

    from mmla_audio_torch.parallel import distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.process_info() == (0, 1)
        assert tdist.get_backend() == "nccl"
        mesh = dist.global_mesh()
        assert mesh.group is not None and mesh.devices.shape == (1, 1)
        x = torch.arange(4.0, device=device)
        tdist.all_reduce(x, group=mesh.group)
        assert x.tolist() == [0.0, 1.0, 2.0, 3.0]
        xg = dist.host_local_batch_to_global(x, mesh)
        assert torch.equal(xg.gather(), x)
    finally:
        tdist.destroy_process_group()
        dist._initialized = False


def _gmm_rows(batch, seed=0, frames=85):
    """Band and frame energies of ``batch`` speech windows with silences
    (int16 scale, ``frames`` frames) and their state rows: the mixtures
    calibrated on seeded noise, each row's means shifted by a seeded
    offset."""
    from mmla_audio_torch.vad import gmm

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(_vad_windows(batch, seed=seed, n=frames * 480)
                         .astype(np.float32))
    st = gmm.gmm_init_from_noise((rng.randn(160000) * 300).astype(np.int16),
                                 device="cpu")
    rows = gmm.state_rows(st).expand(batch, -1).clone()
    shift = torch.from_numpy(rng.uniform(-3, 3, (batch, 1)).astype(np.float32))
    rows[:, 0:12] += shift                  # noise means
    rows[:, 24:36] += shift                 # speech means
    return gmm.band_log_energies(x), gmm.total_db(x), rows


@pytest.mark.parametrize("adapt", [True, False])
@pytest.mark.parametrize("batch,frames", [(1, 85), (8, 85), (64, 85),
                                          (5, 1), (3, 400)])
def test_gmm_vad_kernel_matches_plain(device, batch, frames, adapt):
    """G1 against the plain frame loop on the card: decisions equal where
    the plain run's margins exceed 1e-3, final states within 1e-5 on rows
    whose decisions all agree (the update's IEEE operations are the plain
    loop's, in its order)."""
    from mmla_audio_torch.vad import gmm

    e, tot, rows = (a.to(device) for a in _gmm_rows(batch, 5, frames))
    for mode in (0, 3):
        before = gmm.gmm_vad_rows.launches
        dec, out = gmm.gmm_vad_rows(e, tot, rows, mode, adapt)
        torch.cuda.synchronize()
        assert gmm.gmm_vad_rows.launches == before + 1
        ref_dec, ref_out, margins = gmm.gmm_vad_rows_plain(
            e, tot, rows, mode, adapt, with_margins=True)
        clear = (margins > 1e-3).all(-1)
        assert dec.dtype == torch.bool and dec.shape == (batch, frames)
        assert torch.equal(dec[clear], ref_dec[clear])
        same = (dec == ref_dec).all(1)
        assert bool(same.any())
        torch.testing.assert_close(out[same], ref_out[same], rtol=0,
                                   atol=1e-5)


def test_gmm_vad_kernel_batch_equals_alone(device):
    """A row's decisions and state are the same bits alone and in a batch
    of 64."""
    from mmla_audio_torch.vad import gmm

    e, tot, rows = (a.to(device) for a in _gmm_rows(64, 6))
    dec, out = gmm.gmm_vad_rows(e, tot, rows)
    for b in (0, 1, 31, 63):
        d1, o1 = gmm.gmm_vad_rows(e[b:b + 1], tot[b:b + 1], rows[b:b + 1])
        assert torch.equal(d1[0], dec[b]) and torch.equal(o1[0], out[b])


def test_gmm_vad_on_the_card_launches_g1(device):
    """``gmm_vad`` of a CUDA window launches G1 once and agrees with the
    CPU's plain loop; a CPU window never reaches G1."""
    from mmla_audio_torch.vad import gmm

    rng = np.random.RandomState(2)
    st = gmm.gmm_init_from_noise((rng.randn(160000) * 40).astype(np.int16),
                                 device="cpu")
    x = torch.from_numpy(_vad_windows(1, seed=9)[0].astype(np.float32))
    before = gmm.gmm_vad_rows.launches
    ref, ref_st = gmm.gmm_vad(x, st)
    assert gmm.gmm_vad_rows.launches == before
    got, got_st = gmm.gmm_vad(x.to(device),
                              gmm.GmmVadState(*(t.to(device) for t in st)))
    assert gmm.gmm_vad_rows.launches == before + 1
    assert got.device.type == "cuda" and got.shape == ref.shape
    assert float((got.cpu() == ref).float().mean()) > 0.95
