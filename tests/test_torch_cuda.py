"""Tests that need the card: the CUDA kernels (featurizer, one window and
grouped, on speech, silence and a clipped sine; fused residual block; the
batched webrtcvad engine W1 and the collector W2; the denoise's D1 and D2;
the GMM VAD's G1, from samples and from energies)
against their plain versions, the block's dispatch rule, the predictor on
the card against the CPU, the multiplexer's launches, the denoise of a
window equal in a batch and alone, and the predictor captured as a CUDA
graph by ``export.aot_compile``; kernel A1 against the attention in
float64, kernel E1 against the conv encoder's plain version in float64,
and the full-width WavLM against ``tests/wavlm_reference.py``; kernel A2
against the Conformer's attention in float64, its kernels tied to the
layers in a profile, and the full-width Conformer at four layers against
``tests/conformer_reference.py``; kernel C1 against the conv module's
plain middle in float64, its launches a forward and its kernel tied to its
operator inside ``model.conv_module``.

This file imports neither JAX nor tests/conftest.py, so it runs where JAX is
not installed:  python -m pytest --noconftest tests/test_torch_cuda.py
Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from chip_smoke import GMM_DB, g1_energies_close
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
    the model's graph replays) enqueue without a synchronizing call: only
    the next tick's label fetch waits for the card.  Two ticks warm up: the
    first chooses plans, the second captures the model's graphs."""
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
            (_audio(1, 4 * 40960, seed=s)[0] * 20000).astype(np.int16)),
            noise)
    for _ in range(2):                 # warm: caches, plans; graphs
        assert mux.tick() == 0 and mux.flush() == 2
    assert pred.graph_stats()["captures"] == 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert mux.tick() == 0                       # gather + dispatch
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert mux._inflight is not None
    assert mux.tick() == 2 and mux.flush() == 2


def test_multiplexer_resolves_a_batch_on_its_own_event(device, tmp_path):
    """A tick resolves the previous batch N by N's own event: with a long
    sleep kernel queued after N and batch N+1 dispatched behind the sleep,
    ``tick()`` logs N's labels and returns while the sleep still runs, so
    neither the dispatch nor the fetch waited for work enqueued after N.
    ``flush()`` logs N+1; the labels equal a CPU multiplexer's."""
    import dataclasses

    from mmla_audio_torch.core.config import PipelineConfig
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.multiplex import Multiplexer

    mcfg = OverlapModelConfig(stage_filters=(8, 8, 8), lstm_units=8,
                              input_scale=1 / 255)
    cfg = dataclasses.replace(PipelineConfig(), overlap_model=mcfg)
    sd = keras_init_(OverlapResBLSTM(mcfg),
                     torch.Generator().manual_seed(0)).state_dict()
    audio = [(_audio(1, 4 * 40960, seed=s)[0] * 20000).astype(np.int16)
             for s in range(2)]
    audio[0][3 * 40960:] = 0           # silent windows tell the rows and
    audio[1][2 * 40960: 3 * 40960] = 0     # batches N, N+1 apart
    noise = (np.random.RandomState(3).randn(160000) * 15).astype(np.int16)
    labels = {}
    for dev in (device, torch.device("cpu")):
        pred = OverlapPredictor(sd, mcfg, device=dev,
                                matmul_precision="highest")
        mux = Multiplexer(pred, tmp_path / dev.type, bucket=2, cfg=cfg,
                          device=dev)
        streams = [mux.add_stream(f"s{i}", PrefilledCapture(a), noise)
                   for i, a in enumerate(audio)]
        for _ in range(2):             # warm: caches, plans; graphs
            assert mux.tick() == 0 and mux.flush() == 2
        assert mux.tick() == 0                       # dispatch N
        if dev.type == "cuda":
            mux._inflight[1].event.synchronize()     # N done, its copy too
            ready, waited = mux.fetch_ready, mux.fetch_waited
            torch.cuda._sleep(300_000_000)           # ~0.15 s at 1.98 GHz
            slept = torch.cuda.Event()
            slept.record()
        assert mux.tick() == 2                       # dispatch N+1, log N
        assert [len(s.results) for s in streams] == [3, 3]
        if dev.type == "cuda":
            assert not slept.query()
            assert not torch.cuda.current_stream().query()
            assert (mux.fetch_ready, mux.fetch_waited) == (ready + 1,
                                                           waited)
        assert mux.flush() == 2
        assert [len(s.results) for s in streams] == [4, 4]
        labels[dev.type] = [[r[1] for r in s.results] for s in streams]
    assert labels["cpu"][0][3] == labels["cpu"][1][2] == "silent" \
        != labels["cpu"][0][2]
    assert labels["cuda"] == labels["cpu"]


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


# -- CUDA graphs of the overlap model's stretches (OverlapPredictor) ---------

def _graph_predictor(device, tf32, cfg=OverlapModelConfig(), seed=0):
    sd = keras_init_(OverlapResBLSTM(cfg),
                     torch.Generator().manual_seed(seed)).state_dict()
    return OverlapPredictor(sd, cfg, device=device,
                            matmul_precision=None if tf32 else "highest")


def _perturbed(model, seed):
    """``model``'s state dict with every floating leaf moved (BatchNorm
    variances kept positive), so a refold and a graph both have something
    to read."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        if t.is_floating_point():
            t = t.cpu() * (1 + 0.2 * torch.rand(t.shape, generator=g))
            if not name.endswith("running_var"):
                t = t + 0.02 * torch.randn(t.shape, generator=g)
        out[name] = t
    return out


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_graphed_apply_model_equals_eager(device, batch, tf32):
    """``apply_model`` at the cells' batch sizes, full width, TF32 off and
    on: a shape met once runs eagerly and captures nothing; the second call
    captures and the third replays, six fused-block launches each; every
    call equals the eager forward bit for bit; the logits are the caller's
    (a later replay leaves them); weights loaded in place show in the next
    replay; ``graph_stats()`` counts each step."""
    from mmla_audio_torch.inference import _apply

    pred = _graph_predictor(device, tf32)
    imgs = [overlap_model_input_cuda(torch.from_numpy(
        _audio(batch, 24000, seed=s)).to(device)) for s in (1, 2)]

    def eager(img):
        return _apply(pred.model, img, img.device, None,
                      pred.matmul_precision)

    with torch.no_grad():
        ref = eager(imgs[0])
        first = pred.apply_model(imgs[0])
        assert pred.graph_stats() == {"captures": 0, "replays": 0,
                                      "eager": 1}
        assert not pred._graphs
        second = pred.apply_model(imgs[0])
        assert pred.graph_stats() == {"captures": 1, "replays": 1,
                                      "eager": 1}
        before = fused_resblock_cuda.launches
        third = pred.apply_model(imgs[0])
        torch.cuda.synchronize()
        assert fused_resblock_cuda.launches == before + 6
        for got in (first, second, third):
            assert torch.equal(got, ref)
        other = pred.apply_model(imgs[1])
        assert torch.equal(third, ref)
        assert torch.equal(other, eager(imgs[1]))
        pred.model.load_state_dict(_perturbed(pred.model, 5))
        moved = eager(imgs[0])
        assert not torch.equal(moved, ref)
        assert torch.equal(pred.apply_model(imgs[0]), moved)
        assert pred.graph_stats() == {"captures": 1, "replays": 4,
                                      "eager": 1}


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_graphs_stay_out_of_an_outer_capture(device, batch, tf32):
    """``export.aot_compile`` around ``predict``: its warm-up meets the
    shape first and its capture records the eager forward (both counted
    ``eager``, nothing captured by the predictor); the compiled replay
    agrees with ``predict``, whose later calls capture and replay the
    predictor's own graphs."""
    from mmla_audio_torch.export import aot_compile

    pred = _graph_predictor(device, tf32)
    bufs = torch.from_numpy((_audio(batch, 40960) * 20000).astype(np.int16)
                            ).to(device)
    counts = torch.full((batch,), 30000, dtype=torch.int32, device=device)
    compiled = aot_compile(pred.predict, bufs, counts)
    assert pred.graph_stats() == {"captures": 0, "replays": 0, "eager": 2}
    labels, probs = compiled(bufs, counts)
    for _ in range(2):
        ref = pred.predict(bufs, counts)
        assert torch.equal(labels, ref[0])
        assert torch.equal(probs, ref[1])
    assert pred.graph_stats() == {"captures": 1, "replays": 2, "eager": 2}


def test_graphs_keep_a_bounded_set_of_shapes(device):
    """Each of ``GRAPH_SHAPES + 2`` batch sizes met twice: the predictor
    never holds more than ``GRAPH_SHAPES`` shapes' graphs, the oldest go
    first, and a shape evicted starts again from once-met."""
    from mmla_audio_torch.inference import GRAPH_SHAPES

    cfg = OverlapModelConfig(stage_filters=(8, 8, 16), lstm_units=16)
    pred = _graph_predictor(device, False, cfg)
    img = overlap_model_input_cuda(torch.from_numpy(
        _audio(GRAPH_SHAPES + 2, 24000)).to(device))
    with torch.no_grad():
        for b in range(1, GRAPH_SHAPES + 3):
            for _ in range(2):
                pred.apply_model(img[:b])
                assert len(pred._graphs) <= GRAPH_SHAPES
        assert [k[2][0] for k in pred._graphs] == \
            list(range(3, GRAPH_SHAPES + 3))
        assert pred.graph_stats() == {"captures": GRAPH_SHAPES + 2,
                                      "replays": GRAPH_SHAPES + 2,
                                      "eager": GRAPH_SHAPES + 2}
        ref = _graph_predictor(device, False, cfg).apply_model(img[:1])
        for _ in range(2):
            assert torch.equal(pred.apply_model(img[:1]), ref)
        assert pred.graph_stats()["captures"] == GRAPH_SHAPES + 3
        assert pred.graph_stats()["eager"] == GRAPH_SHAPES + 3


def test_graphs_shared_by_threads(device):
    """Four threads share one predictor, each its own batch of one shape,
    the interpreter switching threads every microsecond: every forward
    returns the logits its batch gave alone (no thread's input lands in
    another's replay), and the counts add up."""
    import sys
    import threading

    cfg = OverlapModelConfig(stage_filters=(8, 8, 16), lstm_units=16)
    pred = _graph_predictor(device, False, cfg)
    imgs = [overlap_model_input_cuda(torch.from_numpy(
        _audio(2, 24000, seed=s)).to(device)) for s in range(4)]
    with torch.no_grad():
        refs = [pred.apply_model(img) for img in imgs]
    wrong = []

    def work(img, ref):
        with torch.no_grad():
            for _ in range(30):
                if not torch.equal(pred.apply_model(img), ref):
                    wrong.append(1)

    threads = [threading.Thread(target=work, args=a)
               for a in zip(imgs, refs)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not wrong
    stats = pred.graph_stats()
    assert stats["captures"] == 1
    assert stats["replays"] + stats["eager"] == 4 + 4 * 30


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


def test_gmm_vad_on_the_card_launches_g1(device, monkeypatch):
    """``gmm_vad`` of a CUDA window launches G1 once, from its samples (no
    plain filterbank op, no energies-in launch), and agrees with the CPU's
    plain loop; a CPU window never reaches G1."""
    from mmla_audio_torch.vad import gmm

    rng = np.random.RandomState(2)
    st = gmm.gmm_init_from_noise((rng.randn(160000) * 40).astype(np.int16),
                                 device="cpu")
    x = torch.from_numpy(_vad_windows(1, seed=9)[0].astype(np.float32))
    before = gmm.gmm_vad_windows.launches, gmm.gmm_vad_rows.launches
    ref, ref_st = gmm.gmm_vad(x, st)
    assert (gmm.gmm_vad_windows.launches, gmm.gmm_vad_rows.launches) \
        == before

    def cpu_only(fn):
        def check(sig, *a, **kw):
            assert sig.device.type == "cpu", "a plain filterbank op on the card"
            return fn(sig, *a, **kw)
        return check

    for name in ("band_log_energies", "total_db"):
        monkeypatch.setattr(gmm, name, cpu_only(getattr(gmm, name)))
    got, got_st = gmm.gmm_vad(x.to(device),
                              gmm.GmmVadState(*(t.to(device) for t in st)))
    assert (gmm.gmm_vad_windows.launches, gmm.gmm_vad_rows.launches) \
        == (before[0] + 1, before[1])
    assert got.device.type == "cuda" and got.shape == ref.shape
    assert float((got.cpu() == ref).float().mean()) > 0.95


def _g1_windows(batch, seed, n=40960, frame_len=480):
    """``batch`` int16-scale windows (``_vad_windows``: tones with
    silences, noise, a square wave) and their state rows: the mixtures
    calibrated on seeded noise, each row's means shifted by a seeded
    offset."""
    from mmla_audio_torch.vad import gmm

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(_vad_windows(batch, seed=seed, n=n)
                         .astype(np.float32))
    st = gmm.gmm_init_from_noise((rng.randn(160000) * 300).astype(np.int16),
                                 frame_len, device="cpu")
    rows = gmm.state_rows(st).expand(batch, -1).clone()
    shift = torch.from_numpy(rng.uniform(-3, 3, (batch, 1)).astype(np.float32))
    rows[:, 0:12] += shift                  # noise means
    rows[:, 24:36] += shift                 # speech means
    return x, rows


@pytest.mark.parametrize("batch,n,frame_len", [
    (1, 40960, 480), (8, 40960, 480), (64, 40960, 480), (3, 40960, 400),
    (1, 160000, 480), (33, 40960 + 77, 480), (512, 40960, 480)])
def test_g1_windows_match_plain(device, batch, n, frame_len):
    """G1 from samples, one launch: its energies against the plain
    filterbank on the CPU (``chip_smoke.g1_energies_close``: within 1e-3
    dB, or a band more than 40 dB below its frame's energy, where the
    FIRs' cancellation costs it relative accuracy, within 1e-6 of that
    energy in linear terms), its decisions equal to
    the plain path's wherever the plain run's margins exceed 1e-3, and its
    final state bit for bit that of ``_scan`` fed G1's own energies (on
    rows whose decisions agree)."""
    from mmla_audio_torch.vad import gmm

    x, rows = _g1_windows(batch, 7, n, frame_len)
    before = gmm.gmm_vad_windows.launches
    dec, out, e, tot = gmm.gmm_vad_windows(
        x.to(device), rows.to(device), 3, True, frame_len,
        with_energies=True)
    torch.cuda.synchronize()
    assert gmm.gmm_vad_windows.launches == before + 1
    T = n // frame_len
    assert dec.shape == (batch, T) and dec.dtype == torch.bool
    ref_e, ref_tot = gmm.band_log_energies(x, frame_len), gmm.total_db(
        x, frame_len)
    torch.testing.assert_close(tot.cpu(), ref_tot, rtol=0, atol=GMM_DB)
    worst = g1_energies_close(e.cpu(), ref_e, ref_tot)
    print(f"G1 B={batch} n={n} frame_len={frame_len}: largest band "
          f"energy difference {worst:.3g} dB")
    ref_dec, _, margins = gmm.gmm_vad_rows_plain(ref_e, ref_tot, rows, 3,
                                                 True, with_margins=True)
    clear = (margins > 1e-3).all(-1)
    assert torch.equal(dec.cpu()[clear], ref_dec[clear])
    own_dec, own_out = gmm.gmm_vad_rows_plain(e, tot, rows.to(device), 3,
                                              True)
    same = (dec == own_dec).all(1)
    assert bool(same.float().mean() > 0.9)
    assert torch.equal(out[same], own_out[same])


def test_g1_windows_batch_equals_alone(device):
    """A row's decisions, state and energies are the same bits alone (a
    cluster of 8 CTAs) and in batches of 16, 64 (clusters of 4 and 2) and
    72 (one CTA a stream)."""
    from mmla_audio_torch.vad import gmm

    x, rows = _g1_windows(72, 8)
    xd, rd = x.to(device), rows.to(device)
    full = gmm.gmm_vad_windows(xd, rd, with_energies=True)
    for b in (0, 1, 2, 3, 37, 63):
        for lo, hi in ((b, b + 1), (b & ~15, (b & ~15) + 16), (0, 64)):
            part = gmm.gmm_vad_windows(xd[lo:hi], rd[lo:hi],
                                       with_energies=True)
            for p, f in zip(part, full):
                assert torch.equal(p[b - lo], f[b])


def test_g1_windows_without_a_frame(device):
    """n < frame_len: T = 0, no decision, the state rows unchanged, empty
    energies; one launch all the same."""
    from mmla_audio_torch.vad import gmm

    x, rows = _g1_windows(3, 1, n=479)
    before = gmm.gmm_vad_windows.launches
    dec, out, e, tot = gmm.gmm_vad_windows(x.to(device), rows.to(device),
                                           with_energies=True)
    assert gmm.gmm_vad_windows.launches == before + 1
    assert dec.shape == (3, 0) and e.shape == (3, 0, 6) and tot.shape == (3, 0)
    assert torch.equal(out.cpu(), rows)


def test_g1_energies_launch_and_init(device, monkeypatch):
    """``gmm_init_from_noise`` on the card takes its energies from G1
    without the scan (``window_log_energies``, one launch over the 10 s
    clip, T = 333) and matches the CPU's within the energies' tolerance;
    no plain filterbank op runs on the card."""
    from mmla_audio_torch.vad import gmm

    noise = (np.random.RandomState(4).randn(160000) * 200).astype(np.int16)
    ref = gmm.gmm_init_from_noise(noise, device="cpu")
    monkeypatch.setattr(gmm, "band_log_energies", None)
    before = gmm.window_log_energies.launches, gmm.gmm_vad_windows.launches
    got = gmm.gmm_init_from_noise(noise, device=device)
    assert (gmm.window_log_energies.launches, gmm.gmm_vad_windows.launches) \
        == (before[0] + 1, before[1])
    for a, b in zip(got, ref):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-3)


# -- WavLM: kernel A1 and the full-width model -------------------------------

@pytest.mark.parametrize("tf32", [True, False])
@pytest.mark.parametrize("batch,T", [(1, 127), (8, 127), (64, 127), (8, 511)])
def test_a1_matches_the_reference_attention(device, batch, T, tf32):
    """A1 against the attention in float64 (``wavlm_attention_plain``):
    one TF32 pass within A1_RTOL["tf32"] of max |ref|, 3xTF32 with TF32
    off within A1_RTOL["split"]; the plain version in bf16 lies above the
    TF32 limit, so the limit tells TF32 from bf16."""
    from chip_smoke import A1_RTOL, a1_error, a1_operands
    from mmla_audio_torch.ops.cuda_attention import (wavlm_attention,
                                                     wavlm_attention_plain)

    ops = a1_operands(batch, T, device, seed=batch * T)
    ref = wavlm_attention_plain(*(o.double() if o.is_floating_point() else o
                                  for o in ops))
    before = wavlm_attention.launches
    with torch.no_grad(), fp32_policy(tf32):
        got = wavlm_attention(*ops)
    torch.cuda.synchronize()
    assert wavlm_attention.launches == before + 1
    assert got.shape == ref.shape and got.permute(0, 2, 1, 3).is_contiguous()
    assert a1_error(got, ref) <= A1_RTOL["tf32" if tf32 else "split"]
    bf16 = wavlm_attention_plain(*(o.to(torch.bfloat16)
                                   if o.is_floating_point() else o
                                   for o in ops))
    assert a1_error(bf16, ref) > A1_RTOL["tf32"]


def test_a1_refuses_what_it_does_not_take(device):
    from chip_smoke import a1_operands
    from mmla_audio_torch.ops.cuda_attention import wavlm_attention

    q, k, v, gate, bias, lens = a1_operands(2, 33, device, seed=1)
    with pytest.raises(ValueError, match="heads of 64"):
        wavlm_attention(q[..., :32], k[..., :32], v[..., :32], gate, bias,
                        lens)
    with pytest.raises(ValueError, match="lens"):
        wavlm_attention(q, k, v, gate, bias, lens.long())
    with pytest.raises(ValueError, match="share their strides"):
        wavlm_attention(q.contiguous(), k, v, gate, bias, lens)


@pytest.mark.parametrize("tf32", [True, False])
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_e1_matches_the_plain_conv_encoder(device, batch, tf32):
    """E1, each layer at full width on the float64 plain chain's input to
    it (rounded to float32), against the plain version in float64: one
    TF32 pass within E1_RTOL["tf32"] of max |ref|, 3xTF32 (TF32 off) within
    E1_RTOL["split"]; one launch a layer, in 3xTF32 only on the GEMM's
    layers with TF32 off; the plain version in bf16 above the TF32 limit."""
    from chip_smoke import (E1_RTOL, a1_error, e1_input, e1_layers,
                            e1_plain_layer)
    from mmla_audio_torch.ops.cuda_conv_encoder import wavlm_conv

    layers = e1_layers(device, seed=batch)
    h = e1_input(batch, device, seed=batch)[..., None]
    for i, layer in enumerate(layers):
        ref = e1_plain_layer(h, layer, torch.float64)
        before = wavlm_conv.launches, wavlm_conv.launches_split
        with torch.no_grad(), fp32_policy(tf32):
            got = wavlm_conv(h, *layer[:3], layer[3])
        torch.cuda.synchronize()
        assert (wavlm_conv.launches - before[0],
                wavlm_conv.launches_split - before[1]) \
            == (1, int(i > 0 and not tf32))
        assert got.is_contiguous() and got.shape == ref.shape
        assert a1_error(got, ref) <= E1_RTOL["tf32" if tf32 else "split"], i
        if tf32:
            assert a1_error(e1_plain_layer(h, layer, torch.bfloat16), ref) \
                > E1_RTOL["tf32"], i
        h = ref.float()


@pytest.mark.parametrize("c_in,c_out,k,s", [(1, 256, 10, 5), (1, 128, 3, 1),
                                            (64, 128, 3, 2), (96, 384, 2, 1),
                                            (512, 256, 5, 3)])
def test_e1_takes_other_widths_and_a_bias(device, c_in, c_out, k, s):
    """Both kernels at other widths, kernel sizes and strides, with the
    convolution's bias, against the plain version in float64, both
    precisions; a length that leaves a ragged last tile."""
    from chip_smoke import E1_RTOL, a1_error
    from mmla_audio_torch.ops.cuda_conv_encoder import (wavlm_conv,
                                                        wavlm_conv_plain)

    g = torch.Generator(device=device).manual_seed(c_in + c_out)
    x = torch.randn(3, 1001, c_in, generator=g, device=device)
    w = torch.randn(c_out, c_in, k, generator=g, device=device) \
        / (c_in * k) ** 0.5
    bias = 0.3 * torch.randn(c_out, generator=g, device=device)
    gamma = 1.0 + 0.2 * torch.randn(c_out, generator=g, device=device)
    beta = 0.1 * torch.randn(c_out, generator=g, device=device)
    ref = wavlm_conv_plain(x.double(), w.double(), gamma.double(),
                           beta.double(), s, 1e-5, bias.double())
    for tf32 in (True, False):
        with torch.no_grad(), fp32_policy(tf32):
            got = wavlm_conv(x, w, gamma, beta, s, 1e-5, bias)
        assert got.shape == ref.shape == (3, (1001 - k) // s + 1, c_out)
        assert a1_error(got, ref) <= E1_RTOL["tf32" if tf32 else "split"]


def test_e1_refuses_what_it_does_not_take(device):
    from mmla_audio_torch.ops.cuda_conv_encoder import wavlm_conv

    x = torch.randn(2, 31, 512, device=device)
    w = torch.randn(512, 512, 3, device=device)
    ln = torch.ones(512, device=device), torch.zeros(512, device=device)
    with pytest.raises(ValueError, match="multiple of 128"):
        wavlm_conv(x, w[:64], ln[0][:64], ln[1][:64], 2)
    with pytest.raises(ValueError, match="float32"):
        wavlm_conv(x.double(), w, *ln, 2)
    with pytest.raises(ValueError, match="contiguous"):
        wavlm_conv(x[:, ::2], w, *ln, 2)
    with pytest.raises(ValueError, match="packed"):
        wavlm_conv(x, w, *ln, 2, packed=w.reshape(512, -1))


def test_e1_kernels_are_tied_to_their_operator(device):
    """The profiler ties each of the encoder's seven E1 kernels to the
    ``mmla_audio::wavlm_conv`` operator that launched it, as it ties aten's
    kernels to theirs, so that the device time of a span's launches
    (``perfbench/launched.py``) counts E1."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import e1_encoder, e1_input, e1_layers

    layers = e1_layers(device)
    x = e1_input(2, device, seed=5)
    with torch.no_grad():
        e1_encoder(x, layers)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            e1_encoder(x, layers)
            torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.name == "mmla_audio::wavlm_conv"]
    kernels = [k for e in ops for k in e.kernels]
    assert len(ops) == 7
    assert len(kernels) == 7 and all("wavlm_conv" in k.name
                                     and k.duration > 0 for k in kernels)


@pytest.fixture(scope="module")
def wavlm_weights():
    from tests.test_torch_wavlm import seeded_state_dict
    from mmla_audio_torch.core.config import WavLMConfig

    return seeded_state_dict(WavLMConfig(), seed=4)


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_full_width_wavlm_matches_the_reference(device, wavlm_weights,
                                                batch):
    """WavLM Large on the card against ``tests/wavlm_reference.py`` (TF32
    off): IEEE fp32 (A1 and E1 in 3xTF32) within 1e-4 of max |ref| (sums
    in other orders through 24 layers), TF32 allowed within 2e-2 (one TF32
    pass in every product); one A1 launch a layer, one E1 launch a conv
    layer."""
    from tests import wavlm_reference as ref
    from tests.test_torch_wavlm import windows
    from mmla_audio_torch.core.config import WavLMConfig
    from mmla_audio_torch.inference import WavLMPredictor
    from mmla_audio_torch.models.wavlm import wavlm_input_batch
    from mmla_audio_torch.ops.cuda_attention import wavlm_attention
    from mmla_audio_torch.ops.cuda_conv_encoder import wavlm_conv

    cfg = WavLMConfig()
    kept = np.array([40960, 30000, 4001, 3000, 400, 399, 0, 20000]
                    * 8)[:batch]
    trimmed = windows(kept, seed=batch)
    sd = {k: v.to(device) for k, v in wavlm_weights.items()}
    want = ref.forward(sd, ref.normalize(trimmed, kept).to(device), kept,
                       cfg).cpu()
    x = wavlm_input_batch(torch.from_numpy(trimmed).to(device),
                          torch.from_numpy(kept).to(device))
    scale = want.abs().max()
    for precision, rtol in (("highest", 1e-4), (None, 2e-2)):
        pred = WavLMPredictor(sd, cfg, device=device,
                              matmul_precision=precision)
        before = wavlm_attention.launches
        e1 = wavlm_conv.launches, wavlm_conv.launches_split
        with torch.no_grad():
            got = pred.apply_model(x).cpu()
        assert wavlm_attention.launches - before == cfg.num_hidden_layers
        # E1: one launch a conv layer, 3xTF32 on the GEMM's six with TF32 off
        assert (wavlm_conv.launches - e1[0], wavlm_conv.launches_split
                - e1[1]) == (7, 6 if precision == "highest" else 0)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= rtol * scale, precision


# -- the Conformer: kernel A2 and the model -----------------------------------

@pytest.mark.parametrize("tf32", [True, False])
@pytest.mark.parametrize("batch,T", [(1, 127), (8, 127), (64, 127), (8, 511)])
def test_a2_matches_the_reference_attention(device, batch, T, tf32):
    """A2 against the attention in float64 (``conformer_attention_plain``),
    key lengths from 1 to T: one TF32 pass within A2_RTOL["tf32"] of max
    |ref|, 3xTF32 with TF32 off within A2_RTOL["split"] (A1's limits: the
    same dots at the same head size, one product more); the plain version
    in bf16 lies above the TF32 limit, so the limit tells TF32 from bf16."""
    from chip_smoke import A2_RTOL, a1_error, a2_operands
    from mmla_audio_torch.ops.cuda_conformer_attention import (
        conformer_attention, conformer_attention_plain)

    ops = a2_operands(batch, T, device, seed=batch * T)
    ref = conformer_attention_plain(*(o.double() if o.is_floating_point()
                                      else o for o in ops))
    before = conformer_attention.launches, conformer_attention.launches_split
    with torch.no_grad(), fp32_policy(tf32):
        got = conformer_attention(*ops)
    torch.cuda.synchronize()
    assert (conformer_attention.launches - before[0],
            conformer_attention.launches_split - before[1]) == (1, not tf32)
    assert got.shape == ref.shape and got.permute(0, 2, 1, 3).is_contiguous()
    assert a1_error(got, ref) <= A2_RTOL["tf32" if tf32 else "split"]
    bf16 = conformer_attention_plain(*(o.to(torch.bfloat16)
                                       if o.is_floating_point() else o
                                       for o in ops))
    assert a1_error(bf16, ref) > A2_RTOL["tf32"]


def test_a2_refuses_what_it_does_not_take(device):
    from chip_smoke import a2_operands
    from mmla_audio_torch.ops.cuda_conformer_attention import (
        conformer_attention)

    q, k, v, u, w, p, lens = a2_operands(2, 33, device, seed=1)
    with pytest.raises(ValueError, match="heads of 64"):
        conformer_attention(q[..., :32], k[..., :32], v[..., :32],
                            u[:, :32], w[:, :32], p[..., :32], lens)
    with pytest.raises(ValueError, match="lens"):
        conformer_attention(q, k, v, u, w, p, lens.long())
    with pytest.raises(ValueError, match=r"p must be contiguous"):
        conformer_attention(q, k, v, u, w, p[:, 1:], lens)
    with pytest.raises(ValueError, match="share their strides"):
        conformer_attention(q.contiguous(), k, v, u, w, p, lens)


def _conformer(device, layers: int, seed: int = 4):
    """A full-width Conformer of ``layers`` layers on the card with seeded
    weights (``chip_smoke.conformer_state_dict``), and its config."""
    import dataclasses

    from chip_smoke import conformer_state_dict
    from mmla_audio_torch.core.config import ConformerConfig

    cfg = dataclasses.replace(ConformerConfig(), num_hidden_layers=layers)
    return conformer_state_dict(cfg, device, seed=seed), cfg


@pytest.mark.parametrize("batch", [1, 8])
def test_conformer_matches_the_reference(device, batch):
    """The Conformer at full width and 4 layers on the card against
    ``tests/conformer_reference.py`` (TF32 off): IEEE fp32 (A2 and E1 in
    3xTF32) within 1e-4 of max |ref| (sums in other orders), TF32 allowed
    within 2e-2 (one TF32 pass in every product), WavLM's limits; one A2
    launch a layer, one E1 launch a conv layer, one table build."""
    from tests import conformer_reference as ref
    from tests.test_torch_wavlm import windows
    from mmla_audio_torch.inference import ConformerPredictor
    from mmla_audio_torch.models.wavlm import wavlm_input_batch
    from mmla_audio_torch.ops.cuda_conformer_attention import (
        conformer_attention)
    from mmla_audio_torch.ops.cuda_conv_encoder import wavlm_conv

    sd, cfg = _conformer(device, 4)
    kept = np.array([40960, 30000, 4001, 3000, 400, 399, 0, 20000])[:batch]
    trimmed = windows(kept, seed=batch)
    want = ref.forward(sd, ref.normalize(trimmed, kept).to(device), kept,
                       cfg).cpu()
    x = wavlm_input_batch(torch.from_numpy(trimmed).to(device),
                          torch.from_numpy(kept).to(device))
    scale = want.abs().max()
    for precision, rtol in (("highest", 1e-4), (None, 2e-2)):
        pred = ConformerPredictor(sd, cfg, device=device,
                                  matmul_precision=precision)
        a2 = conformer_attention.launches, conformer_attention.launches_split
        e1 = wavlm_conv.launches
        with torch.no_grad():
            got = pred.apply_model(x).cpu()
        assert (conformer_attention.launches - a2[0],
                conformer_attention.launches_split - a2[1]) == \
            (4, 4 if precision == "highest" else 0)
        assert wavlm_conv.launches - e1 == 7
        assert pred.model.table_builds == 1
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= rtol * scale, precision


def test_a2_kernels_are_tied_to_the_layers(device):
    """The profiler ties each of a forward's A2 kernels to the
    ``mmla_audio::conformer_attention`` operator that launched it, and the
    operators start inside ``model.layers`` (a ``model.attention`` a
    layer), so that ``layers_dev_ms.wavlm`` (``perfbench/launched.py``)
    counts A2; the conv modules' kernels tie to operators inside
    ``model.conv_module``."""
    from torch.profiler import ProfilerActivity, profile

    from mmla_audio_torch.inference import ConformerPredictor
    from mmla_audio_torch.models.wavlm import wavlm_input_batch

    sd, cfg = _conformer(device, 2, seed=6)
    pred = ConformerPredictor(sd, cfg, device=device)
    pcm = torch.from_numpy(_audio(2, 40960) * 2e4).to(device)
    x = wavlm_input_batch(pcm, torch.full((2,), 40960, dtype=torch.int32,
                                          device=device))
    with torch.no_grad():
        pred.apply_model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pred.apply_model(x)
            torch.cuda.synchronize()
    from torch.autograd import DeviceType

    events = prof.events()

    def spans(name):
        # the host's spans (a span shows on the card's timeline too)
        return [(e.time_range.start, e.time_range.end) for e in events
                if e.name == name and e.device_type == DeviceType.CPU]

    def inside(e, name):
        return any(s <= e.time_range.start <= t for s, t in spans(name))

    ops = [e for e in events if e.name == "mmla_audio::conformer_attention"]
    kernels = [k for e in ops for k in e.kernels]
    assert len(ops) == 2 and len(spans("model.attention")) == 2, \
        (len(ops), spans("model.attention"))
    assert len(kernels) == 2 and all(
        "conformer_attention_kernel" in k.name and k.duration > 0
        for k in kernels), [(k.name, k.duration) for k in kernels]
    assert all(inside(e, "model.layers") and inside(e, "model.attention")
               for e in ops), [e.time_range for e in ops]
    conv = [k for e in events if e.kernels and inside(e, "model.conv_module")
            for k in e.kernels]
    # LayerNorm, the two pointwise GEMMs and C1 a layer
    assert len(spans("model.conv_module")) == 2 and len(conv) >= 2 * 4, \
        (spans("model.conv_module"), [k.name[:60] for k in conv])


# -- the Conformer's conv module: kernel C1 -----------------------------------

@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("T", [1, 15, 127, 511])
def test_c1_matches_the_plain_version(device, T, batch):
    """C1 against the conv module's middle in float64
    (``conformer_conv_plain``) at C = 1024: fp32 FMAs within C1_RTOL of max
    |ref|, the same bits under either TF32 policy; the plain version in
    bf16 lies above the limit."""
    from chip_smoke import C1_RTOL, a1_error, c1_operands
    from mmla_audio_torch.ops.cuda_conformer_conv import (
        conformer_conv, conformer_conv_plain)

    y, taps, bias, _ = c1_operands(batch, T, device, seed=batch * T)
    ref = conformer_conv_plain(y.double(), taps.double(), bias.double())
    got = {}
    for tf32 in (True, False):
        before = conformer_conv.launches
        with torch.no_grad(), fp32_policy(tf32):
            got[tf32] = conformer_conv(y, taps, bias)
        torch.cuda.synchronize()
        assert conformer_conv.launches - before == 1
    assert torch.equal(got[True], got[False])
    assert got[True].shape == ref.shape and got[True].is_contiguous()
    assert a1_error(got[True], ref) <= C1_RTOL
    bf16 = conformer_conv_plain(y.bfloat16(), taps.bfloat16(),
                                bias.bfloat16())
    assert a1_error(bf16, ref) > C1_RTOL


def test_c1_refuses_what_it_does_not_take(device):
    """On a CUDA tensor the wrapper launches C1 or raises: another dtype, a
    non-contiguous ``y``, another kernel size, channels not in fours."""
    from chip_smoke import c1_operands
    from mmla_audio_torch.ops.cuda_conformer_conv import conformer_conv

    y, taps, bias, _ = c1_operands(2, 33, device, seed=1)
    before = conformer_conv.launches
    with pytest.raises(ValueError, match="float32"):
        conformer_conv(y.double(), taps, bias)
    with pytest.raises(ValueError, match="contiguous"):
        conformer_conv(y.transpose(0, 1).contiguous().transpose(0, 1), taps,
                       bias)
    with pytest.raises(ValueError, match="taps of 31"):
        conformer_conv(y, taps[:29].contiguous(), bias)
    with pytest.raises(ValueError, match="fours"):
        conformer_conv(y[..., :2 * 1022].contiguous(), taps[:, :1022],
                       bias[:1022])
    with pytest.raises(ValueError, match="bias"):
        conformer_conv(y, taps, bias.double())
    assert conformer_conv.launches == before


def test_c1_launches_once_a_layer(device):
    """The full-width Conformer's 24 layers launch C1 once each a forward,
    on taps each conv module folds once for every forward."""
    from mmla_audio_torch.inference import ConformerPredictor
    from mmla_audio_torch.models.wavlm import wavlm_input_batch
    from mmla_audio_torch.ops.cuda_conformer_conv import conformer_conv

    sd, cfg = _conformer(device, 24, seed=7)
    pred = ConformerPredictor(sd, cfg, device=device)
    pcm = torch.from_numpy(_audio(2, 40960) * 2e4).to(device)
    x = wavlm_input_batch(pcm, torch.tensor([40960, 9000], dtype=torch.int32,
                                            device=device))
    for _ in range(2):
        before = conformer_conv.launches
        with torch.no_grad():
            pred.apply_model(x)
        assert conformer_conv.launches - before == 24
    assert [layer.conv_module.fold_builds
            for layer in pred.model.encoder.layers] == [1] * 24


def test_c1_kernel_is_tied_to_the_conv_module(device):
    """The profiler ties each layer's C1 kernel to the
    ``mmla_audio::conformer_conv`` operator that launched it, which starts
    inside ``model.conv_module``, so that ``conv_module_dev_ms.conformer``
    (``perfbench/launched.py``) counts it; no cuDNN convolution runs there
    any more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mmla_audio_torch.inference import ConformerPredictor
    from mmla_audio_torch.models.wavlm import wavlm_input_batch

    sd, cfg = _conformer(device, 2, seed=8)
    pred = ConformerPredictor(sd, cfg, device=device)
    pcm = torch.from_numpy(_audio(2, 40960) * 2e4).to(device)
    x = wavlm_input_batch(pcm, torch.full((2,), 40960, dtype=torch.int32,
                                          device=device))
    with torch.no_grad():
        pred.apply_model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pred.apply_model(x)
            torch.cuda.synchronize()
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "model.conv_module"
             and e.device_type == DeviceType.CPU]

    def inside(e):
        return any(s <= e.time_range.start <= t for s, t in spans)

    ops = [e for e in events if e.name == "mmla_audio::conformer_conv"]
    kernels = [k for e in ops for k in e.kernels]
    assert len(ops) == 2 and len(spans) == 2 and all(map(inside, ops))
    assert len(kernels) == 2 and all(
        "conformer_conv_kernel" in k.name and k.duration > 0
        for k in kernels), [(k.name, k.duration) for k in kernels]
    conv = [k.name for e in events if e.kernels and inside(e)
            for k in e.kernels]
    assert not any("conv2d" in n or "cudnn" in n for n in conv), conv
