"""Tests that need the card: the CUDA kernels (featurizer, one window and
grouped; fused residual block) against their plain versions, the block's
dispatch rule, and the predictor on the card against the CPU.

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


@pytest.mark.parametrize("batch,n", [(1, 24000), (64, 24000), (3, 10000),
                                     (2, 40960)])
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
    (480, 150, None),   # above 3 windows per SM: the wrapper picks G=2
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
