"""Port featurizer (plain PyTorch version of the CUDA kernel) vs the JAX
featurizer and the JAX Pallas kernel (interpret mode on the CPU).

Budget, as tests/test_pallas_features.py: |diff| <= 1 quantization step, on
< 2 % of pixels — float-boundary pixels under floor() flip either way.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.ops.features import overlap_model_input
from mmla_audio_tpu.ops.pallas_features import overlap_model_input_pallas
from mmla_audio_torch.core.config import OverlapFeatureConfig
from mmla_audio_torch.ops import cuda_features, features, spectral
from tests.conftest import synth_speech

torch.set_num_threads(1)


def _assert_budget(got, ref):
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert (diff <= 1.0).all()
    assert (diff > 0).mean() < 0.02


@pytest.fixture(scope="module")
def windows():
    """B=3 full windows and one 10,000-sample window (the zero-pad path)."""
    return (np.stack([synth_speech(24000, seed=s) for s in range(3)]),
            synth_speech(10000, seed=9))


@pytest.mark.parametrize("case", ["batch", "short"])
def test_plain_matches_jax(windows, case):
    y = windows[0] if case == "batch" else windows[1]
    got = features.overlap_model_input(torch.from_numpy(y)).numpy()
    ref = np.asarray(overlap_model_input(jnp.asarray(y)))
    assert got.shape == ((3,) if case == "batch" else ()) + (128, 151, 3)
    _assert_budget(got, ref)


def test_plain_matches_pallas_interpret(windows):
    ys = np.concatenate([windows[0], np.pad(windows[1], (0, 14000))[None]])
    got = features.overlap_model_input(torch.from_numpy(ys)).numpy()
    ref = np.asarray(overlap_model_input_pallas(jnp.asarray(ys)))
    _assert_budget(got, ref)


def test_spectral_pieces_match_jax(windows):
    from mmla_audio_tpu.ops import spectral as jspec

    y = windows[0]
    zcr = spectral.zero_crossing_rate(torch.from_numpy(y), 400, 160).numpy()
    np.testing.assert_array_equal(
        zcr, np.asarray(jspec.zero_crossing_rate(jnp.asarray(y), 400, 160)))
    np.testing.assert_array_equal(spectral.mel_filterbank(16000, 400, 128),
                                  jspec.mel_filterbank(16000, 400, 128))
    mel = spectral.melspectrogram_power(torch.from_numpy(y), 16000, 400, 160,
                                        128).numpy()
    ref = np.asarray(jspec.melspectrogram_power(jnp.asarray(y), 16000, 400,
                                                160, 128))
    np.testing.assert_allclose(mel, ref, rtol=1e-4, atol=1e-6 * ref.max())


def test_wrapper_takes_plain_path_on_cpu(windows):
    y = torch.from_numpy(windows[0])
    before = cuda_features.overlap_model_input_cuda.launches
    got = cuda_features.overlap_model_input_cuda(y)
    assert cuda_features.overlap_model_input_cuda.launches == before == 0
    np.testing.assert_array_equal(got.numpy(),
                                  features.overlap_model_input(y).numpy())


@pytest.mark.parametrize("field", ["png_quantize", "flip_mel_axis"])
def test_wrapper_refuses_non_default_config(windows, field):
    cfg = dataclasses.replace(OverlapFeatureConfig(), **{field: False})
    with pytest.raises(ValueError, match="requires png_quantize=True"):
        cuda_features.overlap_model_input_cuda(torch.from_numpy(windows[1]),
                                               cfg)


@pytest.mark.parametrize("case", ["partial_group", "frames_multiple_of_8"])
def test_grouped_matches_pallas_grouped(case):
    """The wrapper with ``group`` (its plain version on the CPU) against the
    grouped Pallas kernel: 6 windows with group 4 (a partial last group),
    and time_dim=151 with group 2 (152 frames, which the TPU kernel must not
    duplicate)."""
    if case == "partial_group":
        cfg, batch, group, seed = OverlapFeatureConfig(), 6, 4, 40
    else:
        cfg, batch, group, seed = OverlapFeatureConfig(time_dim=151), 4, 2, 60
    ys = np.stack([synth_speech(cfg.n_samples, seed=seed + s)
                   for s in range(batch)])
    got = cuda_features.overlap_model_input_cuda(torch.from_numpy(ys), cfg,
                                                 group=group).numpy()
    from mmla_audio_tpu.core.config import OverlapFeatureConfig as JaxCfg

    ref = np.asarray(overlap_model_input_pallas(
        jnp.asarray(ys), JaxCfg(time_dim=cfg.time_dim), group=group))
    assert got.shape == (batch, 128, cfg.n_frames, 3)
    _assert_budget(got, ref)


@pytest.mark.parametrize("group", [3, 8])
def test_wrapper_refuses_unbuilt_group(windows, group):
    with pytest.raises(ValueError, match="group must be one of"):
        cuda_features.overlap_model_input_cuda(torch.from_numpy(windows[1]),
                                               group=group)
