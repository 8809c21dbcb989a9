"""The port's MFCC front end (``mmla_audio_torch.ops.mfcc``) vs the JAX
package's ``ops.mfcc`` and vs the python_speech_features golden.

Inputs are numpy, seeded.  Against JAX: rtol 1e-5, atol 2e-4 on the 39
features (tightened from 1e-4 and 1e-3; the values reach ~60, the largest
difference seen was 6e-5: both sides are fp32 GEMMs whose sums run in
another order, and the log of a small mel energy amplifies that).  Against
the golden: the JAX suite's own rtol 1e-3, atol 2e-3
(``tests/test_mfcc.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.ops import mfcc as jax_mfcc
from mmla_audio_tpu.ops.features import (
    speaker_feature_batch as jax_feature_batch)
from mmla_audio_torch.core.config import SpeakerFeatureConfig
from mmla_audio_torch.ops import mfcc
from mmla_audio_torch.ops.features import (speaker_feature,
                                           speaker_feature_batch)
from tests.conftest import synth_speech_i16
from tests.golden import psf_ref as gold

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 2e-4
COUNTS = [40960, 30001, 4000, 400, 300]


def _signal(kind, n, seed=0):
    if kind == "zeros":        # every frame at the float64-eps clamp
        return np.zeros(n, np.float32)
    return synth_speech_i16(n, seed=seed).astype(np.float32)


def _windows(kind):
    bufs = np.zeros((len(COUNTS), 40960), np.float32)
    for i, n in enumerate(COUNTS):
        bufs[i, :n] = _signal(kind, n, seed=i)
    return bufs


def test_tables_equal_jax():
    np.testing.assert_array_equal(mfcc._psf_filterbank(26, 512, 16000),
                                  jax_mfcc._psf_filterbank(26, 512, 16000))
    np.testing.assert_array_equal(mfcc._dct2_ortho(26, 13),
                                  jax_mfcc._dct2_ortho(26, 13))
    np.testing.assert_array_equal(mfcc._lifter(13, 22),
                                  jax_mfcc._lifter(13, 22))
    for n in (0, 300, 400, 401, 561, 4000, 40960):
        assert mfcc.max_frames_for(n) == jax_mfcc.max_frames_for(n)
    n = np.array([100, 400, 401, 560, 561, 4000, 40960])
    np.testing.assert_array_equal(
        mfcc.num_valid_frames(torch.from_numpy(n)).numpy(),
        np.asarray(jax_mfcc.num_valid_frames(jnp.asarray(n))))


@pytest.mark.parametrize("kind", ["speech", "zeros"])
@pytest.mark.parametrize("n", COUNTS)
def test_mfcc13_matches_jax(n, kind):
    sig = _signal(kind, n, seed=n)
    got = mfcc.mfcc13(torch.from_numpy(sig)).numpy()
    ref = np.asarray(jax_mfcc.mfcc13(jnp.asarray(sig)))
    assert got.shape == ref.shape == (mfcc.max_frames_for(n), 13)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if kind == "zeros":        # log(float64 eps) in c0, not log(float32 eps)
        np.testing.assert_allclose(got[:, 0], np.log(2.220446e-16),
                                   rtol=1e-6)


@pytest.mark.parametrize("valid", [None, [100, 37, 1]])
def test_delta_matches_jax(valid):
    """Static edges, and each row's own edge at ``valid - 1`` (the JAX
    package vmaps the scalar form over the rows)."""
    feat = np.random.RandomState(0).randn(3, 100, 13).astype(np.float32)
    if valid is None:
        got = mfcc.delta(torch.from_numpy(feat), 2).numpy()
        ref = np.asarray(jax_mfcc.delta(jnp.asarray(feat), 2))
    else:
        got = mfcc.delta(torch.from_numpy(feat), 2,
                         valid_len=torch.tensor(valid)).numpy()
        ref = np.stack([np.asarray(jax_mfcc.delta(jnp.asarray(f), 2,
                                                  valid_len=jnp.asarray(v)))
                        for f, v in zip(feat, valid)])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["speech", "zeros"])
def test_mfcc39_matches_jax(kind):
    sig = _signal(kind, 40960, seed=3)
    got = mfcc.mfcc39(torch.from_numpy(sig)).numpy()
    ref = np.asarray(jax_mfcc.mfcc39(jnp.asarray(sig)))
    assert got.shape == ref.shape == (255, 39)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["speech", "zeros"])
def test_windowed_batch_matches_jax(kind):
    """Counts 40,960 (255 frames padded with a zero row to 256), 30,001,
    4,000, 400 and 300 (one frame) in one batch: masking, preemphasis of
    the trimmed prefix, per-row delta edges, zero rows past the count."""
    bufs = _windows(kind)
    got, valid = speaker_feature_batch(torch.from_numpy(bufs),
                                       torch.tensor(COUNTS))
    ref, ref_valid = jax_feature_batch(jnp.asarray(bufs),
                                       jnp.asarray(COUNTS))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert valid.tolist() == [255, 187, 24, 1, 1]
    assert got.shape == (5, 256, 39)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    for row, v in zip(got, valid.tolist()):
        assert not row[v:].any()


@pytest.mark.parametrize("n", [4001, 20000, 40960, 300])
def test_windowed_matches_psf_golden(n):
    """A window's features equal the golden computed on the trimmed signal
    alone (python_speech_features + the reference's delta)."""
    sig = synth_speech_i16(n, seed=n).astype(np.float64)
    buf = np.zeros(40960, np.float32)
    buf[:n] = sig
    feat, valid = speaker_feature(torch.from_numpy(buf), n)
    assert int(valid) == min(gold.mfcc(sig).shape[0], 256)
    np.testing.assert_allclose(feat.numpy(), gold.input_feature(sig),
                               rtol=1e-3, atol=2e-3)


def test_mfcc13_matches_psf_golden():
    sig = synth_speech_i16(40960, seed=1).astype(np.float64)
    got = mfcc.mfcc13(torch.from_numpy(sig.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, gold.mfcc(sig), rtol=1e-3, atol=2e-3)


def test_batched_equals_single():
    bufs = _windows("speech")
    cfg = SpeakerFeatureConfig()
    feats, valid = speaker_feature_batch(torch.from_numpy(bufs),
                                         torch.tensor(COUNTS), cfg)
    for i, n in enumerate(COUNTS):
        f1, v1 = speaker_feature(torch.from_numpy(bufs[i]), n, cfg)
        assert int(v1) == int(valid[i])
        np.testing.assert_allclose(f1.numpy(), feats[i].numpy(), rtol=1e-6,
                                   atol=1e-5)
