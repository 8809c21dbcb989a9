"""The denoise's kernel wrappers on the CPU: D1 (``stft_ri``,
``istft_frames``) and D2 (``smooth_mask``) dispatch to their plain versions
for CPU tensors, so ``reduce_noise`` is bit for bit the dense-GEMM chain it
was before the kernels; the port against ``mmla_audio_tpu.ops.denoise``
pass by pass at 1, 3 and 4 passes; a batch equal to each window alone;
and numpy models of the kernels' algorithms (D1's strided frame rows, D2's
banded passes over ascending taps with the halo tiles of
``SMOOTH_TILE_T`` frames) against the plain versions.

Tolerances: the port vs JAX within 1 int16 step on <= 0.5 % of samples
(GEMM accumulation order decides round-half ties, as in
``tests/test_torch_denoise.py``); the numpy models in float64 within 1e-5
of max |ref| (D1) and 1e-6 (D2, mask values in [0, 1]).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmla_audio_tpu.ops import denoise as jax_denoise
from mmla_audio_torch.core.config import DenoiseConfig
from mmla_audio_torch.ops import denoise
from mmla_audio_torch.ops.cuda_denoise import SMOOTH_TILE_T
from mmla_audio_torch.ops.spectral import frame_signal, pad_last
from tests.conftest import synth_speech_i16

torch.set_num_threads(1)

CFG = DenoiseConfig()


def _dense_reduce_noise(y, nt, cfg=CFG, sr=16000, passes=1):
    """``reduce_noise`` as the port wrote it before D1 and D2: framed
    GEMMs against the bases and the dense banded smoothing matrices."""
    n = y.shape[-1]
    pad = denoise._chunk_pad(cfg, sr)
    for pass_idx in range(passes):
        if pass_idx > 0:
            y = denoise.quantize_i16(y) / 32768.0
        yp = F.pad(y, (pad, pad))
        nf, hop = cfg.n_fft, cfg.hop_length
        frames = frame_signal(pad_last(yp, nf // 2, nf // 2, "reflect"), nf,
                              hop, 1 + yp.shape[-1] // hop)
        fc, fs, ic_t, is_t, w = denoise._bases(nf, y.device)
        re, im = torch.matmul(frames, fc), torch.matmul(frames, fs)
        mask = denoise.gate_mask(re, im, nt, cfg.prop_decrease)
        mf, mt_t = denoise._smoothing_matrices(cfg, sr, mask.shape[-1],
                                               mask.shape[-2], y.device)
        mask = torch.matmul(mt_t, torch.matmul(mask, mf))
        re, im = re * mask, im * mask
        T = re.shape[-2]
        fr = (torch.matmul(re, ic_t) - torch.matmul(im, is_t)) * w
        lead = fr.shape[:-2]
        total = nf + (T - 1) * hop
        out = F.fold(fr.reshape(-1, T, nf).transpose(1, 2),
                     output_size=(1, total), kernel_size=(1, nf),
                     stride=(1, hop)).reshape(lead + (total,))
        out = out / denoise._inv_window_sum(nf, hop, T, y.device)
        y = out[..., nf // 2: nf // 2 + yp.shape[-1]][..., pad: pad + n]
    return y


def _windows(batch, n=40960, seed=0):
    rng = np.random.RandomState(seed)
    y = np.stack([synth_speech_i16(n, seed=seed + b) for b in range(batch)])
    y = y.astype(np.float32) * rng.uniform(0.05, 1.0, (batch, 1))
    return ((y + rng.randn(batch, n) * 30) / 32768.0).astype(np.float32)


@pytest.fixture(scope="module")
def profile():
    noise = (np.random.RandomState(3).randn(160000) * 20).astype(np.float32)
    return denoise.noise_threshold(torch.from_numpy(noise / 32768.0))


@pytest.mark.parametrize("passes", [1, 3])
def test_plain_versions_equal_the_dense_chain(profile, passes):
    y = torch.from_numpy(_windows(2, n=20000, seed=passes))
    got = denoise.reduce_noise(y, profile, passes=passes)
    assert torch.equal(got, _dense_reduce_noise(y, profile, passes=passes))
    assert torch.equal(denoise.reduce_noise_plain(y, profile, passes=passes),
                       got)


@pytest.mark.parametrize("passes", [1, 3, 4])
def test_reduce_noise_matches_jax(profile, passes):
    """Every pass of the chain against JAX's from the same input (the
    port's previous pass, quantized as the chain quantizes between passes),
    and the chain equal to those passes run one at a time.  The gate's
    threshold test turns a one-step difference left by one pass into a
    flipped mask bin of the next, so the two packages' chains are held
    pass by pass, not end to end."""
    y = torch.from_numpy(_windows(1, seed=10 + passes)[0])
    nt = profile.numpy()
    x = y
    for _ in range(passes):
        got = denoise.reduce_noise(x, profile)
        ref = jax_denoise.reduce_noise(jnp.asarray(x.numpy()),
                                       jnp.asarray(nt))
        diff = np.abs(denoise.quantize_i16(got).numpy()
                      - np.asarray(jax_denoise.quantize_i16(ref)))
        assert diff.max() <= 1.0
        assert (diff > 0).mean() <= 0.005
        x = denoise.quantize_i16(got) / 32768.0
    assert torch.equal(denoise.quantize_i16(
        denoise.reduce_noise(y, profile, passes=passes)) / 32768.0, x)


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batch_equals_each_window_alone(profile, batch):
    y = torch.from_numpy(_windows(batch, seed=20 + batch))
    got = denoise.reduce_noise(y, profile)
    for b in range(batch):
        assert torch.equal(denoise.reduce_noise(y[b], profile), got[b])


def test_cpu_tensors_never_launch(profile):
    before = (denoise.stft_ri.launches, denoise.istft_frames.launches,
              denoise.smooth_mask.launches)
    denoise.reduce_noise(torch.from_numpy(_windows(2, n=8000)), profile,
                         passes=2)
    denoise.noise_threshold(torch.zeros(8000))
    assert (denoise.stft_ri.launches, denoise.istft_frames.launches,
            denoise.smooth_mask.launches) == before


def test_wrappers_refuse_other_devices():
    y = torch.zeros(4000, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        denoise.stft_ri(y, 1024, 256)
    with pytest.raises(ValueError, match="unsupported device"):
        denoise.smooth_mask(torch.zeros((3, 513), device="meta"), CFG, 16000)


@pytest.mark.parametrize("batch,n", [(1, 5000), (3, 3001)])
def test_d1_frame_rows_model(batch, n):
    """D1's STFT reads row ``m`` of A at ``(m // T) * (n + n_fft) + (m % T)
    * hop`` of the reflect-padded signal against ``[fwd_cos | fwd_sin]``;
    its ISTFT takes ``[re | im]`` against ``[inv_cos.T; -inv_sin.T]``."""
    nf, hop = 1024, 256
    y = torch.from_numpy(_windows(batch, n=n, seed=5))
    yr = F.pad(y, (nf // 2, nf // 2), mode="reflect").numpy()
    T = 1 + n // hop
    flat = yr.ravel().astype(np.float64)
    m = np.arange(batch * T)
    starts = (m // T) * yr.shape[1] + (m % T) * hop
    A = flat[starts[:, None] + np.arange(nf)[None]]
    fwd, inv = (b.numpy().astype(np.float64)
                for b in denoise._kernel_bases(nf, torch.device("cpu")))
    spec = (A @ fwd).reshape(batch, T, -1)
    re, im = denoise.stft_ri_plain(y, nf, hop)
    K = nf // 2 + 1
    for got, ref in ((spec[..., :K], re), (spec[..., K:], im)):
        assert np.abs(got - ref.numpy()).max() <= 1e-5 * ref.abs().max()
    frames = np.concatenate([re.numpy(), im.numpy()], -1).astype(
        np.float64) @ inv
    ref = denoise.istft_frames_plain(re, im, nf).numpy()
    assert np.abs(frames - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("frames", [1, 7, 183])
def test_d2_banded_passes_model(frames):
    """D2 as the kernel computes it: per tile of ``SMOOTH_TILE_T`` frames
    and ``len(v_t) - 1`` halo frames (zero outside the window), the
    frequency band then the time band, each over ascending taps."""
    mask = np.random.RandomState(frames).rand(2, frames, 513).astype(
        np.float32)
    v_f, v_t = (v.numpy().astype(np.float64) for v in
                denoise._smoothing_taps(CFG, 16000, torch.device("cpu")))
    cf, ct = len(v_f) // 2, len(v_t) // 2
    out = np.zeros(mask.shape)
    for g in range(2):
        for t0 in range(0, frames, SMOOTH_TILE_T):
            rows = SMOOTH_TILE_T + 2 * ct
            tile = np.zeros((rows, 513))
            for r in range(rows):
                if 0 <= t0 - ct + r < frames:
                    tile[r] = mask[g, t0 - ct + r]
            padded = np.pad(tile, ((0, 0), (cf, cf)))
            fr = np.zeros_like(tile)
            for d in range(len(v_f)):
                # x[j + cf - d] sits at padded column j + 2 cf - d
                fr += v_f[d] * padded[:, 2 * cf - d: 2 * cf - d + 513]
            for r in range(min(SMOOTH_TILE_T, frames - t0)):
                out[g, t0 + r] = sum(v_t[d] * fr[r + 2 * ct - d]
                                     for d in range(len(v_t)))
    ref = denoise.smooth_mask_plain(torch.from_numpy(mask), CFG, 16000)
    assert np.abs(out - ref.numpy()).max() <= 1e-6
