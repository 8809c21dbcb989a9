"""The denoise's kernel wrappers on the CPU: D1 (``stft_ri``,
``istft_frames``) and D2 (``smooth_mask``) dispatch to their plain versions
for CPU tensors, so ``reduce_noise`` is bit for bit the dense-GEMM chain it
was before the kernels; the port against ``mmla_audio_tpu.ops.denoise``
pass by pass at 1, 3 and 4 passes; a batch equal to each window alone;
and numpy models of the kernels' algorithms (D1's strided, windowed frame
rows through its FFT plan: the float64 twiddle table the wrapper hands the
kernel, three radix-8 Stockham stages and the real split, in float64 with
each output rounded once to float32; D2's streaming passes, strip by
strip and bin tile by bin tile with their halos, through a register ring
of time-band rows, each output over ascending taps) against numpy's
float64 FFT and the plain versions.

Tolerances: the port vs JAX within 1 int16 step on <= 0.5 % of samples
(GEMM accumulation order decides round-half ties, as in
``tests/test_torch_denoise.py``); D1's model within 1e-7 of max |ref| of
numpy's float64 FFT (one rounding to float32 is at most 2^-24 of it) and
within 1e-5 of the plain float32 products (whose sums err near 1e-6 of the
max); D2's model within 1e-6 of the dense pair (mask values in [0, 1]),
and bit for bit equal under every grid it is given.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmla_audio_tpu.ops import denoise as jax_denoise
from mmla_audio_torch.core.config import DenoiseConfig
from mmla_audio_torch.ops import denoise
from mmla_audio_torch.ops.cuda_denoise import (SMOOTH_BINS_PER_THREAD,
                                               SMOOTH_MAX_TILE, smooth_plan)
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


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_chain_in_float64(profile, seed):
    """The plain chain keeps a float64 input in float64 end to end (the
    exact chain the card's denoise is held to), at 1 pass and at 3: its
    STFT and inverse frames equal numpy's float64 FFT within 1e-12 of max
    |ref|, and one pass's int16 output is within 1 step on < 0.5 % of
    samples of the float32 chain's (over several passes the two drift
    apart, as the port and JAX do: see ``test_reduce_noise_matches_jax``)."""
    y = torch.from_numpy(_windows(2, n=20000, seed=seed))
    assert denoise.reduce_noise_plain(y.double(), profile.double(),
                                      passes=3).dtype == torch.float64
    got = denoise.reduce_noise_plain(y.double(), profile.double())
    assert got.dtype == torch.float64
    diff = (denoise.quantize_i16(got)
            - denoise.quantize_i16(denoise.reduce_noise_plain(
                y, profile))).abs()
    assert float(diff.max()) <= 1.0 and float((diff > 0).float().mean()) \
        < 0.005
    x = y.double()
    re, im = denoise.stft_ri_plain(x, 1024, 256)
    frames = frame_signal(pad_last(x, 512, 512, "reflect"), 1024, 256,
                          re.shape[-2]).numpy()
    exact = np.fft.rfft(frames * denoise._window(
        1024, torch.device("cpu"), torch.float64).numpy(), axis=-1)
    for got, ref in ((re, exact.real), (im, exact.imag)):
        assert got.dtype == torch.float64
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    back = denoise.istft_frames_plain(re, im, 1024).numpy()
    ref = np.fft.irfft(exact, n=1024, axis=-1)
    assert np.abs(back - ref).max() <= 1e-12 * np.abs(ref).max()


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


def _dft8(vr, vi, c):
    """The kernel's 8-point DFT: a radix-2 split (the differences times
    W8^r), then two 4-point DFTs giving the even and the odd outputs."""
    def dft4(u):
        (u0r, u0i), (u1r, u1i), (u2r, u2i), (u3r, u3i) = u
        p0, p1 = (u0r + u2r, u0i + u2i), (u0r - u2r, u0i - u2i)
        q0, t = (u1r + u3r, u1i + u3i), (u1r - u3r, u1i - u3i)
        q1 = (t[1], -t[0])
        return [(p0[0] + q0[0], p0[1] + q0[1]), (p1[0] + q1[0], p1[1] + q1[1]),
                (p0[0] - q0[0], p0[1] - q0[1]), (p1[0] - q1[0], p1[1] - q1[1])]
    a = [(vr[r] + vr[r + 4], vi[r] + vi[r + 4]) for r in range(4)]
    d = [(vr[r] - vr[r + 4], vi[r] - vi[r + 4]) for r in range(4)]
    b = [d[0], (c * (d[1][0] + d[1][1]), c * (d[1][1] - d[1][0])),
         (d[2][1], -d[2][0]),
         (c * (d[3][1] - d[3][0]), -(c * (d[3][0] + d[3][1])))]
    out = [None] * 8
    out[0::2], out[1::2] = dft4(a), dft4(b)
    return [o[0] for o in out], [o[1] for o in out]


def _fft512_model(zr, zi, tw):
    """D1's 512-point FFT of the rows of ``(zr, zi)`` as the kernel runs it:
    Stockham, radix 8, butterfly j of stage Ns reading j + 64 r, twiddled
    by table entry ``2 r (j mod Ns) 512 / (8 Ns)``, writing output q at
    ``(j // Ns) 8 Ns + j mod Ns + q Ns``."""
    c, j = tw[128, 0], np.arange(64)
    for stage, ns in enumerate((1, 8, 64)):
        vr = [zr[:, j + 64 * r] for r in range(8)]
        vi = [zi[:, j + 64 * r] for r in range(8)]
        if stage:
            for r in range(1, 8):
                w = tw[2 * r * (j % ns) * (512 // (8 * ns))]
                vr[r], vi[r] = (vr[r] * w[:, 0] - vi[r] * w[:, 1],
                                vr[r] * w[:, 1] + vi[r] * w[:, 0])
        vr, vi = _dft8(vr, vi, c)
        base = (j // ns) * 8 * ns + j % ns
        zr, zi = np.empty_like(zr), np.empty_like(zi)
        for q in range(8):
            zr[:, base + q * ns], zi[:, base + q * ns] = vr[q], vi[q]
    return zr, zi


def _rfft_model(frames, tw):
    """The forward kernel on windowed frames ``(F, 1024)`` (float64): z =
    even + i odd, the FFT, then X[k] = E[k] + W^k O[k], rounded to
    float32."""
    zr, zi = _fft512_model(frames[:, 0::2], frames[:, 1::2], tw)
    k = np.arange(512)
    ar, ai = zr[:, k], zi[:, k]
    br, bi = zr[:, (512 - k) & 511], zi[:, (512 - k) & 511]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    o_r, o_i = 0.5 * (ai + bi), 0.5 * (br - ar)
    w = tw[k]
    re = np.concatenate([er + (o_r * w[:, 0] - o_i * w[:, 1]),
                         (zr[:, :1] - zi[:, :1])], axis=1)
    im = np.concatenate([ei + (o_r * w[:, 1] + o_i * w[:, 0]),
                         np.zeros_like(zr[:, :1])], axis=1)
    return re.astype(np.float32), im.astype(np.float32)


def _irfft_model(re, im, tw):
    """The inverse kernel on float32 ``(F, 513)`` spectra, in float64:
    Z'[k] = (X[k] + conj X[512-k]) + i W^-k (X[k] - conj X[512-k])
    (imaginary parts at DC and Nyquist ignored), x = conj(FFT(conj Z')) /
    1024 interleaved, rounded to float32."""
    re, im = re.astype(np.float64), im.astype(np.float64)
    im[:, [0, 512]] = 0
    k = np.arange(512)
    ar, ai, br, bi = re[:, k], im[:, k], re[:, 512 - k], im[:, 512 - k]
    er, ei, dr, di = ar + br, ai - bi, ar - br, ai + bi
    w = tw[k]
    o_r, o_i = dr * w[:, 0] + di * w[:, 1], di * w[:, 0] - dr * w[:, 1]
    vr, vi = _fft512_model(er - o_i, -(ei + o_r), tw)
    out = np.empty((len(re), 1024), np.float32)
    out[:, 0::2] = vr * (1 / 1024)
    out[:, 1::2] = -vi * (1 / 1024)
    return out


@pytest.mark.parametrize("batch,n", [(1, 5000), (3, 3001)])
def test_d1_frame_rows_model(batch, n):
    """D1's FFT plan on the CPU: the STFT reads frame ``m`` from row ``m
    // T`` of the signal at samples ``(m % T) * hop - n_fft / 2 + s``,
    reflected at both ends, windowed as it is loaded; the float64 model of
    both kernels from the wrapper's twiddle table, each output rounded to
    float32, against numpy's float64 FFT and the plain versions."""
    nf, hop = 1024, 256
    y = torch.from_numpy(_windows(batch, n=n, seed=5))
    T = 1 + n // hop
    m = np.arange(batch * T)
    i = ((m % T) * hop - nf // 2)[:, None] + np.arange(nf)[None]
    i = np.where(i < 0, -i, np.where(i >= n, 2 * (n - 1) - i, i))
    frames = y.numpy()[(m // T)[:, None], i]
    window = denoise._window(nf, torch.device("cpu")).numpy()
    tw = denoise._fft_table(nf)
    assert tw.dtype == np.float64 and tw.shape == (nf, 2)
    windowed = frames.astype(np.float64) * window.astype(np.float64)
    re, im = _rfft_model(windowed, tw)
    exact = np.fft.rfft(windowed, axis=-1)
    pre, pim = denoise.stft_ri_plain(y, nf, hop)
    for got, ref, plain in ((re, exact.real, pre), (im, exact.imag, pim)):
        scale = np.abs(ref).max()
        assert got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-7 * scale
        assert np.abs(got - plain.numpy().reshape(got.shape)).max() <= \
            1e-5 * scale
    re, im = pre.numpy().reshape(-1, nf // 2 + 1), \
        pim.numpy().reshape(-1, nf // 2 + 1)
    frames = _irfft_model(re, im, tw)
    exact = np.fft.irfft(re.astype(np.float64) + 1j * im, n=nf, axis=-1)
    plain = denoise.istft_frames_plain(pre, pim, nf).numpy().reshape(
        frames.shape)
    scale = np.abs(exact).max()
    assert np.abs(frames - exact).max() <= 1e-7 * scale
    assert np.abs(frames - plain).max() <= 1e-5 * scale


def test_d1_refuses_other_fft_sizes():
    """The card's D1 serves n_fft 1024 alone (the wrappers check the size
    before any launch); the CPU's plain versions take any size."""
    for n_fft in (512, 2048):
        with pytest.raises(ValueError, match="built for n_fft 1024"):
            denoise._fft_size(n_fft, "stft_ri")
    denoise._fft_size(1024, "stft_ri")
    re, im = denoise.stft_ri(torch.zeros(3000), 512, 128)
    assert re.shape == im.shape == (24, 257)


def _fma(a, b, c):
    """fmaf(a, b, c) on float32 operands: the product is exact in float64,
    then one sum rounded to float64 and to float32."""
    return (np.float64(a) * b.astype(np.float64) + c).astype(np.float32)


def _d2_stream_model(mask, v_f, v_t, strip, tile):
    """``smooth_mask_stream_kernel`` on ``(G, T, K)`` float32: block (strip
    of frames, tile of bins) at a time, input rows t0 - ct ... t0 + n_out +
    ct - 1 staged with a halo of cf bins a side (zeros outside [0, K)), the
    frequency pass of each row into slot i % nt of the threads' register
    rings (6 bins a thread, side by side), the time pass once the ring is
    full; each output over ascending taps."""
    G, T, K = mask.shape
    nf, nt = len(v_f), len(v_t)
    cf, ct, r = nf // 2, nt // 2, SMOOTH_BINS_PER_THREAD
    width = tile + 2 * cf
    out = np.full(mask.shape, np.nan, np.float32)
    for g in range(G):
        for t0 in range(0, T, strip):
            n_out = min(strip, T - t0)
            for k0 in range(0, K, tile):
                n_tile = min(tile, K - k0)
                bins = -(-n_tile // r) * r          # the active threads'
                lo, hi = max(k0 - cf, 0), min(k0 + tile + cf, K)
                ring = np.zeros((nt, bins), np.float32)
                for i in range(n_out + 2 * ct):
                    t = t0 - ct + i
                    ring[i % nt] = 0
                    if 0 <= t < T:
                        stage = np.zeros(width, np.float32)
                        stage[lo - k0 + cf: hi - k0 + cf] = mask[g, t, lo:hi]
                        s = np.zeros(bins, np.float32)
                        for d in range(nf):       # bin j + cf - d
                            s = _fma(v_f[d], stage[2 * cf - d:
                                                   2 * cf - d + bins], s)
                        ring[i % nt] = s
                    if i >= 2 * ct:
                        s = np.zeros(bins, np.float32)
                        for d in range(nt):       # row i - d
                            s = _fma(v_t[d], ring[(i - d) % nt], s)
                        out[g, t - ct, k0: k0 + n_tile] = s[:n_tile]
    return out


OTHER_SMOOTHING = DenoiseConfig(freq_mask_smooth_hz=300.0,
                                time_mask_smooth_ms=100.0)


@pytest.mark.parametrize("frames,cfg", [
    (1, CFG), (6, CFG), (7, CFG), (64, CFG), (65, CFG), (183, CFG),
    (1000, CFG), (183, OTHER_SMOOTHING)])
def test_d2_banded_passes_model(frames, cfg):
    """D2 as the kernel computes it, 3 windows a mask, under the plan of
    the batch, the plans of each window alone, one strip of 64 frames over
    whole rows and strips of 8 over three bin tiles of 192 with their
    halos: the same bits under every grid (each output's
    sequence of operations depends on the taps alone), within 1e-6 of the
    dense pair.  ``OTHER_SMOOTHING`` has (19, 13) taps, which the card runs
    through the generic kernel in the same order."""
    mask = np.random.RandomState(frames).rand(3, frames, 513).astype(
        np.float32)
    v_f, v_t = (v.numpy() for v in
                denoise._smoothing_taps(cfg, 16000, torch.device("cpu")))
    if cfg is OTHER_SMOOTHING:
        assert (len(v_f), len(v_t)) == (19, 13)
    out = _d2_stream_model(mask, v_f, v_t, *smooth_plan(3, frames, 513))
    assert not np.isnan(out).any()
    alone = np.concatenate([
        _d2_stream_model(mask[g:g + 1], v_f, v_t,
                         *smooth_plan(1, frames, 513)) for g in range(3)])
    whole = _d2_stream_model(mask, v_f, v_t, 64, 516)
    split = _d2_stream_model(mask, v_f, v_t, 8, 192)   # 3 bin tiles
    assert np.array_equal(out, alone) and np.array_equal(out, whole)
    assert np.array_equal(out, split)
    ref = denoise.smooth_mask_plain(torch.from_numpy(mask), cfg, 16000)
    assert np.abs(out - ref.numpy()).max() <= 1e-6


@pytest.mark.parametrize("groups,frames,bins", [
    (1, 183, 513), (8, 183, 513), (64, 183, 513), (512, 183, 513),
    (1, 45023, 513), (3, 1, 513), (1, 183, 2049), (2, 50, 7)])
def test_d2_plan(groups, frames, bins):
    """``smooth_plan``: tiles of whole threads' bins within the block's
    limit that cover every bin, strips of 4 to 64 frames, and a grid that
    fills the SMs wherever the mask allows (the single live window runs on
    46 blocks, not the 3 of a 64-frame strip)."""
    strip, tile = smooth_plan(groups, frames, bins)
    assert tile % SMOOTH_BINS_PER_THREAD == 0 and tile <= SMOOTH_MAX_TILE
    assert -(-bins // tile) * tile >= bins and strip in (4, 8, 16, 32, 64)
    tiles = -(-bins // tile)
    assert tiles == -(-bins // SMOOTH_MAX_TILE)
    blocks = groups * -(-frames // strip) * tiles
    if groups * frames >= 528 * 64:
        assert strip == 64
    elif (groups, frames, bins) == (1, 183, 513):
        assert (strip, tile, blocks) == (4, 516, 46)
    assert blocks >= min(528, groups * -(-frames // 4) * tiles)
    if strip < 64:      # a strip twice as long would not fill the card
        assert groups * -(-frames // (2 * strip)) * tiles < 528
