"""The featurizer kernel's algorithm on the CPU: its tables
(``cuda_features.feature_tables``), a numpy model of its radix plan held
against the dense DFT and of the whole kernel held against the JAX
featurizer; the window-length rule; and the port's device defaults.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
these tests pin what it computes: the FFT stages, the split step, the
banded mel product and the one-pass epilogue.
"""

import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.ops.features import overlap_model_input as jax_features
from mmla_audio_torch import cli
from mmla_audio_torch.core.config import OverlapFeatureConfig
from mmla_audio_torch.data.standardize import standardize_audio
from mmla_audio_torch.inference import OverlapPredictor, SpeakerPredictor
from mmla_audio_torch.ops import cuda_features
from mmla_audio_torch.ops.spectral import _dft_basis, mel_filterbank
from mmla_audio_torch.streaming.session import StreamingSession
from tests.conftest import synth_speech

# sample rates whose 25 ms window halves into each radix the kernel has
GEOMETRIES = {16000: (5, 5, 8), 8000: (5, 5, 4), 24000: (3, 5, 5, 4),
              12800: (5, 4, 8), 4000: (5, 5, 2)}
WRITTEN_OUT = (2, 3, 4, 5, 8)   # radices with a hand-written butterfly
# windows whose half has a prime factor without one: the generic stage
GENERIC_WINDOWS = {"sr14000": (dict(sample_rate=14000), (5, 5, 7)),  # 350
                   "win25.5": (dict(win_ms=25.5), (3, 17, 4)),       # 408
                   "sr22000": (dict(sample_rate=22000), (5, 5, 11))}  # 550


def _frames(y, cfg):
    """Reflect-padded frames ``(B, T, win)`` of ``y (B, n)``, float64."""
    half = cfg.win_length // 2
    yp = np.pad(y.astype(np.float64), ((0, 0), (half, half)), mode="reflect")
    idx = (np.arange(cfg.n_frames)[:, None] * cfg.hop_length
           + np.arange(cfg.win_length))
    return yp[:, idx]


def fft_model(frames, tab, dtype):
    """The kernel's spectrum in numpy: window, pack z = x[2p] + i x[2p+1],
    Stockham stages of ``tab.radices`` with the table's twiddles, split into
    bins 0..n2, power.  A written-out radix's R-point DFT is a dense product
    here (the kernel writes it out by hand); any other radix takes each
    output's combined twiddle from the table, as the kernel's generic stage
    does."""
    ctype = np.complex128 if dtype == np.float64 else np.complex64
    win = frames.shape[-1]
    n2 = win // 2
    tw = (tab.twiddle[:, 0] + 1j * tab.twiddle[:, 1]).astype(ctype)
    x = frames.astype(dtype) * tab.window.astype(dtype)
    z = (x[..., 0::2] + 1j * x[..., 1::2]).astype(ctype)
    p = 1
    for R in tab.radices:
        S, tstep = n2 // R, win // (p * R)
        out = np.empty_like(z)
        i = np.arange(S)
        k = i % p
        a = np.stack([z[..., i + r * S] for r in range(R)], axis=-1)
        if R in WRITTEN_OUT:
            dft = np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R))
                         / R).astype(ctype)
            A = (a * tw[np.outer(k, np.arange(R)) * tstep]) @ dft.T
        else:
            q = np.arange(R)
            A = np.stack([(a * tw[(q * (k[:, None] + s * p) * tstep) % win]
                           ).sum(-1) for s in range(R)], axis=-1)
        j = (i - k) * R + k
        for r in range(R):
            out[..., j + r * p] = A[..., r]
        z, p = out, p * R
    k = np.arange(n2 + 1)
    a, b = z[..., k % n2], np.conj(z[..., (n2 - k) % n2])
    X = (a + b) / 2 + tw[k] * (a - b) / 2j
    return (X.real ** 2 + X.imag ** 2).astype(dtype)


def banded_mel(power, tab):
    """Each mel row (image order) summed over its band, ascending bins,
    float32, as the kernel does."""
    M = tab.mel_first.shape[0]
    acc = np.zeros(power.shape[:-1] + (M,), np.float32)
    for j in range(tab.mel_weight.shape[0]):
        live = j < tab.mel_count
        bins = np.where(live, tab.mel_first + j, 0)
        acc = np.where(live, acc + power[..., bins] * tab.mel_weight[j], acc)
    return acc


def kernel_model(y, cfg):
    """The whole kernel in float32 numpy: ``(B, M, T, 3)`` 0..255."""
    tab = cuda_features.feature_tables(cfg)
    f32 = np.float32
    mel = banded_mel(fft_model(_frames(y, cfg), tab, f32), tab)
    L = (f32(10) * np.log10(np.maximum(mel, f32(1e-10)))
         ).transpose(0, 2, 1)                            # (B, M, T)
    ref = mel.max(axis=(1, 2), keepdims=True)
    ref_db = f32(10) * np.log10(np.maximum(ref, f32(1e-10)))
    hi = L.max(axis=(1, 2), keepdims=True) - ref_db
    floor_db = hi - f32(80)
    lo = np.maximum(L.min(axis=(1, 2), keepdims=True) - ref_db, floor_db)
    d = np.maximum(L - ref_db, floor_db)
    diff = hi - lo
    norm = np.where(diff > 0, (d - lo) / np.where(diff > 0, diff, 1), 0)
    gb = np.floor(np.clip(f32(1) - norm, 0, 1) * f32(255))
    half = cfg.win_length // 2
    ye = np.pad(y, ((0, 0), (half, half)), mode="edge")
    idx = (np.arange(cfg.n_frames)[:, None] * cfg.hop_length
           + np.arange(cfg.win_length))
    neg = ye[:, idx] < -1e-10
    zcr = (neg[..., 1:] != neg[..., :-1]).sum(-1).astype(f32) / \
        f32(cfg.win_length)
    r = np.broadcast_to(np.floor(np.clip(zcr, 0, 1) * f32(255))[:, None, :],
                        gb.shape)
    return np.stack([r, gb, gb], axis=-1).astype(f32)


@pytest.mark.parametrize("sr", sorted(GEOMETRIES))
def test_fft_radices(sr):
    cfg = OverlapFeatureConfig(sample_rate=sr)
    assert cuda_features.fft_radices(cfg.win_length // 2) == GEOMETRIES[sr]
    assert cuda_features.feature_tables(cfg).radices == GEOMETRIES[sr]


@pytest.mark.parametrize("fmax", [None, 6000.0])
def test_banded_mel_equals_dense(fmax):
    """The band sum equals the dense sum over every bin, in the same order,
    bit for bit: the skipped weights are exactly 0."""
    cfg = OverlapFeatureConfig(fmax=fmax)
    tab = cuda_features.feature_tables(cfg)
    fb = mel_filterbank(cfg.sample_rate, cfg.win_length, cfg.n_mels,
                        cfg.fmin, cfg.fmax)[::-1]
    assert int((fb != 0).sum()) == int((tab.mel_weight != 0).sum())
    if fmax is None:
        assert int((fb != 0).sum()) == 394 and tab.mel_count.max() == 9
    rng = np.random.RandomState(0)
    power = (rng.exponential(1.0, (16, fb.shape[1])) *
             10.0 ** rng.uniform(-8, 2, (16, 1))).astype(np.float32)
    dense = np.zeros((16, fb.shape[0]), np.float32)
    for b in range(fb.shape[1]):
        dense = dense + power[:, b:b + 1] * fb[:, b]
    np.testing.assert_array_equal(banded_mel(power, tab), dense)


@pytest.mark.parametrize("sr", sorted(GEOMETRIES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fft_model_matches_dense_dft(sr, dtype):
    """The radix plan gives the dense windowed DFT's power: to 1e-9
    relative in float64 (same window values, float64 twiddles), within
    1e-5 of each frame's peak in float32 (the kernel's tables)."""
    _check_fft_model(OverlapFeatureConfig(sample_rate=sr), dtype)


@pytest.mark.parametrize("name", sorted(GENERIC_WINDOWS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_generic_radix_model_matches_dense_dft(name, dtype):
    """The generic stage (prime radix 7, 11, 17 with combined table
    twiddles) in the plans of three windows the kernel now serves, held to
    the same budgets as the written-out radices."""
    kw, plan = GENERIC_WINDOWS[name]
    cfg = OverlapFeatureConfig(**kw)
    assert cuda_features.fft_radices(cfg.win_length // 2) == plan
    assert any(r not in WRITTEN_OUT for r in plan)
    _check_fft_model(cfg, dtype)


def _check_fft_model(cfg, dtype):
    sr, win = cfg.sample_rate, cfg.win_length
    y = synth_speech(cfg.n_samples, sr=sr, seed=3)[None]
    frames = _frames(y, cfg)[0]
    if dtype == np.float64:
        tab = cuda_features.feature_tables(cfg, np.float64)
        ang = 2.0 * np.pi * np.outer(np.arange(win), np.arange(win // 2 + 1)
                                     ) / win
        w = tab.window.astype(np.float64)[:, None]
        ref = (frames @ (np.cos(ang) * w)) ** 2 + \
            (frames @ (np.sin(ang) * w)) ** 2
        got = fft_model(frames, tab, np.float64)
        np.testing.assert_allclose(got, ref, rtol=1e-9,
                                   atol=1e-12 * ref.max())
    else:
        tab = cuda_features.feature_tables(cfg)
        cos, sin = _dft_basis(win, win)
        f32 = frames.astype(np.float32)
        ref = (f32 @ cos) ** 2 + (f32 @ sin) ** 2
        got = fft_model(frames, tab, np.float32)
        assert got.dtype == np.float32
        err = np.abs(got - ref).max(axis=1)
        assert (err <= 1e-5 * ref.max(axis=1)).all()


def test_kernel_model_matches_jax():
    """The kernel's whole algorithm (float32 FFT, banded mel, one-pass
    epilogue) against the JAX featurizer, within the pixel budget: one
    quantization step on < 2 % of pixels; an all-zero window is 255."""
    cfg = OverlapFeatureConfig()
    y = np.stack([synth_speech(cfg.n_samples, seed=s) for s in range(3)]
                 + [np.zeros(cfg.n_samples, np.float32)]).astype(np.float32)
    got = kernel_model(y, cfg)
    ref = np.asarray(jax_features(jnp.asarray(y)))
    assert got.shape == ref.shape == (4, 128, 151, 3)
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0 and (diff > 0).mean() < 0.02
    assert (got[3, ..., 1:] == 255).all() and (got[3, ..., 0] == 0).all()


# even windows whose half has a prime factor without a written-out
# butterfly; the kernel's generic stage serves them
NON_KERNEL_WINDOWS = [kw for kw, _ in GENERIC_WINDOWS.values()]
# a prime factor above the limit: 18.4 kHz at 25 ms, win 460, 230 = 2 * 5 * 23
ABOVE_LIMIT = dict(sample_rate=18400)


@pytest.mark.parametrize("kw,refusal", [
    # the first six cases keep the ids they had when the kernel refused
    # the first three windows
    *[pytest.param(kw, None, id=f"kw{i}-False")
      for i, kw in enumerate(NON_KERNEL_WINDOWS)],
    pytest.param(dict(win_ms=24.9375), "is odd", id="kw3-False"),   # win 399
    pytest.param(dict(time_dim=151), None, id="kw4-True"),
    pytest.param(dict(sample_rate=24000), None, id="kw5-True"),
    pytest.param(ABOVE_LIMIT, "no prime factor of win/2 above 17",
                 id="above-limit"),
    # 461 frames: the (M, T) tile alone is 236 KB
    pytest.param(dict(time_dim=460), "bytes of shared memory",
                 id="shared-memory")])
def test_check_feature_config_window(kw, refusal):
    """The kernel takes any even window whose half has no prime factor
    above ``MAX_RADIX`` and whose shared memory fits; it refuses the rest
    with the reason.  The plain version (``on_card=False``) takes any."""
    cfg = OverlapFeatureConfig(**kw)
    cuda_features.check_feature_config(cfg, on_card=False)
    if refusal is None:
        cuda_features.check_feature_config(cfg)
        assert cuda_features.feature_tables(cfg).radices == \
            cuda_features.fft_radices(cfg.win_length // 2)
        return
    with pytest.raises(ValueError, match=refusal):
        cuda_features.check_feature_config(cfg)
    with pytest.raises(ValueError, match=refusal):
        cuda_features.feature_tables(cfg)


@pytest.mark.parametrize("kw", NON_KERNEL_WINDOWS)
def test_plain_path_serves_any_window(kw):
    """A CPU tensor takes the plain version whatever the window, and it
    agrees with the JAX featurizer within the pixel budget."""
    from mmla_audio_tpu.core.config import OverlapFeatureConfig as JaxCfg

    cfg = OverlapFeatureConfig(**kw)
    y = np.stack([synth_speech(cfg.n_samples, sr=cfg.sample_rate, seed=s)
                  for s in range(2)]).astype(np.float32)
    got = cuda_features.overlap_model_input_cuda(torch.from_numpy(y),
                                                 cfg).numpy()
    ref = np.asarray(jax_features(jnp.asarray(y), JaxCfg(**kw)))
    assert got.shape == ref.shape and got.shape[:2] == (2, 128)
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0 and (diff > 0).mean() < 0.02


@pytest.mark.parametrize("kw", NON_KERNEL_WINDOWS + [ABOVE_LIMIT])
def test_predictor_refuses_non_kernel_window_on_card(kw):
    """A card predictor takes the generic-stage windows: its construction
    gets past the kernel's window rule and stops only at the empty state
    dict.  A window with a prime factor above the limit is refused at
    construction, before the model is built, with the kernel's reason."""
    if kw is ABOVE_LIMIT:
        with pytest.raises(ValueError, match="above 17"):
            OverlapPredictor({}, feat_cfg=OverlapFeatureConfig(**kw),
                             device="cuda")
        return
    with pytest.raises(RuntimeError, match="Missing key"):
        OverlapPredictor({}, feat_cfg=OverlapFeatureConfig(**kw),
                         device="cuda")


@pytest.mark.parametrize("fn,name", [(OverlapPredictor.__init__, "device"),
                                     (StreamingSession.__init__, "device"),
                                     (standardize_audio, "device"),
                                     (SpeakerPredictor.__init__, "device")])
def test_entry_points_default_to_the_card(fn, name):
    assert inspect.signature(fn).parameters[name].default == "cuda"


def test_cli_device_defaults_to_the_card(monkeypatch):
    """No silent fallback: without ``--device`` the CLI asks for the card
    even where torch finds none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli._device(types.SimpleNamespace(device=None)) == \
        torch.device("cuda")
    assert cli._device(types.SimpleNamespace(device="cpu")) == \
        torch.device("cpu")
