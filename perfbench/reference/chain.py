"""The pre-decision chain in plain PyTorch and NumPy: what a window goes
through before a model sees it.

1. ``noise_threshold``: an ambient clip's per-bin gate threshold
   (noisereduce's stationary gate: |STFT| in dB, clamped 80 dB below the
   peak, mean + 1.5 std over time), float64.
2. ``denoise``: noisereduce's ``reduce_noise`` over each window (30,000
   zeros a side, the gate, the outer triangular smoothing kernel, inverse
   STFT), float64, then the PCM16 round trip (round half to even, clip).
3. ``WebRtcRows`` (``webrtc.py``): each stream's detector over the
   denoised window's 85 whole frames, its state carried.
4. ``collector_keep`` and ``trim``: the reference's ``vad_collector``
   hysteresis (a 10-frame ring, 90 %) and the kept frames concatenated.

Nothing here imports the program.  The float64 chain differs from the
card's by one int16 step in a few samples a window (the card sums its mask
smoothing in float32); such a step can flip a detector frame, and the
detector's carried state then differs for windows after it.  So
``perfbench/check.py`` holds the denoise alone (``denoise``), and the
detector, collector and trim alone on the program's own denoised windows
(``detect_trim``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.webrtc import WebRtcRows

__all__ = ["noise_threshold", "denoise", "bf16_round", "tf32_round",
           "ROUND", "collector_keep", "trim", "detect_trim", "window_chain",
           "WebRtcRows"]

N_FFT, HOP, PAD = 1024, 256, 30_000
FRAME, RING = 480, 10


def _hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * np.pi * k / n)


def _stft(y: torch.Tensor) -> torch.Tensor:
    """Centered (reflect) STFT of ``y (B, n)`` -> ``(B, K, T)`` complex."""
    yp = F.pad(y[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = yp.unfold(-1, N_FFT, HOP) * _hann(N_FFT, y.device)
    return torch.fft.rfft(frames, n=N_FFT, dim=-1).transpose(1, 2)


def _istft(S: torch.Tensor, length: int) -> torch.Tensor:
    """Overlap-add inverse of ``S (B, K, T)``, divided by the squared
    window sum, the centering trimmed; ``(B, length)``."""
    B, _, T = S.shape
    w = _hann(N_FFT, S.device)
    frames = torch.fft.irfft(S.transpose(1, 2), n=N_FFT, dim=-1) * w
    total = N_FFT + (T - 1) * HOP
    y = F.fold(frames.transpose(1, 2), output_size=(1, total),
               kernel_size=(1, N_FFT), stride=(1, HOP)).reshape(B, total)
    wsq = F.fold((w * w).expand(1, T, N_FFT).transpose(1, 2),
                 output_size=(1, total), kernel_size=(1, N_FFT),
                 stride=(1, HOP)).reshape(total)
    y = y / torch.clamp(wsq, min=1e-10)
    return y[:, N_FFT // 2: N_FFT // 2 + length]


def _amp_to_db(mag: torch.Tensor) -> torch.Tensor:
    db = 20.0 * torch.log10(torch.clamp(mag, min=1e-20))
    peak = db.amax(dim=(-2, -1), keepdim=True)
    return torch.maximum(db, peak - 80.0)


def _smoothing_kernel(sr: int, freq_hz: float = 500.0,
                      time_ms: float = 50.0) -> np.ndarray:
    n_f = int(freq_hz / (sr / (N_FFT / 2)))
    n_t = int(time_ms / ((HOP / sr) * 1000))
    v_f = np.concatenate([np.linspace(0, 1, n_f + 1, endpoint=False),
                          np.linspace(1, 0, n_f + 2)])[1:-1]
    v_t = np.concatenate([np.linspace(0, 1, n_t + 1, endpoint=False),
                          np.linspace(1, 0, n_t + 2)])[1:-1]
    k = np.outer(v_f, v_t)
    return k / k.sum()


def noise_threshold(noise_i16: np.ndarray, device,
                    n_std: float = 1.5) -> torch.Tensor:
    """Per-bin gate threshold ``(K,)`` float64 of an int16 ambient clip."""
    y = torch.as_tensor(np.asarray(noise_i16, np.float64) / 32768.0,
                        device=device)[None]
    db = _amp_to_db(_stft(y).abs())[0]                     # (K, T)
    return db.mean(dim=1) + db.std(dim=1, correction=0) * n_std


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (real and imaginary parts apart), kept in
    its own dtype."""
    if t.is_complex():
        return torch.complex(bf16_round(t.real), bf16_round(t.imag))
    return t.to(torch.bfloat16).to(t.dtype)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10-bit mantissa, to nearest even (real and
    imaginary parts apart), kept in its own dtype."""
    if t.is_complex():
        return torch.complex(tf32_round(t.real), tf32_round(t.imag))
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32).to(t.dtype)


ROUND = {"bf16": bf16_round, "tf32": tf32_round}


@torch.no_grad()
def denoise(raw_i16: np.ndarray, thresh: torch.Tensor, device,
            sr: int = 16_000, block: int = 64, rnd=None) -> np.ndarray:
    """Denoised int16 windows ``(B, n)`` of ``raw_i16 (B, n)``, each against
    its row of ``thresh (B, K)``, in blocks of ``block`` windows.  ``rnd``
    (such as ``bf16_round``) rounds each stage's result: the input, the
    spectrum, the smoothed mask, the masked spectrum and the output."""
    rnd = rnd or (lambda t: t)
    kern = torch.as_tensor(_smoothing_kernel(sr), device=device)[None, None]
    kh, kw = kern.shape[-2:]
    out = np.empty(raw_i16.shape, np.int16)
    n = raw_i16.shape[1]
    for a in range(0, len(raw_i16), block):
        y = rnd(torch.as_tensor(raw_i16[a: a + block].astype(np.float64)
                                / 32768.0, device=device))
        yp = F.pad(y, (PAD, PAD))
        S = rnd(_stft(yp))                                     # (b, K, T)
        db = _amp_to_db(S.abs())
        mask = (db > thresh[a: a + block, :, None]).to(torch.float64)
        mask = rnd(F.conv2d(mask[:, None], kern,
                            padding=(kh // 2, kw // 2))[:, 0])
        yd = rnd(_istft(rnd(S * mask), yp.shape[1])[:, PAD: PAD + n])
        q = torch.clamp(torch.round(yd * 32768.0), -32768.0, 32767.0)
        out[a: a + block] = q.to(torch.int16).cpu().numpy()
    return out


def collector_keep(decisions: np.ndarray, ratio: float = 0.9,
                   ring: int = RING) -> np.ndarray:
    """``vad_collector``'s keep mask ``(B, T)`` of per-frame decisions."""
    keep = np.zeros(decisions.shape, bool)
    thresh = ratio * ring
    for b, row in enumerate(decisions.tolist()):
        buf: list = []
        triggered = False
        for i, speech in enumerate(row):
            buf.append((i, speech))
            if len(buf) > ring:
                buf.pop(0)
            if not triggered:
                if sum(s for _, s in buf) > thresh:
                    triggered = True
                    for j, _ in buf:
                        keep[b, j] = True
                    buf = []
            else:
                keep[b, i] = True
                if sum(not s for _, s in buf) > thresh:
                    triggered = False
                    buf = []
    return keep


def trim(i16: np.ndarray, keep: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kept frames of each row concatenated, zero beyond; (trimmed
    ``(B, n)`` int16, kept samples ``(B,)``)."""
    B, n = i16.shape
    T = keep.shape[1]
    out = np.zeros((B, n), np.int16)
    frames = i16[:, : T * FRAME].reshape(B, T, FRAME)
    kept = keep.sum(axis=1)
    for b in range(B):
        k = frames[b][keep[b]].reshape(-1)
        out[b, : len(k)] = k
    return out, kept * FRAME


def frame_count(n: int) -> int:
    """Whole frames of a window: ``offset + 480 < n`` (strict)."""
    return 0 if n <= FRAME else (n - FRAME - 1) // FRAME + 1


def detect_trim(den_i16: np.ndarray, detectors: WebRtcRows
                ) -> tuple[np.ndarray, np.ndarray]:
    """The chain after the denoise, one window a detector row: denoised
    ``den_i16 (R, n)`` (row r advances detector r) -> (trimmed int16
    ``(R, n)``, kept samples ``(R,)``)."""
    T = frame_count(den_i16.shape[1])
    dec = detectors.decisions(den_i16[:, : T * FRAME])
    return trim(den_i16, collector_keep(dec))


def window_chain(raw_i16: np.ndarray, thresh: torch.Tensor,
                 detectors: WebRtcRows, device
                 ) -> tuple[np.ndarray, np.ndarray]:
    """One window a detector row: ``raw_i16 (R, n)`` (row r advances
    detector r) -> (trimmed int16 ``(R, n)``, kept samples ``(R,)``)."""
    return detect_trim(denoise(raw_i16, thresh, device), detectors)
