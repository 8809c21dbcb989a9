"""Operations and bytes, counted from shapes, and the H100's peaks.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM, 495 TFLOP/s of dense TF32 on the tensor cores.  fp32
work is counted as 3xTF32 (three TF32 products give an fp32 one), so the
fp32 peak is 165 TFLOP/s, faster than the CUDA cores' 67.  A bound is the
least time the card could take: the larger of the bytes at the memory rate
and the operations at that peak.

What depends on a configuration kind's model is in ``counts/<kind>.py``,
found by the kind's name: its ``model_flops(model, feature)`` and, where
the kind runs kernel B3, ``b3_shapes(model, feature)``.
"""

from __future__ import annotations

import importlib
import math

__all__ = ["HBM_BYTES_S", "FP32_FLOP_S", "bound_s", "d1_work", "block_work",
           "denoise_pad", "of", "model_flops"]

HBM_BYTES_S = 3.35e12
TF32_FLOP_S = 495e12
FP32_FLOP_S = TF32_FLOP_S / 3          # 3xTF32


def bound_s(flop: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_S, flop / FP32_FLOP_S)


def denoise_pad(n_fft: int = 1024, hop: int = 256, sr: int = 16_000,
                time_ms: float = 50.0) -> int:
    """The zeros a side the live denoise pads a window with: noisereduce's
    30,000 shortened to the smallest pad of the same frame phase that holds
    the smoothing's reach and two FFT lengths."""
    n_t = int(time_ms / ((hop / sr) * 1000))
    half_t = (2 * n_t + 1) // 2
    margin = half_t * hop + 2 * n_fft
    rem = 30_000 % hop
    pad = rem + hop * ((margin - rem + hop - 1) // hop)
    return min(pad, 30_000)


def d1_work(groups: int, n: int, n_fft: int = 1024, hop: int = 256) -> tuple:
    """(FLOPs, bytes) of one STFT and one inverse STFT of ``groups`` signals
    of ``n`` samples: a real FFT of n_fft points a frame as an n_fft/2-point
    complex FFT (5 m log2 m) and its split (19 a bin), the window forward;
    the samples read once, the spectrum written and read, the frames
    written."""
    rows = groups * (1 + n // hop)
    m, k = n_fft // 2, n_fft // 2 + 1
    fft = 5 * m * math.log2(m) + 19 * k
    spec = 4.0 * rows * 2 * k
    flop = rows * (fft + n_fft) + rows * fft
    nbytes = 4.0 * groups * n + spec + spec + 4.0 * rows * n_fft
    return flop, nbytes


def block_work(batch: int, C: int, H: int, W: int) -> tuple:
    """(FLOPs, bytes) of a fused residual block: both convolutions (2 x 13
    C^2 FLOPs a pixel); x in, out out, the weights and vectors read once."""
    return (2 * 13 * C * C * H * W * batch,
            4 * (2 * batch * C * H * W + 13 * C * C + 6 * C))


def of(kind: str):
    """The counts of configuration kind ``kind``."""
    return importlib.import_module(f"perfbench.counts.{kind}")


def model_flops(kind: str, model: dict, feature: dict) -> float:
    """Forward FLOPs of one window through the model of kind ``kind``."""
    return of(kind).model_flops(model, feature)


def pool(n: int) -> int:
    """A length after a 2x max-pool with ``ceil_mode``."""
    return (n + 1) // 2


def lstm(C: int, H: int, T: int) -> int:
    """FLOPs of a bidirectional LSTM of ``H`` units over ``T`` steps of
    ``C`` inputs."""
    return 2 * T * 2 * (C * 4 * H + H * 4 * H)
