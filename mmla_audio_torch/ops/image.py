"""Pyramid blur ladder of feature images (counterpart of
``mmla_audio_tpu.ops.image``; OpenCV ``pyrDown``/``pyrUp`` semantics).

The reference rebalances the overlap detector's classes by passing feature
PNGs through ``cv.pyrDown``/``cv.pyrUp`` rounds (`overlap_detector.py:
203-213`): a blur that keeps the label and perturbs the features.  Here it
is batched torch ops on the images' device: the separable 5x5 Gaussian
``outer([1, 4, 6, 4, 1] / 16)`` with BORDER_REFLECT_101 borders (torch's
``reflect`` padding, as NumPy's), ``pyrDown`` keeping every second pixel,
``pyrUp`` zero-stuffing and blurring with 4x the kernel.  Images are
``(..., H, W, C)``, as in the JAX package; each weighted sum runs in the
JAX package's order, so float32 results agree to rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pyr_down", "pyr_up", "pyramid_augment"]

_K5 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def _blur5(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Separable 5x5 Gaussian of ``x (N, C, H, W)``, reflect-101 borders;
    ``scale`` multiplies the vertical taps."""
    H, W = x.shape[-2:]
    xp = F.pad(x, (2, 2, 2, 2), mode="reflect")
    rows = _K5[0] * scale * xp[..., 0:H, :]
    for i in range(1, 5):
        rows = rows + _K5[i] * scale * xp[..., i:i + H, :]
    out = _K5[0] * rows[..., 0:W]
    for i in range(1, 5):
        out = out + _K5[i] * rows[..., i:i + W]
    return out


def _down(x: torch.Tensor) -> torch.Tensor:
    return _blur5(x)[..., ::2, ::2]


def _up(x: torch.Tensor) -> torch.Tensor:
    N, C, H, W = x.shape
    up = x.new_zeros((N, C, 2 * H, 2 * W))
    up[..., ::2, ::2] = x
    return _blur5(up, scale=4.0)


def _nchw(images: torch.Tensor) -> torch.Tensor:
    """``(..., H, W, C)`` -> ``(N, C, H, W)``."""
    H, W, C = images.shape[-3:]
    return images.reshape(-1, H, W, C).permute(0, 3, 1, 2)


def _back(x: torch.Tensor, lead: tuple) -> torch.Tensor:
    """``(N, C, H, W)`` -> ``(*lead, H, W, C)``."""
    return x.permute(0, 2, 3, 1).reshape(lead + tuple(x.shape[-2:])
                                         + (x.shape[1],))


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """``cv2.pyrDown``: blur, then every second pixel.  ``(..., H, W, C)``
    -> ``(..., ceil(H/2), ceil(W/2), C)``."""
    return _back(_down(_nchw(x)), tuple(x.shape[:-3]))


def pyr_up(x: torch.Tensor) -> torch.Tensor:
    """``cv2.pyrUp``: zero-stuff 2x, blur with 4x the kernel.
    ``(..., H, W, C)`` -> ``(..., 2H, 2W, C)``."""
    return _back(_up(_nchw(x)), tuple(x.shape[:-3]))


def pyramid_augment(images: torch.Tensor, depth: int) -> torch.Tensor:
    """``depth`` rounds of pyrDown then pyrUp, then the last column dropped,
    as the reference's `augment_images` (`overlap_detector.py:209-214`): a
    151-wide image is 152 wide after the first round and later rounds carry
    that width; only the final crop returns to 151.  An odd height is
    cropped back after each round."""
    H = images.shape[-3]
    x = _nchw(images)
    for _ in range(depth):
        x = _up(_down(x))
        if x.shape[-2] > H:
            x = x[..., :H, :]
    return _back(x[..., :-1], tuple(images.shape[:-3]))
