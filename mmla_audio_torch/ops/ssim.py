"""Structural similarity (SSIM), the edge runner's silence gate
(counterpart of ``mmla_audio_tpu.ops.ssim``, in torch ops).

`OverlapDetection/scripts/record_on_pi.py:39-48`: SSIM between the feature
images of the raw and the denoised window, multichannel; a similarity
**below 0.3** means denoising wiped the features (the window was mostly
noise) and the window is silent.  skimage's defaults for uint8-scale
images: 7x7 uniform windows, C1 = (0.01 * 255)^2, C2 = (0.03 * 255)^2, the
unbiased ``n / (n - 1)`` moments, the mean over all windows and channels.
The 7x7 mean is a box filter from a 2-D cumulative sum, as in the JAX
package; on the card ``torch.cumsum`` sums in another order than XLA, so
the two agree within fp32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssim"]

_W = 7


def _uniform7(x: torch.Tensor) -> torch.Tensor:
    """7x7 mean filter, valid padding, over ``(..., H, W)``."""
    c = torch.cumsum(torch.cumsum(x, dim=-2), dim=-1)
    c = F.pad(c, (1, 0, 1, 0))
    w = _W
    s = c[..., w:, w:] - c[..., :-w, w:] - c[..., w:, :-w] + c[..., :-w, :-w]
    return s / (w * w)


def ssim(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM of ``(..., H, W, C)`` images (channels averaged, skimage
    multichannel semantics with uniform windows) -> ``(...)``."""
    a = torch.movedim(a.to(torch.float32), -1, -3)     # (..., C, H, W)
    b = torch.movedim(b.to(torch.float32), -1, -3)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _uniform7(a)
    mu_b = _uniform7(b)
    n = float(_W * _W)
    cov_norm = n / (n - 1.0)
    var_a = cov_norm * (_uniform7(a * a) - mu_a * mu_a)
    var_b = cov_norm * (_uniform7(b * b) - mu_b * mu_b)
    cov = cov_norm * (_uniform7(a * b) - mu_a * mu_b)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den, dim=(-3, -2, -1))
