"""Kernel C1, the middle of the Conformer's conv module (GLU, the depthwise
convolution, eval BatchNorm folded into its taps, swish), channels-last:
the hand-written CUDA kernel's wrapper, its plain version and the fold.

``conformer_conv(y, taps, bias)`` takes ``y (B, T, 2C)`` float32, the
pointwise_conv1 product, and returns ``(B, T, C)`` contiguous::

    g[t, c]   = y[t, c] * sigmoid(y[t, C + c])       (zero for t outside [0, T))
    z[t, c]   = bias[c] + sum_{k<K} taps[k, c] * g[t + k - (K - 1) / 2, c]
    out[t, c] = z * sigmoid(z)

with ``taps (K, C)`` and ``bias (C,)`` from ``fold_batch_norm`` of the
depthwise weight and the eval BatchNorm's scale and shift.  The convolution
runs over all T rows, padded frames included.

It replaces no TPU kernel (the JAX package has no Conformer).  The kernel
source, with its design and its bound, is
``mmla_audio_torch/csrc/conformer_conv.cu``.  Dispatch is by the tensor's
device only: a CPU tensor goes to ``conformer_conv_plain``; a CUDA tensor
launches the kernel or raises.  The kernel's arithmetic is fp32 FMAs under
either TF32 policy.  Each launch runs inside the dispatcher operator
``mmla_audio::conformer_conv`` (a CUDA kernel alone), so that a profiler
ties C1's kernel to an operator as it ties aten's.
``conformer_conv.launches`` counts launches.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

__all__ = ["TAPS", "MAX_TILE", "fold_batch_norm", "c1_plan",
           "conformer_conv_plain", "conformer_conv"]

TAPS = 31                    # the only kernel size the kernel is built for
MAX_TILE = 256               # time rows a CTA


def fold_batch_norm(weight, scale, shift) -> tuple:
    """``(taps (K, C), bias (C,))`` float32 contiguous: the depthwise
    weight ``(C, 1, K)`` with eval BatchNorm, the map ``x scale + shift`` a
    channel, folded in (``w scale`` and ``shift``), computed in float64 and
    rounded once."""
    with torch.no_grad():
        taps = (weight[:, 0, :].double() * scale.double()[:, None]).t()
        return taps.float().contiguous(), shift.float().contiguous()


def c1_plan(batch: int, T: int, C: int, sms: int) -> tuple:
    """``(channel tile, time tile)`` of a launch: the whole T a CTA up to
    ``MAX_TILE`` rows, longer rows in near-equal tiles; 64 channels a CTA
    where that gives the card's ``sms`` multiprocessors a CTA each, else
    32."""
    tiles = -(-T // MAX_TILE)
    c_tile = 64 if batch * tiles * -(-C // 64) >= sms else 32
    return c_tile, -(-T // tiles)


def conformer_conv_plain(y, taps, bias) -> torch.Tensor:
    """The module's middle in plain PyTorch: ``F.glu``, a grouped
    ``F.conv1d`` over the channels-first view with the folded taps and
    bias, ``F.silu``; contiguous ``(B, T, C)`` out."""
    K, C = taps.shape
    g = F.glu(y, dim=-1).transpose(1, 2)
    z = F.conv1d(g, taps.t().unsqueeze(1), bias, padding=(K - 1) // 2,
                 groups=C)
    return F.silu(z).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(y, taps, bias, c_tile: int, t_tile: int):
    """The launch of C1 on arguments ``conformer_conv`` checked."""
    from mmla_audio_torch._build import cuda_library

    B, T, C2 = y.shape
    out = torch.empty((B, T, C2 // 2), dtype=torch.float32, device=y.device)
    lib = cuda_library("conformer_conv")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.conformer_conv_launch(
            y.data_ptr(), taps.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, T, C2 // 2, c_tile, t_tile, stream)
    if err != 0:
        raise RuntimeError(f"conformer_conv kernel launch failed "
                           f"(cudaError {err})")
    return out


# C1 launches inside a dispatcher operator, as E1 and A2 do, so that a
# profiler ties its kernel to it (and to the span ``model.conv_module``).
_OPS = torch.library.Library("mmla_audio", "FRAGMENT")
_OPS.define("conformer_conv(Tensor y, Tensor taps, Tensor bias, "
            "int c_tile, int t_tile) -> Tensor")
_OPS.impl("conformer_conv", _launch, "CUDA")


def conformer_conv(y, taps, bias) -> torch.Tensor:
    """``conformer_conv_plain``'s contract; on the card, kernel C1 (operator
    ``torch.ops.mmla_audio.conformer_conv``), which takes K = ``TAPS``,
    ``C % 4 == 0`` and a contiguous float32 ``y``, and raises on anything
    else."""
    if y.device.type == "cpu":
        return conformer_conv_plain(y, taps, bias)
    if y.device.type != "cuda":
        raise ValueError(f"conformer_conv: unsupported device {y.device}")
    if y.ndim != 3 or y.shape[-1] % 2:
        raise ValueError(f"conformer_conv: y must be (B, T, 2C), got "
                         f"{tuple(y.shape)}")
    B, T, C2 = y.shape
    C = C2 // 2
    if y.dtype != torch.float32 or not y.is_contiguous() or \
            y.data_ptr() % 16:
        raise ValueError(f"conformer_conv: y must be contiguous 16-byte "
                         f"aligned float32, got {y.dtype} with strides "
                         f"{y.stride()}")
    if C % 4:
        raise ValueError(f"conformer_conv: the kernel takes channels in "
                         f"fours, got {C}")
    if taps.ndim != 2 or taps.shape[0] != TAPS:
        raise ValueError(f"conformer_conv: the kernel takes taps of "
                         f"{TAPS}, got {tuple(taps.shape)}")
    for name, t, shape in (("taps", taps, (TAPS, C)), ("bias", bias, (C,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or \
                t.device != y.device or not t.is_contiguous():
            raise ValueError(f"conformer_conv: {name} must be contiguous "
                             f"float32 {shape} on {y.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not B or not T:
        return torch.empty((B, T, C), dtype=torch.float32, device=y.device)
    c_tile, t_tile = c1_plan(B, T, C, _sms(y.get_device()))
    out = torch.ops.mmla_audio.conformer_conv(y, taps, bias, c_tile, t_tile)
    conformer_conv.launches += 1
    return out


conformer_conv.launches = 0
