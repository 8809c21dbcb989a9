"""The fused residual block's hand-written CUDA kernel, its plain version and
its wrapper.

``fused_resblock_cuda`` replaces ``fused_block``
(``benchmarks/fused_block_probe.py``, TPU kernel ``_fused_block_kernel``):
one non-pooling pre-activation ``ResBlock2D`` in inference, with both
BatchNorms folded (``fold_bn``)::

    out = x + conv(4,1)(elu(conv3x3(elu(x * g1 + bb1)) + b1) * g2 + bb2) + b2

The convolutions zero-pad their activated inputs, the 3x3 by 1 on each side,
the (4, 1) by 1 above and 2 below (Flax ``SAME``).  Tensors are NCHW; the
kernels are HWIO, ``k1 (3, 3, C, C)`` and ``k2 (4, 1, C, C)``, as the JAX
model keeps them.  The kernel source, with its design and cost notes, is
``mmla_audio_torch/csrc/fused_resblock.cu``.

Dispatch is by the tensor's device only: a CPU tensor goes to
``fused_resblock_plain``; a CUDA tensor launches the kernel or raises.
``fused_resblock_cuda.launches`` counts launches.  The kernel serves any
width up to ``FUSED_MAX_CHANNELS`` at any height and width (it cuts a row
into column tiles when a whole one does not fit shared memory);
``check_block_width`` rejects a wider model when it is built for the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["FUSED_MAX_CHANNELS", "check_block_width", "fold_bn",
           "fused_resblock_plain", "fused_resblock_cuda"]

# The kernel's smallest tile, 4 output rows by 1 column of all C channels
# with its halo and two conv3x3 weight chunks, takes 424 * C bytes of shared
# memory; a Hopper block may have 227 KB.
FUSED_MAX_CHANNELS = 548


def check_block_width(channels: int) -> None:
    """Raise unless the fused kernel can serve a block of ``channels``."""
    if not 0 < channels <= FUSED_MAX_CHANNELS:
        raise ValueError(f"the fused residual block kernel serves 1 to "
                         f"{FUSED_MAX_CHANNELS} channels, got {channels}")


def fold_bn(bn) -> tuple[torch.Tensor, torch.Tensor]:
    """An eval-mode BatchNorm as a per-channel scale and shift:
    ``g = weight / sqrt(var + eps)``, ``b = bias - mean * g``."""
    g = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return g, bn.bias - bn.running_mean * g


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def fused_resblock_plain(x, k1, b1, k2, b2, g1, bb1, g2, bb2) -> torch.Tensor:
    """The block in plain PyTorch: ``x (B, C, H, W)``, HWIO kernels, (C,)
    vectors (the probe's ``xla_block`` on NCHW)."""
    t = F.elu(x * _chan(g1) + _chan(bb1))
    y = F.conv2d(t, k1.permute(3, 2, 0, 1), b1, padding=1)
    t2 = F.elu(y * _chan(g2) + _chan(bb2))
    return x + F.conv2d(F.pad(t2, (0, 0, 1, 2)), k2.permute(3, 2, 0, 1), b2)


def fused_resblock_cuda(x, k1, b1, k2, b2, g1, bb1, g2, bb2) -> torch.Tensor:
    """``fused_resblock_plain``'s contract; on the card, the kernel."""
    if x.device.type == "cpu":
        return fused_resblock_plain(x, k1, b1, k2, b2, g1, bb1, g2, bb2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock_cuda: unsupported device {x.device}")
    if x.ndim != 4:
        raise ValueError(f"fused_resblock_cuda: (B, C, H, W) required, got "
                         f"{tuple(x.shape)}")
    check_block_width(x.shape[1])
    if x.dtype != torch.float32:
        raise TypeError(f"fused_resblock_cuda: float32 required, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_resblock_cuda: x must be contiguous NCHW")
    B, C, H, W = x.shape
    shapes = ((3, 3, C, C), (C,), (4, 1, C, C)) + ((C,),) * 5
    args = (x,) + tuple(
        _operand(a, s, x.device)
        for a, s in zip((k1, b1, k2, b2, g1, bb1, g2, bb2), shapes))
    out = torch.empty_like(x)
    if B:
        from mmla_audio_torch._build import cuda_library

        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = cuda_library("fused_resblock").fused_resblock_launch(
                args[0].data_ptr(), out.data_ptr(),
                *(a.data_ptr() for a in args[1:]), B, C, H, W, stream)
        if err != 0:
            raise RuntimeError(f"fused_resblock kernel launch failed "
                               f"(cudaError {err})")
        fused_resblock_cuda.launches += 1
    return out


fused_resblock_cuda.launches = 0


def _operand(a: torch.Tensor, shape, device) -> torch.Tensor:
    if tuple(a.shape) != shape or a.dtype != torch.float32 or \
            a.device != device or not a.is_contiguous() or \
            a.data_ptr() % 16:
        raise ValueError(f"fused_resblock_cuda: operand must be a contiguous, "
                         f"16-byte aligned float32 {shape} on {device}, got "
                         f"{a.dtype} {tuple(a.shape)} on {a.device}")
    return a
