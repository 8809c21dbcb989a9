"""Kernel E1, one layer of WavLM's conv encoder (Conv1d, LayerNorm over the
output channels, exact GELU) channels-last: the hand-written CUDA kernel's
wrapper and its plain version.

``wavlm_conv(x, weight, norm_weight, norm_bias, stride, eps, bias)`` takes
``x (B, T_in, C_in)`` float32, channels-last (layer 0: the samples as
``(B, L, 1)``, any row stride), the convolution's ``weight (C_out, C_in,
k)`` and ``bias`` (or None), the LayerNorm's scale and shift ``(C_out,)``,
and returns ``(B, T_out, C_out)`` contiguous, ``T_out = (T_in - k) //
stride + 1``:

    out[b, t] = gelu(layer_norm(conv1d(x)[b, :, t] + bias))

It replaces no TPU kernel (the JAX package has no WavLM).  The kernel
source, with its design and its bound, is
``mmla_audio_torch/csrc/wavlm_conv.cu``.  Dispatch is by the tensor's
device: a CPU tensor goes to ``wavlm_conv_plain``; a CUDA tensor launches
the kernel or raises.  Which kernel a layer takes depends on its widths
alone (``conv_route``): one input channel, a stencil in fp32 FMAs; input
channels a multiple of 32, an implicit GEMM on the tensor cores, in one
TF32 pass where ``torch.backends.cudnn.allow_tf32`` is set (a predictor's
``fp32_policy``; the flag that governs these convolutions in the plain
path), else in 3xTF32.  The GEMM reads the weight repacked to ``(C_out, k
C_in)``, beside its copy rounded to TF32 (``pack_conv_weight``), a derived
tensor that callers keep beside the module's parameters, so that
checkpoints load by their own names.
Each launch runs inside the dispatcher operator ``mmla_audio::wavlm_conv``
(a CUDA kernel alone), so that a profiler ties E1's kernels to an operator
as it ties aten's.  ``wavlm_conv.launches`` counts launches,
``.launches_split`` those in 3xTF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv_route", "conv_args", "round_tf32", "pack_conv_weight",
           "wavlm_conv_plain", "wavlm_conv"]

MAX_CHANNELS = 512           # output channels a block (a cluster) holds


def conv_route(c_in: int, c_out: int) -> str | None:
    """The kernel a layer of these widths takes: ``"samples"`` (one input
    channel), ``"gemm"`` (input channels a multiple of 32), or None where
    neither takes its output width."""
    if c_in == 1 and c_out % 128 == 0 and c_out <= MAX_CHANNELS:
        return "samples"
    if c_in % 32 == 0 and c_out % 128 == 0 and c_out <= MAX_CHANNELS:
        return "gemm"
    return None


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``): the low 13 bits of the mantissa cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """The kernel's layout of a Conv1d weight ``(C_out, C_in, k)``: ``(k,
    C_out)`` taps by channel for one input channel; else ``(2, C_out, k
    C_in)``, element ``(0, n, j C_in + c)`` = ``weight[n, c, j]`` and the
    same rounded to TF32 at ``(1, n, ..)``; contiguous."""
    weight = weight.detach()
    if weight.shape[1] == 1:
        return weight[:, 0, :].t().contiguous()
    w = weight.permute(0, 2, 1).reshape(weight.shape[0], -1).contiguous()
    return torch.stack([w, round_tf32(w)])


def wavlm_conv_plain(x, weight, norm_weight, norm_bias, stride: int,
                     eps: float = 1e-5, bias=None) -> torch.Tensor:
    """The layer in plain PyTorch: ``F.conv1d`` over the channels-first view,
    ``F.layer_norm`` over the channels, ``F.gelu``.  The GELU runs over the
    channels-first view as the model's layer did before E1, which on the
    CPU takes another loop than a contiguous tensor and gives its bits; the
    result is contiguous all the same."""
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride)
    y = F.layer_norm(y.transpose(1, 2), (weight.shape[0],), norm_weight,
                     norm_bias, eps)
    return F.gelu(y.transpose(1, 2)).transpose(1, 2)


def _check(name, t, shape, device):
    if t.dtype != torch.float32 or tuple(t.shape) != shape or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f"wavlm_conv: {name} must be contiguous float32 "
                         f"{shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def conv_args(x, weight, norm_weight, norm_bias, stride: int, bias=None,
              packed=None) -> tuple:
    """What the kernel takes, checked: ``(route, T_out)`` of these
    arguments, or ValueError for one it does not take (widths, dtype,
    shape, device, layout)."""
    if x.ndim != 3 or weight.ndim != 3 or x.shape[-1] != weight.shape[1]:
        raise ValueError(f"wavlm_conv: x must be (B, T, C_in) and weight "
                         f"(C_out, C_in, k), got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    _, T_in, c_in = x.shape
    c_out, _, k = weight.shape
    route = conv_route(c_in, c_out)
    if route is None:
        raise ValueError(f"wavlm_conv: the kernel takes one input channel "
                         f"or a multiple of 32, and output channels a "
                         f"multiple of 128 up to {MAX_CHANNELS}; got "
                         f"{c_in} -> {c_out}")
    if x.dtype != torch.float32:
        raise ValueError(f"wavlm_conv: x must be float32, got {x.dtype}")
    if stride < 1 or T_in < k:
        raise ValueError(f"wavlm_conv: {T_in} frames cannot take a kernel "
                         f"of {k} at stride {stride}")
    dev = x.device
    _check("weight", weight, tuple(weight.shape), dev)
    for name, t in (("norm_weight", norm_weight), ("norm_bias", norm_bias)) \
            + ((("bias", bias),) if bias is not None else ()):
        _check(name, t, (c_out,), dev)
    if packed is not None:
        _check("packed", packed, (k, c_out) if route == "samples"
               else (2, c_out, k * c_in), dev)
    if route == "samples" and x.stride(1) != 1:
        raise ValueError("wavlm_conv: the samples must be contiguous along "
                         "a row")
    if route == "gemm" and not x.is_contiguous():
        raise ValueError("wavlm_conv: x must be contiguous (B, T, C_in)")
    return route, (T_in - k) // stride + 1


def _launch(x, packed, bias, norm_weight, norm_bias, c_out: int, k: int,
            stride: int, t_out: int, eps: float, split: bool):
    """The launch of E1 on arguments ``conv_args`` checked: the kernel of
    the input width, ``(B, T_out, C_out)`` out."""
    from mmla_audio_torch._build import cuda_library

    B, T_in, c_in = x.shape
    dev = x.device
    out = torch.empty((B, t_out, c_out), dtype=torch.float32, device=dev)
    lib = cuda_library("wavlm_conv")
    bias_ptr = bias.data_ptr() if bias is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if c_in == 1:
            err = lib.wavlm_conv_samples_launch(
                x.data_ptr(), x.stride(0), packed.data_ptr(), bias_ptr,
                norm_weight.data_ptr(), norm_bias.data_ptr(),
                out.data_ptr(), B, T_in, c_out, k, stride, t_out, eps,
                stream)
        else:
            err = lib.wavlm_conv_gemm_launch(
                x.data_ptr(), packed.data_ptr(), bias_ptr,
                norm_weight.data_ptr(), norm_bias.data_ptr(),
                out.data_ptr(), B, T_in, c_in, c_out, k, stride, t_out,
                eps, int(split), stream)
    if err != 0:
        raise RuntimeError(f"wavlm_conv kernel launch failed "
                           f"(cudaError {err})")
    return out


# Every launch runs inside a dispatcher operator, ``mmla_audio::wavlm_conv``,
# as aten's kernels do inside theirs: a profiler ties a kernel to the
# operator that was open when the host launched it, and a ctypes call alone
# opens none.
_OPS = torch.library.Library("mmla_audio", "DEF")
_OPS.define("wavlm_conv(Tensor x, Tensor packed, Tensor? bias, "
            "Tensor norm_weight, Tensor norm_bias, int c_out, int k, "
            "int stride, int t_out, float eps, bool split) -> Tensor")
_OPS.impl("wavlm_conv", _launch, "CUDA")


def wavlm_conv(x, weight, norm_weight, norm_bias, stride: int,
               eps: float = 1e-5, bias=None, packed=None) -> torch.Tensor:
    """``wavlm_conv_plain``'s contract; on the card, kernel E1 (operator
    ``torch.ops.mmla_audio.wavlm_conv``).  ``packed``:
    ``pack_conv_weight(weight)`` kept by the caller (made here if None)."""
    if x.device.type == "cpu":
        return wavlm_conv_plain(x, weight, norm_weight, norm_bias, stride,
                                eps, bias)
    if x.device.type != "cuda":
        raise ValueError(f"wavlm_conv: unsupported device {x.device}")
    route, T_out = conv_args(x, weight, norm_weight, norm_bias, stride, bias,
                             packed)
    c_out, _, k = weight.shape
    if not x.shape[0]:
        return torch.empty((0, T_out, c_out), dtype=torch.float32,
                           device=x.device)
    if packed is None:
        packed = pack_conv_weight(weight)
    split = route == "gemm" and not torch.backends.cudnn.allow_tf32
    out = torch.ops.mmla_audio.wavlm_conv(x, packed, bias, norm_weight,
                                          norm_bias, c_out, k, stride,
                                          T_out, eps, split)
    wavlm_conv.launches += 1
    wavlm_conv.launches_split += split
    return out


wavlm_conv.launches = 0
wavlm_conv.launches_split = 0
