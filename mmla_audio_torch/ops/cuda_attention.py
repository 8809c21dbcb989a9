"""Kernel A1, WavLM's self-attention with its gated relative position bias:
the hand-written CUDA kernel's wrapper and its plain version.

``wavlm_attention(q, k, v, gate, bias, lens)`` computes, for each batch row
``b``, head ``h`` and query ``i``::

    s_ij = q_i . k_j / sqrt(d) + gate[b, h, i] * bias[h, j - i + T - 1]
    out_i = sum_j softmax_j(s_ij) v_j,        keys j < lens[b] only

with ``q, k, v (B, H, T, d)`` float32, ``gate (B, H, T)`` (each layer's gate
of layer 0's bias), ``bias (H, 2T - 1)`` (layer 0's table
``E[h, bucket(j - i)]`` for ``j - i = -(T - 1) .. T - 1``, see
``models/wavlm.py``) and ``lens (B,)`` int32, the keys a row attends to
(at least 1).  It returns ``(B, H, T, d)``; on the card a view of a
contiguous ``(B, T, H, d)`` tensor, so that the output projection reads
``(B, T, H * d)`` without a copy.

It replaces no TPU kernel (the JAX package has no WavLM).  The kernel
source, with its design and its bound, is
``mmla_audio_torch/csrc/wavlm_attention.cu``.  Dispatch is by the tensor's
device only: a CPU tensor goes to ``wavlm_attention_plain``; a CUDA tensor
launches the kernel or raises.  On the card the dots run in one TF32 pass
where ``torch.backends.cuda.matmul.allow_tf32`` is set (a predictor's
``fp32_policy``), else in 3xTF32.  ``wavlm_attention.launches`` counts
launches, ``.launches_split`` those in 3xTF32.
"""

from __future__ import annotations

import torch

__all__ = ["HEAD_SIZE", "wavlm_attention_plain", "wavlm_attention"]

HEAD_SIZE = 64               # the only head size the kernel is built for


def wavlm_attention_plain(q, k, v, gate, bias, lens) -> torch.Tensor:
    """The attention in plain PyTorch (the (B, H, T, T) gated bias
    materialised, as ``F.multi_head_attention_forward`` takes it)."""
    B, H, T, d = q.shape
    scores = (q * d ** -0.5) @ k.transpose(-1, -2)
    pos = torch.arange(T, device=q.device)
    offset = pos[None, :] - pos[:, None] + (T - 1)          # j - i + T - 1
    scores = scores + gate[..., None] * bias[:, offset]
    masked = pos[None, :] >= lens.to(q.device)[:, None]      # (B, T) keys
    scores = scores.masked_fill(masked[:, None, None, :], float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"wavlm_attention: {name} must be {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def wavlm_attention(q, k, v, gate, bias, lens) -> torch.Tensor:
    """``wavlm_attention_plain``'s contract; on the card, kernel A1."""
    if q.device.type == "cpu":
        return wavlm_attention_plain(q, k, v, gate, bias, lens)
    if q.device.type != "cuda":
        raise ValueError(f"wavlm_attention: unsupported device {q.device}")
    if q.ndim != 4:
        raise ValueError(f"wavlm_attention: q must be (B, H, T, d), got "
                         f"{tuple(q.shape)}")
    B, H, T, d = q.shape
    if d != HEAD_SIZE:
        raise ValueError(f"wavlm_attention: the kernel takes heads of "
                         f"{HEAD_SIZE}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, torch.float32, (B, H, T, d), q.device)
        if t.stride() != q.stride() or t.stride(-1) != 1 or \
                any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError("wavlm_attention: q, k and v must share their "
                             "strides, d contiguous, 16-byte aligned rows")
    _check("gate", gate, torch.float32, (B, H, T), q.device)
    _check("bias", bias, torch.float32, (H, 2 * T - 1), q.device)
    _check("lens", lens, torch.int32, (B,), q.device)
    if not (bias.is_contiguous() and lens.is_contiguous()):
        raise ValueError("wavlm_attention: bias and lens must be contiguous")
    out = torch.empty((B, T, H, d), dtype=torch.float32, device=q.device)
    split = not torch.backends.cuda.matmul.allow_tf32
    if B and H:
        from mmla_audio_torch._build import cuda_library

        lib = cuda_library("wavlm_attention")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.wavlm_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(),
                bias.data_ptr(), lens.data_ptr(), out.data_ptr(), B, H, T,
                q.stride(0), q.stride(1), q.stride(2), *gate.stride(),
                int(split), stream)
        if err != 0:
            raise RuntimeError(f"wavlm_attention kernel launch failed "
                               f"(cudaError {err})")
        wavlm_attention.launches += 1
        wavlm_attention.launches_split += split
    return out.permute(0, 2, 1, 3)


wavlm_attention.launches = 0
wavlm_attention.launches_split = 0
