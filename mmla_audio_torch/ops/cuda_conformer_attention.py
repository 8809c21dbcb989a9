"""Kernel A2, the Conformer's self-attention with Transformer-XL relative
positions: the hand-written CUDA kernel's wrapper and its plain version.

``conformer_attention(q, k, v, u, w, p, lens)`` computes, for each batch
row ``b``, head ``h`` and query ``i``::

    s_ij = ((q_i + u_h) . k_j + (q_i + w_h) . p[h, j - i + T - 1]) / sqrt(d)
    out_i = sum_j softmax_j(s_ij) v_j,        keys j < lens[b] only

with ``q, k, v (B, H, T, d)`` float32, ``u`` and ``w (H, d)`` the layer's
``pos_bias_u`` and ``pos_bias_v``, ``p (H, 2T - 1, d)`` the layer's
``linear_pos`` of the sinusoids of relative positions ``T - 1 .. -(T - 1)``
split per head (row ``j - i + T - 1`` is position ``i - j``; see
``models/conformer.py``), and ``lens (B,)`` int32, the keys a row attends to
(at least 1).  It returns ``(B, H, T, d)``; on the card a view of a
contiguous ``(B, T, H, d)`` tensor, so that the output projection reads
``(B, T, H * d)`` without a copy.

It replaces no TPU kernel (the JAX package has no Conformer).  The kernel
source, with its design and its bound, is
``mmla_audio_torch/csrc/conformer_attention.cu``.  Dispatch is by the
tensor's device only: a CPU tensor goes to ``conformer_attention_plain``; a
CUDA tensor launches the kernel or raises.  On the card the dots run in one
TF32 pass where ``torch.backends.cuda.matmul.allow_tf32`` is set (a
predictor's ``fp32_policy``), else in 3xTF32.  Each launch runs inside the
dispatcher operator ``mmla_audio::conformer_attention`` (a CUDA kernel
alone), so that a profiler ties A2's kernel to an operator as it ties
aten's.  ``conformer_attention.launches`` counts launches,
``.launches_split`` those in 3xTF32.
"""

from __future__ import annotations

import torch

__all__ = ["HEAD_SIZE", "conformer_attention_plain", "conformer_attention"]

HEAD_SIZE = 64               # the only head size the kernel is built for


def conformer_attention_plain(q, k, v, u, w, p, lens) -> torch.Tensor:
    """The attention in plain PyTorch: the positional scores of every query
    against all ``2T - 1`` table rows, ``(B, H, T, 2T - 1)``, gathered at
    ``j - i + T - 1``."""
    B, H, T, d = q.shape
    scores = (q + u[:, None]) @ k.transpose(-1, -2)
    pos = torch.arange(T, device=q.device)
    offset = pos[None, :] - pos[:, None] + (T - 1)          # j - i + T - 1
    bd = (q + w[:, None]) @ p.transpose(-1, -2)             # (B, H, T, 2T-1)
    scores = scores + bd.gather(-1, offset.expand(B, H, T, T))
    scores = scores * d ** -0.5
    masked = pos[None, :] >= lens.to(q.device)[:, None]      # (B, T) keys
    scores = scores.masked_fill(masked[:, None, None, :], float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def _check(name, t, shape, device, dtype=torch.float32):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"conformer_attention: {name} must be contiguous "
                         f"{dtype} {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch(q, k, v, u, w, p, lens, split: bool):
    """The launch of A2 on arguments ``conformer_attention`` checked:
    ``(B, T, H, d)`` out."""
    from mmla_audio_torch._build import cuda_library

    B, H, T, d = q.shape
    out = torch.empty((B, T, H, d), dtype=torch.float32, device=q.device)
    lib = cuda_library("conformer_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.conformer_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), u.data_ptr(),
            w.data_ptr(), p.data_ptr(), lens.data_ptr(), out.data_ptr(), B, H,
            T, q.stride(0), q.stride(1), q.stride(2), int(split), stream)
    if err != 0:
        raise RuntimeError(f"conformer_attention kernel launch failed "
                           f"(cudaError {err})")
    return out


# A2 launches inside a dispatcher operator, as E1 does
# (``ops/cuda_conv_encoder.py``), so that a profiler ties its kernel to it.
_OPS = torch.library.Library("mmla_audio", "FRAGMENT")
_OPS.define("conformer_attention(Tensor q, Tensor k, Tensor v, Tensor u, "
            "Tensor w, Tensor p, Tensor lens, bool split) -> Tensor")
_OPS.impl("conformer_attention", _launch, "CUDA")


def conformer_attention(q, k, v, u, w, p, lens) -> torch.Tensor:
    """``conformer_attention_plain``'s contract; on the card, kernel A2
    (operator ``torch.ops.mmla_audio.conformer_attention``)."""
    if q.device.type == "cpu":
        return conformer_attention_plain(q, k, v, u, w, p, lens)
    if q.device.type != "cuda":
        raise ValueError(f"conformer_attention: unsupported device "
                         f"{q.device}")
    if q.ndim != 4:
        raise ValueError(f"conformer_attention: q must be (B, H, T, d), got "
                         f"{tuple(q.shape)}")
    B, H, T, d = q.shape
    if d != HEAD_SIZE:
        raise ValueError(f"conformer_attention: the kernel takes heads of "
                         f"{HEAD_SIZE}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, T, d) or \
                t.device != q.device:
            raise ValueError(f"conformer_attention: {name} must be float32 "
                             f"{(B, H, T, d)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.stride() != q.stride() or t.stride(-1) != 1 or \
                any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError("conformer_attention: q, k and v must share "
                             "their strides, d contiguous, 16-byte aligned "
                             "rows")
    _check("u", u, (H, d), q.device)
    _check("w", w, (H, d), q.device)
    _check("p", p, (H, 2 * T - 1, d), q.device)
    _check("lens", lens, (B,), q.device, torch.int32)
    if p.data_ptr() % 16:
        raise ValueError("conformer_attention: p must be 16-byte aligned")
    if not B or not H:
        return torch.empty((B, T, H, d), dtype=torch.float32,
                           device=q.device).permute(0, 2, 1, 3)
    split = not torch.backends.cuda.matmul.allow_tf32
    out = torch.ops.mmla_audio.conformer_attention(q, k, v, u, w, p, lens,
                                                   split)
    conformer_attention.launches += 1
    conformer_attention.launches_split += split
    return out.permute(0, 2, 1, 3)


conformer_attention.launches = 0
conformer_attention.launches_split = 0
