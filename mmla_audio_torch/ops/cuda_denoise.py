"""Launchers of the denoise's two hand-written CUDA kernels.

D1 (``fixed_order_gemm_launch``) is an IEEE fp32 GEMM whose every output is
summed over K in one fixed order that depends on nothing but K, so a
window's STFT and ISTFT give the same bits alone and in any batch.  D2
(``smooth_mask_launch``) is the gate mask's smoothing as two banded passes
(frequency, then time) instead of the dense ``(K, K)`` and ``(T, T)``
matrices.  Neither replaces a Pallas kernel: the JAX package runs these
products as XLA GEMMs (``mmla_audio_tpu/ops/denoise.py``).  The source, with
its design and cost notes, is ``mmla_audio_torch/csrc/denoise.cu``, built
with nvcc for ``sm_90a`` at first use and bound with ctypes.

These functions check shapes and launch; they count nothing.  The wrappers
that dispatch on the device and count launches are ``ops.denoise.stft_ri``
and ``ops.denoise.istft_frames`` (D1) and ``ops.denoise.smooth_mask`` (D2).
"""

from __future__ import annotations

import torch

__all__ = ["SMOOTH_TILE_T", "launch_fixed_order_gemm", "launch_smooth_mask"]

# frames of one window a D2 block smooths: with the 6 halo frames of the
# 7-tap time band, 2 x 22 x 513 floats of shared memory (90 KB)
SMOOTH_TILE_T = 16


def _err(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_fixed_order_gemm(a: torch.Tensor, rows_per_group: int,
                            group_stride: int, row_stride: int, m: int,
                            k: int, b: torch.Tensor) -> torch.Tensor:
    """``C (m, N) = A @ b`` with row ``i`` of A read at ``a.data_ptr() +
    4 * ((i // rows_per_group) * group_stride + (i % rows_per_group) *
    row_stride)`` (``k`` contiguous floats), ``b (k, N)`` contiguous; all
    float32 on one CUDA device.  The caller guarantees every row lies
    inside ``a``."""
    from mmla_audio_torch._build import cuda_library

    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("fixed_order_gemm: float32 operands required")
    if b.ndim != 2 or b.shape[0] != k or not b.is_contiguous() \
            or b.device != a.device:
        raise ValueError(f"fixed_order_gemm: b must be a contiguous ({k}, N) "
                         f"tensor on {a.device}, got {tuple(b.shape)} on "
                         f"{b.device}")
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m:
        lib = cuda_library("denoise")
        with torch.cuda.device(a.device):
            _err("fixed_order_gemm", lib.fixed_order_gemm_launch(
                a.data_ptr(), rows_per_group, group_stride, row_stride, m, k,
                b.data_ptr(), n, out.data_ptr(), _stream(a)))
    return out


def launch_smooth_mask(mask: torch.Tensor, v_f: torch.Tensor,
                       v_t: torch.Tensor) -> torch.Tensor:
    """``mask (G, T, K)`` contiguous float32 on the card, taps ``v_f``
    (odd length) and ``v_t`` (odd length) float32 on the same device ->
    the smoothed ``(G, T, K)``."""
    from mmla_audio_torch._build import cuda_library

    if mask.ndim != 3 or not mask.is_contiguous() \
            or mask.dtype != torch.float32:
        raise ValueError(f"smooth_mask: a contiguous float32 (G, T, K) mask "
                         f"required, got {mask.dtype} {tuple(mask.shape)}")
    G, T, K = mask.shape
    out = torch.empty_like(mask)
    if mask.numel():
        lib = cuda_library("denoise")
        with torch.cuda.device(mask.device):
            _err("smooth_mask", lib.smooth_mask_launch(
                mask.data_ptr(), out.data_ptr(), G, T, K, v_f.data_ptr(),
                len(v_f), v_t.data_ptr(), len(v_t), SMOOTH_TILE_T,
                _stream(mask)))
    return out
