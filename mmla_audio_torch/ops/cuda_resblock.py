"""The fused residual block's hand-written CUDA kernels, their plain version
and their wrapper.

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
``fused_resblock_plain``; a CUDA tensor launches a kernel or raises.  The
kernel is chosen by the width alone, ``block_route(C)``:

* ``C % 8 == 0`` (every stage of the full-width model): ``"mma"``, an
  implicit GEMM on the tensor cores in 3xTF32 (fp32 accuracy), tiled by
  ``plan_block_tiles``;
* any other width: ``"ffma"``, fp32 FMAs on the CUDA cores.

``fused_resblock_cuda.launches`` counts launches of both,
``.launches_mma`` those of the tensor-core kernel.  Both serve any width up
to ``FUSED_MAX_CHANNELS`` at any height and width (rows are cut into column
tiles when a whole one does not fit shared memory); ``check_block_width``
rejects a wider model when it is built for the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["FUSED_MAX_CHANNELS", "SM_SHARED_BYTES", "BlockPlan",
           "block_route", "block_smem_bytes", "block_tilings",
           "check_block_width", "fold_bn", "plan_block_tiles",
           "fused_resblock_plain", "fused_resblock_cuda"]

# The FFMA kernel's smallest tile, 4 output rows by 1 column of all C
# channels with its halo and two conv3x3 weight chunks, takes 424 * C bytes
# of shared memory; a Hopper block may have 227 KB.  The tensor-core
# kernel's smallest tile (1 row by 1 column) takes less at every width.
FUSED_MAX_CHANNELS = 548

# Hopper's shared memory: 228 KB an SM, at most 227 KB a block, and 1 KB
# the hardware reserves for each resident block.
SM_SHARED_BYTES = 233_472
BLOCK_SHARED_BYTES = 232_448
CTA_RESERVED_BYTES = 1_024
MMA_THREADS = 256
MMA_TILE_M = (1, 2, 3)           # m16 tiles a warp owns (4 spills registers)
MMA_WEIGHT_ROWS = 64             # at most this many weight rows per chunk
MMA_MIN_CHUNK = 24               # weight chunks at least this, where they fit


def block_route(channels: int) -> str:
    """The kernel a width takes on the card: ``"mma"`` (tensor cores,
    3xTF32) when ``channels % 8 == 0``, else ``"ffma"`` (CUDA cores)."""
    return "mma" if channels % 8 == 0 else "ffma"


class BlockPlan(NamedTuple):
    """How the tensor-core kernel tiles one sample: ``rows`` x ``cols``
    output pixels (all C channels) per CTA, ``row_tiles`` x ``col_tiles``
    CTAs, each warp owning ``mt`` m16 tiles by 32 output channels, weights
    streamed ``kc`` rows (of one tap and input channel each) at a time."""
    rows: int
    cols: int
    row_tiles: int
    col_tiles: int
    mt: int
    kc: int
    smem_bytes: int
    ctas_per_sm: int


def block_smem_bytes(C: int, rows: int, cols: int, kc: int) -> int:
    """Shared memory of one tensor-core CTA (the kernel's own formula):
    the activated input tile ((rows + 5) x (cols + 2) pixels) and the middle
    tile ((rows + 3) x cols), pixel-major with a channel stride of C + 4,
    and two weight chunks of ``kc`` rows with a stride of C + 8 (C + 16
    when C / 8 is odd), so that fragment loads are free of bank
    conflicts."""
    ws = C + (16 if (C // 8) % 2 else 8)
    return 4 * (((rows + 5) * (cols + 2) + (rows + 3) * cols) * (C + 4)
                + 2 * kc * ws)


def _equal_tiles(n: int):
    """(tile, count) for each distinct way of cutting n into equal tiles,
    smallest tile first."""
    return sorted({(-(-n // k), -(-n // -(-n // k))) for k in range(1, n + 1)})


def _gemm_fit(C: int, m: int, mt: int) -> tuple:
    """(rounds, empty m16 slots) of a GEMM of m rows in warp items of mt."""
    mtiles = -(-m // 16)
    items = -(-mtiles // mt) * -(-C // 32)
    return -(-items // (MMA_THREADS // 32)), -(-mtiles // mt) * mt - mtiles


@functools.lru_cache(maxsize=None)
def block_tilings(C: int, H: int, W: int,
                  smem_limit: int = SM_SHARED_BYTES) -> tuple:
    """The tensor-core kernel's tilings of one ``(C, H, W)`` sample, from
    the one that computes the fewest middle rows twice: whole image columns
    from the widest to one column (none twice), then one column cut into
    ever shorter equal rows ((rows + 3) / rows middle rows an output row).
    Each is kept if its CTA fits two to an SM with a weight chunk of at
    least ``MMA_MIN_CHUNK`` rows (failing any, of 8 rows; failing that, one
    CTA to an SM), with the largest chunk that fits (up to
    ``MMA_WEIGHT_ROWS``) and the warp tile of fewest rounds, then fewest
    empty m16 slots, then the largest, over its middle rows."""
    tilings = ([(H, 1, cols, n) for cols, n in reversed(_equal_tiles(W))]
               + [(rows, n, 1, W) for rows, n in reversed(_equal_tiles(H))
                  if rows < H])
    for ctas, min_kc in ((2, MMA_MIN_CHUNK), (2, 8), (1, 8)):
        budget = min(BLOCK_SHARED_BYTES,
                     smem_limit // ctas - CTA_RESERVED_BYTES)
        found = []
        for rows, row_tiles, cols, col_tiles in tilings:
            kc = next((k for k in range(MMA_WEIGHT_ROWS, min_kc - 1, -8)
                       if block_smem_bytes(C, rows, cols, k) <= budget), None)
            if kc is None:
                continue
            mid = min(rows + 3, H) * cols
            mt = min(MMA_TILE_M, key=lambda m: (*_gemm_fit(C, mid, m), -m))
            found.append(BlockPlan(rows, cols, row_tiles, col_tiles, mt, kc,
                                   block_smem_bytes(C, rows, cols, kc), ctas))
        if found:
            return tuple(found)
    raise ValueError(f"plan_block_tiles: no tile of C={C} fits "
                     f"{smem_limit} bytes")


@functools.lru_cache(maxsize=1024)
def plan_block_tiles(C: int, H: int, W: int, smem_limit: int, batch: int,
                     sms: int) -> BlockPlan:
    """The tensor-core kernel's tiles for a ``(batch, C, H, W)`` block on a
    card with ``sms`` SMs of ``smem_limit`` bytes of shared memory each:
    the last of ``block_tilings`` whose batch's CTAs fit one to an SM (one
    wave), else the first.  From B=64 on, at every full-width shape, that
    is the widest whole image columns, the fastest of the plans timed there
    (``scripts/resblock_probe.py sweep``)."""
    if C <= 0 or C % 8:
        raise ValueError(f"plan_block_tiles: C % 8 == 0 required, got {C}")
    tilings = block_tilings(C, H, W, smem_limit)
    wave = [p for p in tilings if batch * p.row_tiles * p.col_tiles <= sms]
    return wave[-1] if wave else tilings[0]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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

        lib = cuda_library("fused_resblock")
        ptrs = (x.data_ptr(), out.data_ptr(),
                *(a.data_ptr() for a in args[1:]))
        mma = block_route(C) == "mma"
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if mma:
                plan = plan_block_tiles(C, H, W, SM_SHARED_BYTES, B,
                                        _sm_count(x.device))
                err = lib.fused_resblock_mma_launch(
                    *ptrs, B, C, H, W, plan.rows, plan.cols, plan.mt,
                    plan.kc, stream)
            else:
                err = lib.fused_resblock_launch(*ptrs, B, C, H, W, stream)
        if err != 0:
            raise RuntimeError(f"fused_resblock kernel launch failed "
                               f"(cudaError {err})")
        fused_resblock_cuda.launches += 1
        fused_resblock_cuda.launches_mma += mma
    return out


fused_resblock_cuda.launches = 0
fused_resblock_cuda.launches_mma = 0


def _operand(a: torch.Tensor, shape, device) -> torch.Tensor:
    if tuple(a.shape) != shape or a.dtype != torch.float32 or \
            a.device != device or not a.is_contiguous() or \
            a.data_ptr() % 16:
        raise ValueError(f"fused_resblock_cuda: operand must be a contiguous, "
                         f"16-byte aligned float32 {shape} on {device}, got "
                         f"{a.dtype} {tuple(a.shape)} on {a.device}")
    return a
