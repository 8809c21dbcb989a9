"""WebRTC-style VAD gating (counterpart of ``mmla_audio_tpu.vad.collector``).

The reference's ``frame_generator`` + ``vad_collector`` state machine
(`record_on_pc.py:229-295`), given per-frame speech decisions:

* 30 ms frames (480 samples at 16 kHz); a frame exists iff
  ``offset + frame < n_samples`` (strict).
* Hysteresis over a 10-frame ring: NOTTRIGGERED -> TRIGGERED when more than
  90 % of the ring's maximum length is voiced (the ring is then emitted
  retroactively), TRIGGERED -> NOTTRIGGERED when more than 90 % is unvoiced;
  the ring clears at both transitions.
* Output: the emitted frames concatenated in order.

A window has at most 85 frames, so the single-window collector is a Python
loop on the host; only the compaction of the kept frames touches the
window's device.  The batched form (``vad_collect_rows``, ``vad_trim_batch``)
keeps the whole chain on the device: for CUDA tensors its keep masks come
from W2, the kernel of ``csrc/webrtc_vad.cu`` (one warp a row over 32-frame
bitmasks), and for CPU tensors from ``collect_mask`` once per row.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

__all__ = ["frame_count", "collect_mask", "apply_mask", "vad_trim",
           "vad_collect_rows", "vad_collect_rows_plain", "vad_trim_batch",
           "energy_vad", "calibrate_threshold"]


def frame_count(n_samples: int, frame_len: int = 480) -> int:
    """Frame count for a full buffer (strict `<`, record_on_pc.py:240)."""
    if n_samples <= frame_len:
        return 0
    return (n_samples - frame_len - 1) // frame_len + 1


def collect_mask(is_speech, valid=None, ring: int = 10) -> torch.Tensor:
    """vad_collector keep-mask over per-frame decisions ``is_speech (T,)``.

    ``valid (T,)`` marks the frames that exist and must be a prefix mask
    (True then False).  Returns a CPU bool tensor ``(T,)``: which frames
    appear in the concatenated output, in order."""
    speech = torch.as_tensor(is_speech).to("cpu", torch.bool).tolist()
    T = len(speech)
    ok = [True] * T if valid is None else \
        torch.as_tensor(valid).to("cpu", torch.bool).tolist()
    keep = [False] * T
    thresh = 0.9 * ring
    buf: deque = deque(maxlen=ring)
    triggered = False
    for i in range(T):
        if not ok[i]:
            break
        buf.append((i, speech[i]))
        if not triggered:
            if sum(s for _, s in buf) > thresh:
                triggered = True
                for j, _ in buf:
                    keep[j] = True
                buf.clear()
        else:
            keep[i] = True
            if sum(not s for _, s in buf) > thresh:
                triggered = False
                buf.clear()
    return torch.tensor(keep, dtype=torch.bool)


def apply_mask(frames: torch.Tensor, keep: torch.Tensor
               ) -> tuple[torch.Tensor, int]:
    """Compact kept frames to the front: ``frames (T, L)``, ``keep (T,)`` ->
    (compacted ``(T, L)`` zero-padded, number of samples kept)."""
    idx = torch.nonzero(keep.cpu(), as_tuple=True)[0].to(frames.device)
    out = torch.zeros_like(frames)
    out[: idx.numel()] = frames[idx]
    return out, idx.numel() * frames.shape[1]


def vad_trim(buf: torch.Tensor, n_samples: int, is_speech,
             frame_len: int = 480, ring: int = 10
             ) -> tuple[torch.Tensor, int]:
    """Trim one window: ``buf (max_samples,)`` + valid count + per-frame
    decisions -> (trimmed buffer ``(max_samples,)``, zero beyond the new
    count; new count).  The output is the collector's segments concatenated
    (`record_on_pc.py:214-226`)."""
    T = frame_count(buf.shape[-1], frame_len)
    valid = (np.arange(T) * frame_len + frame_len) < int(n_samples)
    keep = collect_mask(torch.as_tensor(is_speech)[:T], valid, ring)
    compacted, n_out = apply_mask(buf[: T * frame_len].reshape(T, frame_len),
                                  keep)
    out = torch.zeros_like(buf)
    out[: T * frame_len] = compacted.reshape(-1)
    return out, n_out


def _valid_frames(n_samples: torch.Tensor, T: int,
                  frame_len: int = 480) -> torch.Tensor:
    """Frames that exist for each row's valid count ``(B,)``: the number of
    ``t < T`` with ``t * frame_len + frame_len < n`` (strict, as
    ``vad_trim``)."""
    n = n_samples.to(torch.int64)
    count = torch.div(n - frame_len - 1, frame_len, rounding_mode="floor") + 1
    return torch.clamp(count, 0, T).to(torch.int32)


def _check_rows(decisions: torch.Tensor, n_valid: torch.Tensor) -> None:
    if decisions.ndim != 2 or decisions.dtype not in (torch.bool,
                                                      torch.uint8):
        raise ValueError(f"decisions must be (B, T) bool or uint8, got "
                         f"{decisions.dtype} {tuple(decisions.shape)}")
    if n_valid.shape != decisions.shape[:1] or \
            n_valid.device != decisions.device:
        raise ValueError(f"n_valid must be ({decisions.shape[0]},) on "
                         f"{decisions.device}, got {tuple(n_valid.shape)} on "
                         f"{n_valid.device}")


def vad_collect_rows_plain(decisions: torch.Tensor, n_valid: torch.Tensor,
                           ring: int = 10
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``collect_mask`` once per row, frames ``t <
    n_valid[b]`` valid.  Returns ``(keep (B, T) bool, kept frames (B,)
    int32)`` on the CPU."""
    _check_rows(decisions, n_valid)
    T = decisions.shape[1]
    keep = torch.stack([
        collect_mask(row, torch.arange(T) < int(nv), ring)
        for row, nv in zip(decisions.cpu(), n_valid.cpu())]) \
        if len(decisions) else torch.zeros((0, T), dtype=torch.bool)
    return keep, keep.sum(dim=1, dtype=torch.int32)


def vad_collect_rows(decisions: torch.Tensor, n_valid: torch.Tensor,
                     ring: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """vad_collector keep masks of many rows: ``decisions (B, T)`` (bool or
    uint8) and the count of existing frames ``n_valid (B,)`` ->
    ``(keep (B, T) bool, kept frames (B,) int32)`` on their device.  CUDA
    tensors launch W2; CPU tensors take the plain version."""
    if decisions.device.type == "cpu":
        return vad_collect_rows_plain(decisions, n_valid, ring)
    if decisions.device.type != "cuda":
        raise ValueError(f"vad_collect_rows: unsupported device "
                         f"{decisions.device}")
    from mmla_audio_torch._build import cuda_library

    _check_rows(decisions, n_valid)
    B, T = decisions.shape
    # a bool tensor is 0/1 bytes: its uint8 view needs no kernel of its own
    dec = (decisions.view(torch.uint8) if decisions.dtype == torch.bool
           else decisions).contiguous()
    nv = n_valid.to(torch.int32).contiguous()
    keep = torch.empty((B, T), dtype=torch.uint8, device=dec.device)
    kept = torch.empty((B,), dtype=torch.int32, device=dec.device)
    if B == 0:
        return keep.view(torch.bool), kept
    launch = cuda_library("webrtc_vad").vad_collect_launch
    with torch.cuda.device(dec.device):
        stream = torch.cuda.current_stream(dec.device).cuda_stream
        err = launch(dec.data_ptr(), B, T, nv.data_ptr(), 0.9 * ring, ring,
                     keep.data_ptr(), kept.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vad_collect kernel launch failed (cudaError "
                           f"{err})")
    vad_collect_rows.launches += 1
    # W2 writes 0 or 1 a byte: the bool view is the same bits
    return keep.view(torch.bool), kept


vad_collect_rows.launches = 0


def vad_trim_batch(i16: torch.Tensor, n_samples: torch.Tensor,
                   decisions: torch.Tensor, frame_len: int = 480,
                   ring: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """``vad_trim`` of every row at once, on the rows' device without a
    host round trip: ``i16 (B, n)`` + valid counts ``(B,)`` + decisions
    ``(B, T)`` -> (trimmed ``(B, n)`` float32, each row's kept frames in
    order then zeros; kept samples ``(B,)`` int32)."""
    B, n = i16.shape
    T = frame_count(n, frame_len)
    keep, kept = vad_collect_rows(decisions[:, :T],
                                  _valid_frames(n_samples, T, frame_len), ring)
    # kept frame indices first, in order (a stable sort of "not kept")
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    frames = i16[:, : T * frame_len].reshape(B, T, frame_len)
    compacted = torch.gather(frames, 1,
                             order[:, :, None].expand(B, T, frame_len))
    live = torch.arange(T, device=i16.device)[None, :] < kept[:, None]
    out = torch.zeros((B, n), dtype=torch.float32, device=i16.device)
    out[:, : T * frame_len] = torch.where(
        live[:, :, None], compacted, torch.zeros_like(compacted)
    ).reshape(B, T * frame_len)
    return out, kept * frame_len


def energy_vad(frames: torch.Tensor, threshold_db) -> torch.Tensor:
    """Per-frame speech decision: log mean-square energy (int16 scale) above
    the calibrated threshold (a float, or a tensor broadcast against the
    frames' leading axes)."""
    energy = torch.mean(torch.square(frames.to(torch.float32)), dim=-1)
    db = 10.0 * torch.log10(torch.clamp(energy, min=1e-10))
    return db > threshold_db


# Margin (dB above the ambient-noise floor) per webrtcvad aggressiveness.
_AGGR_MARGIN_DB = {0: 3.0, 1: 6.0, 2: 9.0, 3: 12.0}


def calibrate_threshold(noise_clip: np.ndarray, aggressiveness: int = 3,
                        frame_len: int = 480) -> float:
    """Energy-VAD threshold: ambient-noise frame-energy p95 + the margin for
    ``aggressiveness``.  ``noise_clip``: int16-scale samples."""
    n = (len(noise_clip) // frame_len) * frame_len
    if n == 0:
        return -40.0 + _AGGR_MARGIN_DB[aggressiveness]
    frames = np.asarray(noise_clip[:n], np.float32).reshape(-1, frame_len)
    energy = np.mean(np.square(frames), axis=-1)
    db = 10.0 * np.log10(np.maximum(energy, 1e-10))
    return float(np.percentile(db, 95) + _AGGR_MARGIN_DB[aggressiveness])
