"""Batched webrtcvad over a stacked detector state (counterpart of the
batched use of ``mmla_audio_tpu.vad.webrtc`` in the multiplexer).

Each stream's detector state (the reference's long-lived ``Vad(3)``) is
one row of an ``(n, 265)`` int32 tensor: the slots of the host engine's
``wv_get_state``, in the order of the JAX ``WebRtcVadState`` fields
(``STATE_FIELDS``).  ``webrtc_vad_rows`` runs one window per row against
the rows that ``idx`` names and updates them in place:

* for a CUDA tensor it launches W1, the engine of ``csrc/webrtc_vad.cu``
  (a block of four warps a stream, its filterbank and GMM pipelined across
  frames), or raises;
* for a CPU tensor it runs the plain version, ``webrtc_vad_rows_plain``:
  the native host engine once per row, its state set from the row before
  and read back after.

Both are bit-identical to the host engine, decisions and state.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["STATE_FIELDS", "WEBRTC_STATE_SLOTS", "webrtc_init",
           "webrtc_vad_rows", "webrtc_vad_rows_plain", "launch_webrtc_rows",
           "state_rows_from_jax", "state_rows_to_jax"]

# (field, shape) of one detector state, in slot order
STATE_FIELDS = (("ds_state", (2,)), ("upper_state", (5,)),
                ("lower_state", (5,)), ("hp_state", (4,)),
                ("noise_means", (2, 6)), ("speech_means", (2, 6)),
                ("noise_stds", (2, 6)), ("speech_stds", (2, 6)),
                ("low_values", (6, 16)), ("ages", (6, 16)),
                ("mean_value", (6,)), ("frame_counter", ()),
                ("over_hang", ()), ("num_of_speech", ()))
WEBRTC_STATE_SLOTS = 265

# WebRtcVad_InitCore (published WebRTC tables, (k, channel) layout)
_INIT = {
    "noise_means": [[6738, 4892, 7065, 6715, 6771, 3369],
                    [7646, 3863, 7820, 7266, 5020, 4362]],
    "speech_means": [[8306, 10085, 10078, 11823, 11843, 6309],
                     [9473, 9571, 10879, 7581, 8180, 7483]],
    "noise_stds": [[378, 1064, 493, 582, 688, 593],
                   [474, 697, 475, 688, 421, 455]],
    "speech_stds": [[555, 505, 567, 524, 585, 1231],
                    [509, 828, 492, 1540, 1079, 850]],
    "low_values": np.full((6, 16), 10000),
    "ages": np.full((6, 16), 100),
    "mean_value": np.full(6, 1600),
}
# 16 kHz frames the engine takes (10, 20, 30 ms); 8 kHz: the same halved
_FRAMES = {16000: (160, 320, 480), 8000: (80, 160, 240)}


def _fresh_row() -> np.ndarray:
    return np.concatenate([
        np.asarray(_INIT.get(name, np.zeros(shape)), np.int32).ravel()
        for name, shape in STATE_FIELDS])


def webrtc_init(n: int, device: torch.device | str = "cuda") -> torch.Tensor:
    """``(n, 265)`` int32 rows of fresh detector state on ``device``."""
    return torch.from_numpy(np.tile(_fresh_row(), (n, 1))).to(device)


def state_rows_from_jax(leaves: Mapping[str, np.ndarray]) -> np.ndarray:
    """JAX ``WebRtcVadState`` fields (numpy, any common batch shape, e.g.
    ``state._asdict()``) -> ``(n, 265)`` int32 rows."""
    batch = np.shape(leaves["frame_counter"])
    n = int(np.prod(batch))
    return np.concatenate([
        np.asarray(leaves[name], np.int32).reshape(n, -1)
        for name, _ in STATE_FIELDS], axis=1)


def state_rows_to_jax(rows) -> dict:
    """The inverse: ``(n, 265)`` rows -> ``{field: (n, *shape) int32}``."""
    rows = np.asarray(torch.as_tensor(rows).cpu(), np.int32)
    out, i = {}, 0
    for name, shape in STATE_FIELDS:
        size = int(np.prod(shape))
        out[name] = rows[:, i: i + size].reshape((len(rows),) + shape)
        i += size
    return out


def _check(i16, states, idx, mode, frame_len, sample_rate) -> np.ndarray:
    """Validate the arguments; the host copy of ``idx``."""
    if mode not in (0, 1, 2, 3):
        raise ValueError(f"invalid aggressiveness mode: {mode}")
    if frame_len not in _FRAMES.get(sample_rate, ()):
        raise ValueError(f"invalid frame length {frame_len} @ "
                         f"{sample_rate} Hz")
    if i16.dtype != torch.int16 or i16.ndim != 2 or i16.stride(-1) != 1:
        raise ValueError(f"i16 must be (B, n) int16 with contiguous rows, "
                         f"got {i16.dtype} {tuple(i16.shape)}")
    if (states.dtype != torch.int32 or states.ndim != 2
            or states.shape[1] != WEBRTC_STATE_SLOTS
            or not states.is_contiguous()):
        raise ValueError(f"states must be contiguous (n, "
                         f"{WEBRTC_STATE_SLOTS}) int32, got {states.dtype} "
                         f"{tuple(states.shape)}")
    if states.device != i16.device:
        raise ValueError(f"i16 on {i16.device}, states on {states.device}")
    if isinstance(idx, torch.Tensor):
        if idx.device.type != "cpu":
            raise ValueError("idx must lie on the host (it is checked there)")
        idx = idx.numpy()
    idx = np.ascontiguousarray(idx, np.int32)
    if idx.shape != (i16.shape[0],):
        raise ValueError(f"idx must have shape ({i16.shape[0]},), got "
                         f"{idx.shape}")
    if (idx < 0).any():
        raise ValueError("idx must be non-negative")
    valid = idx[idx < states.shape[0]]
    if len(np.unique(valid)) != len(valid):
        raise ValueError("two rows of one call name the same state row: "
                         "a stream may contribute one window a call")
    return idx


def webrtc_vad_rows_plain(i16: torch.Tensor, states: torch.Tensor, idx,
                          *, mode: int = 3, frame_len: int = 480,
                          sample_rate: int = 16000) -> torch.Tensor:
    """The plain version on CPU tensors: the native host engine once per
    row, ``states[idx[b]]`` set before and written back after."""
    from mmla_audio_torch.vad.native import NativeWebRtcVad

    idx = _check(i16, states, idx, mode, frame_len, sample_rate)
    B, T = i16.shape[0], i16.shape[1] // frame_len
    out = torch.zeros((B, T), dtype=torch.uint8)
    engine = NativeWebRtcVad(mode)
    rows = states.numpy()
    samples = i16.numpy()
    for b, row in enumerate(idx):
        if row >= len(rows):
            continue
        engine.state_array = rows[row]
        out[b] = torch.from_numpy(engine.decisions(
            samples[b, : T * frame_len], frame_len=frame_len,
            sample_rate=sample_rate).astype(np.uint8))
        rows[row] = engine.state_array
    return out


def launch_webrtc_rows(i16: torch.Tensor, states: torch.Tensor,
                       idx: np.ndarray, frame_len: int, sample_rate: int,
                       mode: int) -> torch.Tensor:
    """Launch W1 on checked CUDA arguments (``idx`` the host array
    ``_check`` returned), one block a stream: ``(B, T)`` uint8 decisions.
    Counts nothing: the wrapper does."""
    from mmla_audio_torch._build import cuda_library

    B, T = i16.shape[0], i16.shape[1] // frame_len
    out = torch.empty((B, T), dtype=torch.uint8, device=i16.device)
    if B == 0:
        return out
    # pageable source: the copy is staged before the call returns, and a
    # blocking copy would wait for all the stream's queued work
    idx_dev = torch.from_numpy(idx).to(i16.device, non_blocking=True)
    launch = cuda_library("webrtc_vad").webrtc_vad_launch
    with torch.cuda.device(i16.device):
        stream = torch.cuda.current_stream(i16.device).cuda_stream
        err = launch(i16.data_ptr(), i16.stride(0), B, T, frame_len,
                     int(sample_rate == 16000), mode, states.data_ptr(),
                     states.shape[0], idx_dev.data_ptr(), out.data_ptr(),
                     stream)
    if err != 0:
        raise RuntimeError(f"webrtc_vad kernel launch failed (cudaError "
                           f"{err})")
    return out


def webrtc_vad_rows(i16: torch.Tensor, states: torch.Tensor, idx, *,
                    mode: int = 3, frame_len: int = 480,
                    sample_rate: int = 16000) -> torch.Tensor:
    """Per-frame decisions ``(B, T)`` uint8 of ``i16 (B, n)`` int16 windows
    (``T = n // frame_len`` contiguous frames a row), advancing the detector
    state ``states[idx[b]]`` in place.

    ``idx (B,)``: a host array (numpy or CPU tensor).  A row whose index is
    ``states.shape[0]`` or more is padding: it reads and writes no state and
    its decisions are 0.  No two other rows may share an index (raises).
    CUDA tensors launch W1; CPU tensors take the plain version."""
    if i16.device.type == "cpu":
        return webrtc_vad_rows_plain(i16, states, idx, mode=mode,
                                     frame_len=frame_len,
                                     sample_rate=sample_rate)
    if i16.device.type != "cuda":
        raise ValueError(f"webrtc_vad_rows: unsupported device {i16.device}")
    idx = _check(i16, states, idx, mode, frame_len, sample_rate)
    out = launch_webrtc_rows(i16, states, idx, frame_len, sample_rate, mode)
    if len(idx):
        webrtc_vad_rows.launches += 1
    return out


webrtc_vad_rows.launches = 0
