"""Deployment export and the compiled-program parity check (counterpart of
``mmla_audio_tpu.export``).

The reference deploys by converting the SavedModel to a fixed-shape TFLite
flatbuffer and asserting per-sample argmax parity between the two
(`tfl_convert.py:29-88`).  Here:

* ``export_serving`` writes the port's checkpoint directory
  (``train/checkpoints.py``: ``variables.npz`` and ``metadata.json``) with
  the model's name and the pinned serving ``input_shape`` in the
  metadata; ``load_serving`` reads it back;
* ``aot_compile(fn, *example_args)`` pins ``fn`` to the example
  arguments' shapes, dtypes and device, the counterpart of a program
  lowered and compiled for one signature.  On the card it warms ``fn`` up
  once and captures it into a ``torch.cuda.CUDAGraph`` over static input
  buffers: a call copies its arguments in and replays the graph.  A replay
  overwrites the outputs of the one before, so a caller that keeps them
  clones them.  On the CPU it is the same shape-pinned callable over the
  eager function.  Any other shape, dtype or device raises;
* ``parity_check`` asserts per-sample argmax equality.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch

from mmla_audio_torch.core.config import OverlapModelConfig, SpeakerModelConfig
from mmla_audio_torch.train.checkpoints import load_variables, save_variables

__all__ = ["export_serving", "load_serving", "aot_compile", "parity_check"]


def _is_speaker(keys) -> bool:
    return any(k.startswith(("trunk.", "params/trunk/")) for k in keys)


def export_serving(path, state_dict: Mapping[str, torch.Tensor], *,
                   input_shape, model_name: str, cfg=None,
                   extra_meta: dict | None = None) -> None:
    """Write a deployable bundle: the weights and the pinned serving
    signature.  ``cfg``: the model's config (default: that of the
    ``state_dict``'s kind, a speaker model's head as wide as its own)."""
    speaker = _is_speaker(state_dict)
    if cfg is None:
        cfg = SpeakerModelConfig() if speaker else OverlapModelConfig()
    head = int(state_dict["head.bias"].shape[0]) if speaker else None
    meta = {"model": model_name, "input_shape": list(input_shape)}
    meta.update(extra_meta or {})
    save_variables(path, state_dict, cfg, head, meta)


def load_serving(path, cfg=None) -> tuple[dict, dict]:
    """-> ``(state_dict, metadata)`` of an ``export_serving`` directory (or
    any checkpoint directory of the port)."""
    npz = Path(path) / "variables.npz"
    if not npz.exists():
        raise FileNotFoundError(f"{path}: no variables.npz (not a "
                                f"checkpoint directory of the port)")
    if cfg is None:
        with np.load(npz) as data:
            speaker = _is_speaker(data.files)
        cfg = SpeakerModelConfig() if speaker else OverlapModelConfig()
    state_dict, _ = load_variables(path, cfg)
    meta_path = Path(path) / "metadata.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return state_dict, meta


def _signature(args) -> tuple:
    return tuple((tuple(a.shape), a.dtype, a.device) for a in args)


def aot_compile(fn: Callable, *example_args: torch.Tensor) -> Callable:
    """``fn`` pinned to the signature of ``example_args`` (tensors, all on
    one device).  On a CUDA device: one warm-up call, then a CUDA-graph
    capture over static copies of the arguments."""
    if not example_args or not all(isinstance(a, torch.Tensor)
                                   for a in example_args):
        raise TypeError("aot_compile: example arguments must be tensors")
    sig = _signature(example_args)
    devices = {a.device for a in example_args}
    if len(devices) != 1:
        raise ValueError(f"aot_compile: arguments on several devices "
                         f"{devices}")
    (device,) = devices

    def check(args):
        got = _signature(args)
        if got != sig:
            raise ValueError(f"aot_compile: compiled for {sig}, called with "
                             f"{got}")

    if device.type == "cpu":
        def run(*args):
            check(args)
            return fn(*args)
        return run
    if device.type != "cuda":
        raise ValueError(f"aot_compile: unsupported device {device}")

    static = [a.detach().clone() for a in example_args]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*static)                               # builds tables, plans
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)

    def replay(*args):
        check(args)
        for buf, a in zip(static, args):
            buf.copy_(a)
        graph.replay()
        return out

    replay.graph = graph
    return replay


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def parity_check(eager_fn: Callable, compiled: Callable, inputs, *,
                 argmax_axis: int = -1) -> None:
    """`tfl_convert.py:64-88`: per-sample argmax agreement between the
    eager and the compiled function on ``inputs``; raises on a mismatch."""
    eager_out = _numpy(eager_fn(*inputs))
    compiled_out = _numpy(compiled(*inputs))
    np.testing.assert_array_equal(
        np.argmax(eager_out, axis=argmax_axis),
        np.argmax(compiled_out, axis=argmax_axis))
