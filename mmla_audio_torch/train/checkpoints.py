"""Checkpoints of the speaker and overlap models and the enrolled-corpus
feature cache (counterpart of ``mmla_audio_tpu.train.checkpoints``).

The JAX package saves Orbax checkpoints, which the card's machine cannot
read.  The port saves the flat ``.npz`` of ``params.py`` instead, the file
``--weights`` reads and a JAX host loads with ``np.load``:
``path/variables.npz`` plus ``path/metadata.json``.  The model config's
type says which model a checkpoint holds.  ``BestCheckpointer`` mirrors
Keras ``ModelCheckpoint(save_best_only=True)``.  The feature cache
keeps the JAX package's ``experiment_feature.npz`` (keys ``x``, ``y``) and
``.json`` (``speaker_id_dict``) pair and its suffix rule, so either package
reads the other's (`speaker_identification.py:485-489`).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from mmla_audio_torch.core.config import OverlapModelConfig, SpeakerModelConfig
from mmla_audio_torch.params import (load_overlap_npz, load_speaker_npz,
                                     overlap_state_dict_from_jax,
                                     overlap_tree_from_state_dict, save_npz,
                                     speaker_state_dict_from_jax,
                                     speaker_tree_from_state_dict)

__all__ = ["save_variables", "load_variables", "BestCheckpointer",
           "save_feature_cache", "load_feature_cache"]


ModelConfig = Union[SpeakerModelConfig, OverlapModelConfig]


def save_variables(path, state_dict: Mapping[str, torch.Tensor],
                   cfg: ModelConfig = SpeakerModelConfig(),
                   head_units: int | None = None,
                   metadata: Optional[dict] = None) -> None:
    """A ``SpeakerResBLSTM(cfg, head_units)`` or ``OverlapResBLSTM(cfg)``
    state_dict -> ``path/variables.npz`` (and ``path/metadata.json`` if
    given)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tree = overlap_tree_from_state_dict(state_dict, cfg) \
        if isinstance(cfg, OverlapModelConfig) else \
        speaker_tree_from_state_dict(state_dict, cfg, head_units)
    save_npz(tree, path / "variables.npz")
    if metadata is not None:
        (path / "metadata.json").write_text(json.dumps(metadata))


def load_variables(path, cfg: ModelConfig = SpeakerModelConfig()
                   ) -> tuple[Dict[str, torch.Tensor], Optional[int]]:
    """``path/variables.npz`` -> ``(state_dict, head_units)``; a speaker
    head's width is the file's, an overlap model's ``head_units`` None."""
    npz = Path(path) / "variables.npz"
    if isinstance(cfg, OverlapModelConfig):
        return overlap_state_dict_from_jax(load_overlap_npz(npz, cfg),
                                           cfg), None
    tree, head_units = load_speaker_npz(npz, cfg)
    return speaker_state_dict_from_jax(tree, cfg, head_units), head_units


class BestCheckpointer:
    """Keras ModelCheckpoint(save_best_only=True): saves when ``metric``
    improves (``monitor_mode`` "max" or "min")."""

    def __init__(self, path, cfg: ModelConfig = SpeakerModelConfig(),
                 head_units: int | None = None, monitor_mode: str = "max"):
        self.path = Path(path)
        self.cfg = cfg
        self.head_units = head_units
        self.mode = monitor_mode
        self.best: Optional[float] = None

    def update(self, metric: float, state_dict: Mapping[str, torch.Tensor],
               metadata: Optional[dict] = None) -> bool:
        better = (self.best is None
                  or (metric > self.best if self.mode == "max"
                      else metric < self.best))
        if better:
            self.best = float(metric)
            meta = dict(metadata or {})
            meta["best_metric"] = self.best
            save_variables(self.path, state_dict, self.cfg, self.head_units,
                           meta)
        return better


def _cache_paths(path) -> tuple[Path, Path]:
    """np.savez appends '.npz' while Path.with_suffix replaces an existing
    suffix: one rule for both sides, so a dotted stem like 'cache.v1'
    saves and loads 'cache.v1.npz'."""
    s = str(path)
    base = s[:-4] if s.endswith(".npz") else s
    return Path(base + ".npz"), Path(base + ".json")


def save_feature_cache(path, x: np.ndarray, y: np.ndarray,
                       speaker_id_dict: Dict[str, str]) -> None:
    """``experiment_feature.npz`` + its ``speaker_id_dict`` ``.json``."""
    npz, js = _cache_paths(path)
    npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez(npz, x=x, y=y)
    js.write_text(json.dumps(speaker_id_dict))


def load_feature_cache(path):
    """-> ``(x, y, speaker_id_dict)``."""
    npz, js = _cache_paths(path)
    with np.load(npz) as data:
        x, y = data["x"], data["y"]
    return x, y, json.loads(js.read_text())
