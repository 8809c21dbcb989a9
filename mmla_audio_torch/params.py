"""Flax parameter trees -> PyTorch ``state_dict``s.

The JAX package keeps an ``OverlapResBLSTM``'s or a ``SpeakerResBLSTM``'s
weights as a nested dict ``{"params": ..., "batch_stats": ...}`` (Flax
module names as keys).  The converters take that tree as nested dicts of
numpy arrays, so neither Flax nor JAX is needed to call them.

Weights travel as a flat ``.npz`` (``save_npz``; ``load_overlap_npz``,
``load_speaker_npz``): one array per leaf, keyed by the ``/``-joined path of
the tree, e.g. ``params/stage0_block1/Conv_0/kernel``,
``batch_stats/stage0_block0/KerasBatchNorm_0/BatchNorm_0/var`` or
``params/trunk/stage1_unit0/shortcut/kernel``; a JAX host writes it from
its variables with ``np.savez``.

Layout changes: 2-D conv kernels HWIO -> OIHW, 1-D ones (K, Cin, Cout) ->
(Cout, Cin, K); Dense and LSTM kernels are transposed ((in, out) -> (out,
in)); the Keras LSTM's single ``bias`` goes to ``bias_ih`` with ``bias_hh =
0``; BatchNorm ``scale``/``bias``/``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var``.
``overlap_tree_from_state_dict`` and ``speaker_tree_from_state_dict`` are
the inverses, for a model the port trained: they write the LSTM's
``bias_ih + bias_hh`` as the Keras bias.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping

import numpy as np
import torch

from mmla_audio_torch.core.config import OverlapModelConfig, SpeakerModelConfig

__all__ = ["overlap_tree_shapes", "overlap_state_dict_from_jax",
           "overlap_tree_from_state_dict", "load_overlap_npz", "save_npz",
           "speaker_tree_shapes", "speaker_state_dict_from_jax",
           "speaker_tree_from_state_dict", "load_speaker_npz"]


def _conv(kh, kw, cin, cout):
    return {"kernel": (kh, kw, cin, cout), "bias": (cout,)}


def _bn_shapes(c):
    """A KerasBatchNorm's (params, batch_stats) shapes."""
    return ({"BatchNorm_0": {"scale": (c,), "bias": (c,)}},
            {"BatchNorm_0": {"mean": (c,), "var": (c,)}})


def _blocks(cfg: OverlapModelConfig):
    """(Flax block name, torch block index, in channels, filters, pool)."""
    ch, i = cfg.stem_filters, 0
    for s, f in enumerate(cfg.stage_filters):
        for b in range(cfg.blocks_per_stage):
            yield f"stage{s}_block{b}", i, ch, f, b == 0
            ch, i = f, i + 1


def overlap_tree_shapes(cfg: OverlapModelConfig = OverlapModelConfig()
                        ) -> Dict[str, Any]:
    """The Flax variable tree of ``OverlapResBLSTM(cfg)`` with a shape tuple
    at every leaf."""
    params: Dict[str, Any] = {"stem": _conv(1, 1, 3, cfg.stem_filters)}
    stats: Dict[str, Any] = {}
    for name, _, ch, f, pool in _blocks(cfg):
        blk = {"Conv_0": _conv(3, 3, ch, f), "Conv_1": _conv(4, 1, f, f)}
        st = {}
        for j, c in enumerate((ch, f)):
            blk[f"KerasBatchNorm_{j}"], st[f"KerasBatchNorm_{j}"] = \
                _bn_shapes(c)
        if pool:
            blk["shortcut"] = _conv(1, 1, ch, f)
        params[name], stats[name] = blk, st
    H, C = cfg.lstm_units, cfg.stage_filters[-1]
    params["BiLSTM_0"] = {
        d: {"kernel": (C, 4 * H), "recurrent_kernel": (H, 4 * H),
            "bias": (4 * H,)}
        for d in ("forward", "backward")}
    params["head"] = {"kernel": (2 * H, cfg.num_classes),
                      "bias": (cfg.num_classes,)}
    return {"params": params, "batch_stats": stats}


def _check(tree: Mapping, shapes: Mapping, path: str = "") -> None:
    if set(tree) != set(shapes):
        raise ValueError(f"parameter tree mismatch at '{path or '/'}': "
                         f"got {sorted(tree)}, expected {sorted(shapes)}")
    for k, want in shapes.items():
        if isinstance(want, dict):
            _check(tree[k], want, f"{path}/{k}")
        elif np.shape(tree[k]) != want:
            raise ValueError(f"parameter '{path}/{k}' has shape "
                             f"{np.shape(tree[k])}, expected {want}")


def _put(sd, key, a) -> None:
    sd[key] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _bn(sd, prefix, pnode, snode) -> None:
    pnode, snode = pnode["BatchNorm_0"], snode["BatchNorm_0"]
    _put(sd, f"{prefix}.weight", pnode["scale"])
    _put(sd, f"{prefix}.bias", pnode["bias"])
    _put(sd, f"{prefix}.running_mean", snode["mean"])
    _put(sd, f"{prefix}.running_var", snode["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _lstm(sd, prefix, node) -> None:
    """A Keras BiLSTM's two directions into ``nn.LSTM(bidirectional)``."""
    for d, sfx in (("forward", ""), ("backward", "_reverse")):
        _put(sd, f"{prefix}.weight_ih_l0{sfx}",
             np.asarray(node[d]["kernel"]).T)
        _put(sd, f"{prefix}.weight_hh_l0{sfx}",
             np.asarray(node[d]["recurrent_kernel"]).T)
        _put(sd, f"{prefix}.bias_ih_l0{sfx}", node[d]["bias"])
        _put(sd, f"{prefix}.bias_hh_l0{sfx}", np.zeros_like(node[d]["bias"]))


def overlap_state_dict_from_jax(tree: Mapping[str, Any],
                                cfg: OverlapModelConfig = OverlapModelConfig()
                                ) -> Dict[str, torch.Tensor]:
    """Flax tree of numpy arrays -> ``OverlapResBLSTM(cfg)`` state_dict."""
    _check(tree, overlap_tree_shapes(cfg))
    p, s = tree["params"], tree["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    put = functools.partial(_put, sd)

    def conv(prefix, node):
        put(f"{prefix}.weight", np.transpose(node["kernel"], (3, 2, 0, 1)))
        put(f"{prefix}.bias", node["bias"])

    conv("stem", p["stem"])
    for name, i, _, _, pool in _blocks(cfg):
        pre = f"blocks.{i}"
        if pool:
            conv(f"{pre}.shortcut", p[name]["shortcut"])
        for j in (0, 1):
            _bn(sd, f"{pre}.bn{j}", p[name][f"KerasBatchNorm_{j}"],
                s[name][f"KerasBatchNorm_{j}"])
            conv(f"{pre}.conv{j}", p[name][f"Conv_{j}"])
    _lstm(sd, "bilstm.lstm", p["BiLSTM_0"])
    put("head.weight", np.asarray(p["head"]["kernel"]).T)
    put("head.bias", p["head"]["bias"])
    return sd


def _conv1d(k, cin, cout):
    return {"kernel": (k, cin, cout), "bias": (cout,)}


def _units(cfg: SpeakerModelConfig):
    """(Flax unit name, torch unit index, in channels, filters, pool)."""
    ch, i = cfg.stem_filters, 0
    for s, f in enumerate(cfg.stage_filters):
        for b in range(cfg.blocks_per_stage):
            yield f"stage{s}_unit{b}", i, ch, f, b == 0
            ch, i = f, i + 1


def speaker_tree_shapes(cfg: SpeakerModelConfig = SpeakerModelConfig(),
                        head_units: int | None = None) -> Dict[str, Any]:
    """The Flax variable tree of ``SpeakerResBLSTM(cfg, head_units)`` on
    MFCC-39 input ``(B, T, 39)``, with a shape tuple at every leaf."""
    trunk: Dict[str, Any] = {"stem": _conv1d(cfg.stem_kernel, 39,
                                             cfg.stem_filters)}
    stats: Dict[str, Any] = {}
    for name, _, cin, f, pool in _units(cfg):
        unit = {"conv_a": _conv1d(3, cin, f), "conv_b": _conv1d(3, f, f)}
        st = {}
        for j, c in enumerate((cin, f)):
            unit[f"KerasBatchNorm_{j}"], st[f"KerasBatchNorm_{j}"] = \
                _bn_shapes(c)
        if pool:
            unit["shortcut"] = _conv1d(1, cin, f)
        trunk[name], stats[name] = unit, st
    ch, H = cfg.stage_filters[-1], cfg.lstm_units
    trunk["KerasBatchNorm_0"], stats["KerasBatchNorm_0"] = _bn_shapes(ch)
    trunk["BiLSTM_0"] = {
        d: {"kernel": (ch, 4 * H), "recurrent_kernel": (H, 4 * H),
            "bias": (4 * H,)}
        for d in ("forward", "backward")}
    units = head_units or cfg.num_speakers
    return {"params": {"trunk": trunk,
                       "head": {"kernel": (2 * H, units), "bias": (units,)}},
            "batch_stats": {"trunk": stats}}


def speaker_state_dict_from_jax(tree: Mapping[str, Any],
                                cfg: SpeakerModelConfig = SpeakerModelConfig(),
                                head_units: int | None = None
                                ) -> Dict[str, torch.Tensor]:
    """Flax tree of numpy arrays -> ``SpeakerResBLSTM(cfg, head_units)``
    state_dict, MFCC-39 input.  Conv1D kernels ``(K, Cin, Cout)`` ->
    ``(Cout, Cin, K)``; the LSTM and Dense as in the overlap converter."""
    _check(tree, speaker_tree_shapes(cfg, head_units))
    p, s = tree["params"]["trunk"], tree["batch_stats"]["trunk"]
    sd: Dict[str, torch.Tensor] = {}
    put = functools.partial(_put, sd)

    def conv(prefix, node):
        put(f"{prefix}.weight", np.transpose(node["kernel"], (2, 1, 0)))
        put(f"{prefix}.bias", node["bias"])

    conv("trunk.stem", p["stem"])
    for name, i, _, _, pool in _units(cfg):
        pre = f"trunk.units.{i}"
        if pool:
            conv(f"{pre}.shortcut", p[name]["shortcut"])
        for j, conv_name in enumerate(("conv_a", "conv_b")):
            _bn(sd, f"{pre}.bn{j}", p[name][f"KerasBatchNorm_{j}"],
                s[name][f"KerasBatchNorm_{j}"])
            conv(f"{pre}.{conv_name}", p[name][conv_name])
    _bn(sd, "trunk.bn", p["KerasBatchNorm_0"], s["KerasBatchNorm_0"])
    _lstm(sd, "trunk.bilstm.lstm", p["BiLSTM_0"])
    put("head.weight", np.asarray(tree["params"]["head"]["kernel"]).T)
    put("head.bias", tree["params"]["head"]["bias"])
    return sd


def _array(sd: Mapping[str, torch.Tensor], key: str) -> np.ndarray:
    return sd[key].detach().to("cpu", torch.float32).clone().numpy()


def _conv_tree(sd, prefix: str, axes: tuple) -> Dict[str, np.ndarray]:
    """A torch convolution -> its Flax ``kernel``/``bias`` leaves; ``axes``
    moves torch's (Cout, Cin, *K) to the Flax layout."""
    return {"kernel": np.ascontiguousarray(
                np.transpose(_array(sd, f"{prefix}.weight"), axes)),
            "bias": _array(sd, f"{prefix}.bias")}


def _bn_tree(sd, prefix: str) -> tuple:
    """A ``KerasBatchNorm*`` -> its (params, batch_stats) leaves."""
    return ({"BatchNorm_0": {"scale": _array(sd, f"{prefix}.weight"),
                             "bias": _array(sd, f"{prefix}.bias")}},
            {"BatchNorm_0": {"mean": _array(sd, f"{prefix}.running_mean"),
                             "var": _array(sd, f"{prefix}.running_var")}})


def _lstm_tree(sd, prefix: str) -> Dict[str, Any]:
    """``nn.LSTM(bidirectional)`` -> a Keras BiLSTM's two directions, the
    Keras bias being ``bias_ih + bias_hh``."""
    return {d: {"kernel": np.ascontiguousarray(
                    _array(sd, f"{prefix}.weight_ih_l0{sfx}").T),
                "recurrent_kernel": np.ascontiguousarray(
                    _array(sd, f"{prefix}.weight_hh_l0{sfx}").T),
                "bias": _array(sd, f"{prefix}.bias_ih_l0{sfx}")
                + _array(sd, f"{prefix}.bias_hh_l0{sfx}")}
            for d, sfx in (("forward", ""), ("backward", "_reverse"))}


def _dense_tree(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": np.ascontiguousarray(_array(sd, f"{prefix}.weight").T),
            "bias": _array(sd, f"{prefix}.bias")}


def overlap_tree_from_state_dict(sd: Mapping[str, torch.Tensor],
                                 cfg: OverlapModelConfig = OverlapModelConfig()
                                 ) -> Dict[str, Any]:
    """``OverlapResBLSTM(cfg)`` state_dict -> the JAX model's variable tree
    of float32 numpy arrays, the inverse of ``overlap_state_dict_from_jax``
    (what ``save_npz`` writes and ``load_overlap_npz`` reads).  Checked
    against ``overlap_tree_shapes``."""
    params: Dict[str, Any] = {"stem": _conv_tree(sd, "stem", (2, 3, 1, 0))}
    stats: Dict[str, Any] = {}
    for name, i, _, _, pool in _blocks(cfg):
        pre = f"blocks.{i}"
        blk: Dict[str, Any] = {f"Conv_{j}": _conv_tree(sd, f"{pre}.conv{j}",
                                                       (2, 3, 1, 0))
                               for j in (0, 1)}
        st: Dict[str, Any] = {}
        for j in (0, 1):
            blk[f"KerasBatchNorm_{j}"], st[f"KerasBatchNorm_{j}"] = \
                _bn_tree(sd, f"{pre}.bn{j}")
        if pool:
            blk["shortcut"] = _conv_tree(sd, f"{pre}.shortcut", (2, 3, 1, 0))
        params[name], stats[name] = blk, st
    params["BiLSTM_0"] = _lstm_tree(sd, "bilstm.lstm")
    params["head"] = _dense_tree(sd, "head")
    tree = {"params": params, "batch_stats": stats}
    _check(tree, overlap_tree_shapes(cfg))
    return tree


def speaker_tree_from_state_dict(sd: Mapping[str, torch.Tensor],
                                 cfg: SpeakerModelConfig = SpeakerModelConfig(),
                                 head_units: int | None = None
                                 ) -> Dict[str, Any]:
    """``SpeakerResBLSTM(cfg, head_units)`` state_dict -> the JAX model's
    variable tree of float32 numpy arrays, the inverse of
    ``speaker_state_dict_from_jax`` (what ``save_npz`` writes and
    ``load_speaker_npz`` reads).  Checked against ``speaker_tree_shapes``."""
    trunk: Dict[str, Any] = {"stem": _conv_tree(sd, "trunk.stem", (2, 1, 0))}
    stats: Dict[str, Any] = {}
    for name, i, _, _, pool in _units(cfg):
        pre = f"trunk.units.{i}"
        unit: Dict[str, Any] = {c: _conv_tree(sd, f"{pre}.{c}", (2, 1, 0))
                                for c in ("conv_a", "conv_b")}
        st: Dict[str, Any] = {}
        for j in (0, 1):
            unit[f"KerasBatchNorm_{j}"], st[f"KerasBatchNorm_{j}"] = \
                _bn_tree(sd, f"{pre}.bn{j}")
        if pool:
            unit["shortcut"] = _conv_tree(sd, f"{pre}.shortcut", (2, 1, 0))
        trunk[name], stats[name] = unit, st
    trunk["KerasBatchNorm_0"], stats["KerasBatchNorm_0"] = \
        _bn_tree(sd, "trunk.bn")
    trunk["BiLSTM_0"] = _lstm_tree(sd, "trunk.bilstm.lstm")
    tree = {"params": {"trunk": trunk, "head": _dense_tree(sd, "head")},
            "batch_stats": {"trunk": stats}}
    _check(tree, speaker_tree_shapes(cfg, head_units))
    return tree


def save_npz(tree: Mapping[str, Any], path) -> None:
    """Write a tree of arrays as the flat ``.npz`` (keys ``a/b/c``)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v, np.float32)

    walk(tree, "")
    np.savez(path, **flat)


def _read_npz(path) -> Dict[str, Any]:
    """The flat ``.npz`` as a nested tree of arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def load_overlap_npz(path, cfg: OverlapModelConfig = OverlapModelConfig()
                     ) -> Dict[str, Any]:
    """Read the flat ``.npz`` into the nested tree that
    ``overlap_state_dict_from_jax`` takes, checked against
    ``overlap_tree_shapes(cfg)``."""
    tree = _read_npz(path)
    _check(tree, overlap_tree_shapes(cfg))
    return tree


def load_speaker_npz(path, cfg: SpeakerModelConfig = SpeakerModelConfig()
                     ) -> tuple[Dict[str, Any], int]:
    """Read a speaker model's flat ``.npz`` -> ``(tree, head_units)``: the
    head's width is the file's (630 for the base model, the enrollment
    corpus's size for a transfer-learned one); the rest is checked against
    ``speaker_tree_shapes(cfg, head_units)``."""
    tree = _read_npz(path)
    try:
        head_units = int(np.shape(tree["params"]["head"]["bias"])[0])
    except (KeyError, TypeError, IndexError):
        raise ValueError(f"{path}: no params/head/bias leaf; not a speaker "
                         f"model's weights") from None
    _check(tree, speaker_tree_shapes(cfg, head_units))
    return tree, head_units
