"""Flax parameter trees -> PyTorch ``state_dict``s.

The JAX package keeps an ``OverlapResBLSTM``'s weights as a nested dict
``{"params": ..., "batch_stats": ...}`` (Flax module names as keys).  The
converter takes that tree as nested dicts of numpy arrays, so neither Flax
nor JAX is needed to call it.

Weights travel as a flat ``.npz`` (``load_overlap_npz``/``save_overlap_npz``):
one array per leaf, keyed by the ``/``-joined path of the tree, e.g.
``params/stage0_block1/Conv_0/kernel`` or
``batch_stats/stage0_block0/KerasBatchNorm_0/BatchNorm_0/var``; a JAX host
writes it from its variables with ``np.savez``.

Layout changes: conv kernels HWIO -> OIHW; Dense and LSTM kernels are
transposed ((in, out) -> (out, in)); the Keras LSTM's single ``bias`` goes to
``bias_ih`` with ``bias_hh = 0``; BatchNorm ``scale``/``bias``/``mean``/``var``
become ``weight``/``bias``/``running_mean``/``running_var``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from mmla_audio_torch.core.config import OverlapModelConfig

__all__ = ["overlap_tree_shapes", "overlap_state_dict_from_jax",
           "load_overlap_npz", "save_overlap_npz"]


def _conv(kh, kw, cin, cout):
    return {"kernel": (kh, kw, cin, cout), "bias": (cout,)}


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
            blk[f"KerasBatchNorm_{j}"] = {
                "BatchNorm_0": {"scale": (c,), "bias": (c,)}}
            st[f"KerasBatchNorm_{j}"] = {
                "BatchNorm_0": {"mean": (c,), "var": (c,)}}
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


def overlap_state_dict_from_jax(tree: Mapping[str, Any],
                                cfg: OverlapModelConfig = OverlapModelConfig()
                                ) -> Dict[str, torch.Tensor]:
    """Flax tree of numpy arrays -> ``OverlapResBLSTM(cfg)`` state_dict."""
    _check(tree, overlap_tree_shapes(cfg))
    p, s = tree["params"], tree["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def put(key, a):
        sd[key] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(a, dtype=np.float32)))

    def conv(prefix, node):
        put(f"{prefix}.weight", np.transpose(node["kernel"], (3, 2, 0, 1)))
        put(f"{prefix}.bias", node["bias"])

    def bn(prefix, pnode, snode):
        pnode, snode = pnode["BatchNorm_0"], snode["BatchNorm_0"]
        put(f"{prefix}.weight", pnode["scale"])
        put(f"{prefix}.bias", pnode["bias"])
        put(f"{prefix}.running_mean", snode["mean"])
        put(f"{prefix}.running_var", snode["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    conv("stem", p["stem"])
    for name, i, _, _, pool in _blocks(cfg):
        pre = f"blocks.{i}"
        if pool:
            conv(f"{pre}.shortcut", p[name]["shortcut"])
        for j in (0, 1):
            bn(f"{pre}.bn{j}", p[name][f"KerasBatchNorm_{j}"],
               s[name][f"KerasBatchNorm_{j}"])
            conv(f"{pre}.conv{j}", p[name][f"Conv_{j}"])
    for d, sfx in (("forward", ""), ("backward", "_reverse")):
        node = p["BiLSTM_0"][d]
        put(f"bilstm.lstm.weight_ih_l0{sfx}", np.asarray(node["kernel"]).T)
        put(f"bilstm.lstm.weight_hh_l0{sfx}",
            np.asarray(node["recurrent_kernel"]).T)
        put(f"bilstm.lstm.bias_ih_l0{sfx}", node["bias"])
        put(f"bilstm.lstm.bias_hh_l0{sfx}", np.zeros_like(node["bias"]))
    put("head.weight", np.asarray(p["head"]["kernel"]).T)
    put("head.bias", p["head"]["bias"])
    return sd


def save_overlap_npz(tree: Mapping[str, Any], path) -> None:
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


def load_overlap_npz(path, cfg: OverlapModelConfig = OverlapModelConfig()
                     ) -> Dict[str, Any]:
    """Read the flat ``.npz`` into the nested tree that
    ``overlap_state_dict_from_jax`` takes, checked against
    ``overlap_tree_shapes(cfg)``."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    _check(tree, overlap_tree_shapes(cfg))
    return tree
