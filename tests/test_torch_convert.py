"""The port's Keras converter (``mmla_audio_torch.convert``) against
``mmla_audio_tpu.convert``: the flat ``get_weights()`` list of a seeded JAX
tree, for both models, re-nested by both packages into equal trees (bit
for bit), the inverse back to the same list, and the port's ``state_dict``
from that list giving the JAX model's logits (rtol 1e-4, atol 1e-5: fp32
accumulation order on the CPU).  ``load_checkpoint_variables`` end to end
on synthetic SavedModels written with ``tests/golden/tfbundle_writer.py``
(the TF key layout of ``chip_smoke.savedmodel_tensors``): the same tree as
the JAX loader's, and ``load_checkpoint_state_dict`` equal tensor for
tensor to ``params.py``'s conversion of that tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import savedmodel_tensors
from mmla_audio_tpu import convert as jax_convert
from mmla_audio_tpu.core.config import OverlapModelConfig, SpeakerModelConfig
from mmla_audio_tpu.models.overlap import OverlapResBLSTM as JaxOverlap
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM as JaxSpeaker
from mmla_audio_torch import convert
from mmla_audio_torch.models.overlap import OverlapResBLSTM
from mmla_audio_torch.models.speaker import SpeakerResBLSTM
from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                     speaker_state_dict_from_jax)
from tests.golden.tfbundle_writer import write_bundle
from tests.test_torch_model import as_port, perturbed_tree
from tests.test_torch_speaker import perturbed_speaker_tree

torch.set_num_threads(1)

OVERLAP = OverlapModelConfig(stage_filters=(4, 8), blocks_per_stage=2,
                             lstm_units=4, input_scale=1 / 255)
SPEAKER = SpeakerModelConfig(stage_filters=(4, 8), blocks_per_stage=2,
                             lstm_units=4, num_speakers=5)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _assert_trees_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _assert_state_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _overlap_logits(tree, x):
    ref = np.asarray(JaxOverlap(OVERLAP).apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    model = OverlapResBLSTM(as_port(OVERLAP))
    model.load_state_dict(convert.overlap_state_dict_from_keras(
        jax_convert.overlap_variables_to_keras(tree, OVERLAP),
        as_port(OVERLAP)))
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy(), ref


def test_overlap_keras_roundtrip_matches_jax():
    tree = perturbed_tree(OVERLAP, seed=3)
    flat = jax_convert.overlap_variables_to_keras(tree, OVERLAP)
    assert len(flat) == 2 + 4 * 12 + 2 * 2 + 6 + 2
    got = convert.overlap_variables_from_keras(flat, as_port(OVERLAP))
    _assert_trees_equal(got, jax_convert.overlap_variables_from_keras(
        flat, OVERLAP))
    back = convert.overlap_variables_to_keras(got, as_port(OVERLAP))
    assert len(back) == len(flat)
    for x, y in zip(back, flat):
        np.testing.assert_array_equal(x, y)
    x = (np.random.RandomState(0).rand(2, 128, 151, 3) * 255).astype(
        np.float32)
    logits, ref = _overlap_logits(tree, x)
    np.testing.assert_allclose(logits, ref, rtol=1e-4, atol=1e-5)


def test_speaker_keras_roundtrip_matches_jax():
    tree = perturbed_speaker_tree(SPEAKER, seed=4)
    flat = jax_convert.speaker_variables_to_keras(tree, SPEAKER)
    got = convert.speaker_variables_from_keras(flat, as_port(SPEAKER))
    _assert_trees_equal(got, jax_convert.speaker_variables_from_keras(
        flat, SPEAKER))
    back = convert.speaker_variables_to_keras(got, as_port(SPEAKER))
    for x, y in zip(back, flat):
        np.testing.assert_array_equal(x, y)
    x = np.random.RandomState(1).randn(2, 256, 39).astype(np.float32)
    ref = np.asarray(JaxSpeaker(SPEAKER).apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    sd = convert.speaker_state_dict_from_keras(flat, as_port(SPEAKER))
    _assert_state_dicts_equal(sd, speaker_state_dict_from_jax(
        got, as_port(SPEAKER), 5))
    model = SpeakerResBLSTM(as_port(SPEAKER), 5)
    model.load_state_dict(sd)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, ref, rtol=1e-4, atol=1e-5)


def test_full_size_overlap_weight_count():
    """The deployed timit2.0 graph: 22 convs + 18 BNs + BiLSTM + Dense,
    22 * 2 + 18 * 4 + 6 + 2 = 124 arrays."""
    from chip_smoke import seeded_tree
    from mmla_audio_torch.core.config import OverlapModelConfig as PortCfg
    from mmla_audio_torch.params import overlap_tree_shapes

    tree = seeded_tree(overlap_tree_shapes(PortCfg()),
                       np.random.RandomState(0))
    assert len(convert.overlap_variables_to_keras(tree)) == 124


def test_mismatched_checkpoint_raises():
    flat = jax_convert.overlap_variables_to_keras(
        perturbed_tree(OVERLAP, seed=5), OVERLAP)
    with pytest.raises(ValueError, match="ran out of weights"):
        convert.overlap_variables_from_keras(flat[:-2], as_port(OVERLAP))
    with pytest.raises(ValueError, match="unconsumed weights"):
        convert.overlap_variables_from_keras(
            flat + [np.zeros((3, 3), np.float32)], as_port(OVERLAP))
    sflat = jax_convert.speaker_variables_to_keras(
        perturbed_speaker_tree(SPEAKER, seed=6), SPEAKER)
    with pytest.raises(ValueError, match="does not match the checkpoint"):
        convert.speaker_variables_from_keras(sflat, as_port(SPEAKER),
                                             head_units=7)


@pytest.mark.parametrize("kind", ["overlap", "speaker"])
@pytest.mark.parametrize("where", ["savedmodel", "variables", "prefix"])
def test_load_checkpoint_end_to_end(tmp_path, kind, where):
    """A synthetic SavedModel (values included, the BiLSTM as orphans) ->
    the same tree as the JAX loader's, the state dict of ``params.py``,
    and the JAX model's logits."""
    cfg = OVERLAP if kind == "overlap" else SPEAKER
    tree = perturbed_tree(cfg, seed=8) if kind == "overlap" else \
        perturbed_speaker_tree(cfg, seed=8)
    to_keras = getattr(jax_convert, f"{kind}_variables_to_keras")
    savedmodel = tmp_path / "model"
    (savedmodel / "variables").mkdir(parents=True)
    write_bundle(savedmodel / "variables" / "variables",
                 savedmodel_tensors(to_keras(tree, cfg), cfg, kind))
    path = {"savedmodel": savedmodel, "variables": savedmodel / "variables",
            "prefix": savedmodel / "variables" / "variables"}[where]
    got = convert.load_checkpoint_variables(path, cfg=as_port(cfg),
                                            verify_crc=True)
    _assert_trees_equal(got, jax_convert.load_checkpoint_variables(
        path, kind, cfg=cfg, verify_crc=True))
    _assert_trees_equal(got, tree)
    got_kind, sd, head = convert.load_checkpoint_state_dict(
        path, cfg=as_port(cfg))
    assert got_kind == kind
    if kind == "overlap":
        assert head is None
        _assert_state_dicts_equal(sd, overlap_state_dict_from_jax(
            tree, as_port(cfg)))
        x = (np.random.RandomState(2).rand(1, 128, 151, 3) * 255).astype(
            np.float32)
        logits, ref = _overlap_logits(tree, x)
        np.testing.assert_allclose(logits, ref, rtol=1e-4, atol=1e-5)
    else:
        assert head == 5
        _assert_state_dicts_equal(sd, speaker_state_dict_from_jax(
            tree, as_port(cfg), 5))


def test_load_checkpoint_refuses_empty_and_unknown_kind(tmp_path):
    write_bundle(tmp_path / "variables",
                 {"step": np.zeros((), np.int64)})
    with pytest.raises(ValueError, match="no model weights"):
        convert.load_checkpoint_variables(tmp_path / "variables")
    flat = jax_convert.overlap_variables_to_keras(
        perturbed_tree(OVERLAP, seed=9), OVERLAP)
    (tmp_path / "m").mkdir()
    write_bundle(tmp_path / "m" / "variables",
                 savedmodel_tensors(flat, OVERLAP, "overlap"))
    with pytest.raises(ValueError, match="kind must be"):
        convert.load_checkpoint_variables(tmp_path / "m" / "variables",
                                          kind="vad")
