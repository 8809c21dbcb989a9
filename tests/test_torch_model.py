"""Port OverlapResBLSTM + Flax-tree converter vs ``OverlapResBLSTM.apply``.

Parameters are seeded and perturbed: a fresh init has BatchNorm at mean 0 /
variance 1 and a mostly-zero LSTM bias, under which a converter that swapped
mean and variance, or dropped the bias, would still pass.  Tolerance rtol
1e-4, atol 1e-5: fp32 accumulation order (no TF32 on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core.config import OverlapModelConfig
from mmla_audio_tpu.models.overlap import OverlapResBLSTM as JaxOverlap
from mmla_audio_torch.core import config as port_config
from mmla_audio_torch.models.overlap import OverlapResBLSTM, keras_init_
from mmla_audio_torch.params import (
    overlap_state_dict_from_jax,
    overlap_tree_shapes,
)

torch.set_num_threads(1)

NARROW = OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8)


def as_port(cfg):
    """The port's config of the same class name and field values."""
    return getattr(port_config, type(cfg).__name__)(**dataclasses.asdict(cfg))


def perturbed_tree(cfg, seed=0):
    """The JAX model's init tree as numpy, every leaf perturbed from a seed:
    BN variance and scale in [0.5, 2), other leaves plus Gaussian noise."""
    rng = np.random.RandomState(seed)
    tree = JaxOverlap(cfg).init_variables(jax.random.PRNGKey(seed))

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "'var'" in name or "'scale'" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        sigma = 0.3 if "kernel" in name else 0.1
        return (a + rng.normal(0.0, sigma, a.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jax.tree_util.tree_map(np.asarray, {k: dict(v)
                                               for k, v in tree.items()})


def _both(cfg, tree, x):
    ref = np.asarray(JaxOverlap(cfg).apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    model = OverlapResBLSTM(as_port(cfg))
    model.load_state_dict(overlap_state_dict_from_jax(tree, as_port(cfg)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    return got, ref


def test_tree_shapes_match_jax_init():
    tree = JaxOverlap(NARROW).init_variables(jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert {k: dict(v) for k, v in shapes.items()} == \
        overlap_tree_shapes(as_port(NARROW))


@pytest.mark.parametrize("scale,batch", [(1.0, 2), (255.0, 1)])
def test_logits_match_jax(scale, batch):
    """Unit-scale inputs keep the narrow model input-sensitive; one full
    0..255 image checks the 128x151 geometry end to end."""
    tree = perturbed_tree(NARROW)
    x = (np.random.RandomState(1).rand(batch, 128, 151, 3) * scale
         ).astype(np.float32)
    got, ref = _both(NARROW, tree, x)
    assert got.shape == (batch, 2)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_logits_match_jax_with_input_scale():
    cfg = OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             blocks_per_stage=2, input_scale=1 / 255)
    x = (np.random.RandomState(2).rand(2, 128, 151, 3) * 255
         ).astype(np.float32)
    got, ref = _both(cfg, perturbed_tree(cfg, seed=3), x)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("training", [False, True])
def test_segments_in_turn_equal_forward(training):
    """``segments`` is the forward: its stretches and blocks run one after
    another give ``forward``'s logits exactly (train mode: the same
    dropout draws from the same seed), three stages then the head."""
    cfg = as_port(OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                                     input_scale=1 / 255))
    model = keras_init_(OverlapResBLSTM(cfg),
                        torch.Generator().manual_seed(2)).train(training)
    x = torch.from_numpy((np.random.RandomState(4).rand(3, 128, 151, 3)
                          * 255).astype(np.float32))
    segs = model.segments()
    assert [name for name, _, _ in segs] == ["model.stage"] * 3 + \
        ["model.lstm"]
    assert [len(blocks) for _, _, blocks in segs] == [2, 2, 2, 0]
    assert not any(b.pool for _, _, blocks in segs for b in blocks)
    with torch.no_grad():
        torch.manual_seed(0)
        ref = model(x)
        torch.manual_seed(0)
        net = x
        for _, stretch, blocks in segs:
            for layer in stretch + blocks:
                net = layer(net)
    assert torch.equal(net, ref)


def test_converter_rejects_wrong_tree():
    tree = perturbed_tree(NARROW)
    del tree["batch_stats"]["stage0_block0"]
    with pytest.raises(ValueError, match="mismatch"):
        overlap_state_dict_from_jax(tree, as_port(NARROW))


def test_keras_init_is_seeded():
    a, b = (keras_init_(OverlapResBLSTM(as_port(NARROW)),
                        torch.Generator().manual_seed(5)).state_dict()
            for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    lstm_bias = a["bilstm.lstm.bias_ih_l0"]
    assert torch.equal(lstm_bias[8:16], torch.ones(8))   # unit forget bias
    assert torch.equal(a["bilstm.lstm.bias_hh_l0"], torch.zeros(32))
