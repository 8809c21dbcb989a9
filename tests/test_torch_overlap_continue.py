"""``OverlapTrainer.continue_train`` vs the JAX package's, from a checkpoint
the port wrote: two epochs on the JAX suite's toy images (32x39, the
narrow ``OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8)``,
dropout 0), the 80/20 stratified split (42 training rows at batch 8, the
last batch two real rows and six masked zero rows), weighted CCE, Adadelta
under the cosine lr from 0.1 (ten times the reference's start, so that the
parameters move well beyond the tolerance), JAX's permutations injected.

The JAX package reads Orbax checkpoints: the test converts the port's
``variables.npz`` into one with the JAX package's own ``save_variables``.
Tolerances as in ``tests/test_torch_overlap_trainer.py``: training losses
rtol 1e-5, validation losses rtol 1e-4, parameters and batch statistics
rtol 1e-4 / atol 1e-5, the dead ``Conv_0`` biases and the running means
they feed within Adadelta's bound.
"""

import jax
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core.config import OverlapModelConfig, OverlapTrainConfig
from mmla_audio_tpu.train.checkpoints import save_variables as jax_save
from mmla_audio_tpu.train.overlap_trainer import OverlapTrainer as JaxTrainer
from mmla_audio_torch.params import (load_overlap_npz,
                                     overlap_tree_from_state_dict)
from mmla_audio_torch.train.overlap_trainer import OverlapTrainer
from tests.test_overlap_trainer import _toy_images
from tests.test_torch_model import as_port
from tests.test_torch_overlap_trainer import assert_trees_close
from tests.test_torch_train import _jax_permutations

torch.set_num_threads(1)

NARROW = OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8,
                            dropout=0.0)
TRAIN = OverlapTrainConfig(batch_size=8, cosine_eta_max=0.1)


def test_continue_train_matches_jax(tmp_path):
    x, y = _toy_images(31, 21, seed=2)
    # the port's checkpoint: one epoch of the port's own training
    pt = OverlapTrainer(as_port(NARROW), as_port(TRAIN), device="cpu")
    pt.train(x, y, epochs=1, checkpoint_dir=tmp_path / "port", seed=3)
    tree = load_overlap_npz(tmp_path / "port" / "variables.npz",
                            as_port(NARROW))
    jax_save(tmp_path / "jax", tree)
    state, jhist = JaxTrainer(NARROW, TRAIN).continue_train(
        tmp_path / "jax", x, y, epochs=2, seed=0)
    n_pad = 48                                  # 42 training rows
    sd, hist = pt.continue_train(
        tmp_path / "port", x, y, epochs=2, seed=0,
        permutations=_jax_permutations(jax.random.PRNGKey(0), 2, n_pad))
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    np.testing.assert_allclose(hist["val_loss"], jhist["val_loss"],
                               rtol=1e-4)
    assert hist["acc"] == pytest.approx(jhist["acc"], abs=1e-6)
    assert hist["val_acc"] == pytest.approx(jhist["val_acc"], abs=1e-6)
    sched = pt._schedule()
    ref = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    assert_trees_close(overlap_tree_from_state_dict(sd, as_port(NARROW)),
                       ref, [sched(0)] * 6 + [sched(1)] * 6)
    # training moved on from the checkpoint, ten times the tolerance
    moved = max(np.abs(np.asarray(a) - b).max() for a, b in zip(
        jax.tree_util.tree_leaves(ref["params"]),
        jax.tree_util.tree_leaves(tree["params"])))
    assert moved > 5e-4
