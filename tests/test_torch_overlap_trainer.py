"""The port's overlap-detector training vs the JAX package's
``OverlapTrainer`` on the JAX suite's own toy images (32x39, a narrow
``OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8)``): the train
steps of two epochs, and ``OverlapTrainer.train``'s split, history, early
stop and best checkpoint.

One JAX run serves every test here (its compile costs tens of seconds on
the CPU): ``train`` from the JAX init of seed 0, dropout 0, weighted CCE,
Adadelta under the cosine lr from 0.1 (ten times the reference's start, so
that two epochs move the parameters well beyond the tolerance), batch 8 over a training split of 41 rows
(the last batch holds one real row and seven masked zero rows, which
BatchNorm's batch statistics see), the 11-row test split evaluated in
chunks of 4, and an early-stop patience of 1 that fires after the second
epoch.  The port replays it from the converted init tree with JAX's
permutations.

Tolerances: per-epoch training losses rtol 1e-5, validation losses rtol
1e-4; parameters and batch statistics rtol 1e-4 / atol 1e-5 (float32
accumulation order; no TF32 on the CPU).  One exception: each block's
``Conv_0`` bias feeds only a train-mode BatchNorm, so its exact gradient is
zero and each framework's is rounding noise.  Adadelta turns a gradient g
into a step lr * g * sqrt(acc_delta + eps) / sqrt(acc + eps), and acc >=
(1 - rho) g^2 after the step, so a step is at most lr * sqrt((acc_delta +
eps) / (1 - rho)) whatever g is; ``chip_smoke.adadelta_noise_bound`` (the
card check's own copy) sums that bound over the steps (acc_delta grows with the steps it bounds), twice for two
runs.  Those leaves are held to it, and the running means fed by them to
1 % of it per step (1 - momentum) on top of the usual tolerance.
"""

import json

import jax
import numpy as np
import pytest
import torch

from chip_smoke import adadelta_noise_bound
from mmla_audio_tpu.core.config import OverlapModelConfig, OverlapTrainConfig
from mmla_audio_tpu.train.overlap_trainer import OverlapTrainer as JaxTrainer
from mmla_audio_tpu.train.overlap_trainer import (
    stratified_kfold_indices as jax_kfold)
from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                     overlap_tree_from_state_dict)
from mmla_audio_torch.train.overlap_trainer import (OverlapTrainer,
                                                    stratified_kfold_indices)
from tests.test_overlap_trainer import _toy_images
from tests.test_torch_model import as_port
from tests.test_torch_train import flat

torch.set_num_threads(1)

NARROW = OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8,
                            dropout=0.0)
TRAIN = OverlapTrainConfig(epochs=3, batch_size=8, early_stop_patience=1,
                           cosine_eta_max=0.1, eval_batch_size=4)
N_SINGLE, N_OVERLAP = 31, 21
RTOL, ATOL = 1e-4, 1e-5


def dead_bias(key: str) -> bool:
    return key.startswith("params/stage") and key.endswith("Conv_0/bias")


def assert_trees_close(got, ref, lrs):
    """Every leaf within RTOL/ATOL; the dead biases and the running means
    of the BatchNorms they feed within the module docstring's bound."""
    noise = adadelta_noise_bound(lrs)
    got, ref = flat(got), flat(ref)
    assert got.keys() == ref.keys()
    for k in ref:
        fed = k.endswith("KerasBatchNorm_1/BatchNorm_0/mean")
        atol = noise if dead_bias(k) else ATOL + (
            0.01 * len(lrs) * noise if fed else 0.0)
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=atol,
                                   err_msg=k)


def jax_train_permutations(seed, epochs, n):
    """The per-epoch permutations of JAX's ``OverlapTrainer.train``: epoch
    e fits one epoch from ``fold_in(PRNGKey(seed + 1), e)``
    (overlap_trainer.py:174-183, trainer.py:130-131, :299)."""
    perms = []
    for e in range(epochs):
        _, ep_rng = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed + 1), e))
        perm_rng, _ = jax.random.split(ep_rng)
        perms.append(np.asarray(jax.random.permutation(perm_rng, n)))
    return perms


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's ``train`` and the port's replay of it, with their
    checkpoints."""
    x, y = _toy_images(N_SINGLE, N_OVERLAP, seed=4)
    tmp = tmp_path_factory.mktemp("overlap_train")
    jt = JaxTrainer(NARROW, TRAIN)
    state, jhist, (jx_test, jy_test) = jt.train(x, y, weighted=True, seed=0)
    init = jt.model.init_variables(jax.random.PRNGKey(0),
                                   input_shape=x.shape[1:])
    init = jax.tree_util.tree_map(np.asarray, {k: dict(v)
                                               for k, v in init.items()})
    n_train = len(stratified_kfold_indices_port(y)[0])
    n_pad = -(-n_train // TRAIN.batch_size) * TRAIN.batch_size
    pt = OverlapTrainer(as_port(NARROW), as_port(TRAIN), device="cpu")
    sd, hist, (x_test, y_test) = pt.train(
        x, y, weighted=True, checkpoint_dir=tmp / "port", seed=0,
        init=overlap_state_dict_from_jax(init, as_port(NARROW)),
        permutations=jax_train_permutations(0, TRAIN.epochs, n_pad))
    ref = jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})
    return dict(x=x, y=y, tmp=tmp, jhist=jhist, jtest=(jx_test, jy_test),
                init=init, n_train=n_train, pt=pt, sd=sd, hist=hist,
                test=(x_test, y_test), ref=ref)


def stratified_kfold_indices_port(y):
    return stratified_kfold_indices(np.argmax(y, 1), 5, seed=0)


def test_train_steps_match_jax(runs):
    """Two epochs of 6 steps at batch 8 over 41 rows (one real row in the
    last batch), epoch 0 at the cosine schedule's eta_max: per-epoch losses
    and accuracies, then every parameter (the LSTM's bias_ih + bias_hh
    against JAX's one bias) and batch statistic."""
    assert runs["n_train"] == 41 and len(runs["jhist"]["loss"]) == 2
    np.testing.assert_allclose(runs["hist"]["loss"], runs["jhist"]["loss"],
                               rtol=1e-5)
    assert runs["hist"]["acc"] == pytest.approx(runs["jhist"]["acc"],
                                                abs=1e-6)
    got = overlap_tree_from_state_dict(runs["sd"], as_port(NARROW))
    sched = runs["pt"]._schedule()
    assert sched(0) == TRAIN.cosine_eta_max
    assert runs["pt"].trainer.optimizer.param_groups[0]["lr"] == sched(1)
    assert_trees_close(got, runs["ref"], [sched(0)] * 6 + [sched(1)] * 6)
    # the steps moved the parameters far beyond the tolerance
    moved = max(np.abs(flat(got)[k] - flat(runs["init"])[k]).max()
                for k in flat(runs["init"])
                if k.startswith("params/") and not dead_bias(k))
    assert moved > 100 * ATOL


def test_train_history_early_stop_and_best_checkpoint_match_jax(runs):
    """The same split as JAX's; validation loss and accuracy in every
    epoch; the patience fires after the same epoch; the best checkpoint
    (by validation accuracy) is from the epoch JAX's would be."""
    x_test, y_test = runs["test"]
    np.testing.assert_array_equal(x_test.numpy(), runs["jtest"][0])
    np.testing.assert_array_equal(y_test, runs["jtest"][1])
    hist, jhist = runs["hist"], runs["jhist"]
    assert len(hist["loss"]) == len(jhist["loss"]) < TRAIN.epochs
    np.testing.assert_allclose(hist["val_loss"], jhist["val_loss"],
                               rtol=1e-4)
    assert hist["val_acc"] == pytest.approx(jhist["val_acc"], abs=1e-6)
    meta = json.loads((runs["tmp"] / "port" / "metadata.json").read_text())
    # BestCheckpointer saves on a strictly better validation accuracy: the
    # first epoch of the highest
    assert meta["epoch"] == int(np.argmax(jhist["val_acc"]))
    assert meta["best_metric"] == pytest.approx(max(jhist["val_acc"]),
                                                abs=1e-6)
    assert meta["val_loss"] == pytest.approx(
        jhist["val_loss"][meta["epoch"]], rel=1e-4)
