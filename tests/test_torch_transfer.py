"""The port's registration fine-tune vs the JAX package's
``TransferLearner`` on numpy-seeded inputs: the train/validation split, one
two-phase ``fit_once`` of a narrow model with JAX's head init and JAX's
permutations (losses, validation accuracy, the final tree), the frozen
trunk of phase 1, and the retrain-until-gate loop.

Tolerances: per-epoch losses rtol 1e-5; the final tree rtol 1e-4 / atol
1e-5 (float32 accumulation order; no TF32 on the CPU).  Phase 1 here runs
on the trunk's embeddings computed once, JAX re-runs the trunk every step:
the same function of the same inputs.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core.config import SpeakerModelConfig, TransferConfig
from mmla_audio_tpu.train.transfer import TransferLearner as JaxLearner
from mmla_audio_tpu.train.transfer import train_val_split as jax_split
from mmla_audio_torch.params import (speaker_state_dict_from_jax,
                                     speaker_tree_from_state_dict)
from mmla_audio_torch.train.transfer import TransferLearner, train_val_split
from tests.test_torch_model import as_port
from tests.test_torch_speaker import perturbed_speaker_tree
from tests.test_torch_train import T, flat, toy_data

torch.set_num_threads(1)

BASE = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                          num_speakers=10)


@pytest.fixture(scope="module")
def base():
    """A perturbed 10-way base tree and its state_dict."""
    tree = perturbed_speaker_tree(BASE, seed=11, input_shape=(T, 39))
    return tree, speaker_state_dict_from_jax(tree, as_port(BASE))


@pytest.mark.parametrize("n,seed", [(30, 0), (31, 3), (7, 1)])
def test_train_val_split_matches_jax(n, seed):
    """Stratified 70/30 split, including a class with one window (it
    serves both sides)."""
    x = np.arange(n, dtype=np.float32)[:, None]
    labels = np.arange(n) % 3
    labels[-1] = 3                                  # a lone window
    y = np.eye(4, dtype=np.float32)[labels]
    got, ref = train_val_split(x, y, 0.3, seed), jax_split(x, y, 0.3, seed)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert 3 in np.argmax(got[1], 1) and 3 in np.argmax(got[3], 1)


def _jax_head_and_permutations(learner, seed, total, n1, n2):
    """The head init and per-epoch permutations of JAX's ``fit_once``
    (transfer.py:145, :154, :196-200)."""
    head = learner._init_variables(jax.random.PRNGKey(seed))["params"]["head"]
    rng1, rng2 = jax.random.split(jax.random.PRNGKey(seed + 1))
    perms = [[np.asarray(jax.random.permutation(k, total))
              for k in jax.random.split(r, n)]
             for r, n in ((rng1, n1), (rng2, n2))]
    return ({"weight": np.asarray(head["kernel"]).T,
             "bias": np.asarray(head["bias"])}, perms)


def test_fit_once_matches_jax(base):
    """Phase 1 (3 epochs, b16, lr 1e-4, head only) then phase 2 (2 epochs,
    b8, lr 1e-6, everything), 26 windows of 3 speakers: 18 train rows
    padded to 32."""
    tree, sd = base
    cfg = TransferConfig(phase1_epochs=3, phase2_epochs=2)
    x, y = toy_data(26, seed=12)
    jl = JaxLearner(jax.tree_util.tree_map(jnp.asarray, tree), 3, BASE, cfg)
    ref_vars, ref_acc, ref_losses = jl.fit_once(x, y, seed=4)
    head, perms = _jax_head_and_permutations(jl, 4, 32, 3, 2)
    learner = TransferLearner(sd, 3, as_port(BASE), as_port(cfg),
                              device="cpu")
    got_sd, acc, got_losses = learner.fit_once(x, y, seed=4, head=head,
                                               permutations=perms)
    assert learner.report["n_train"] == 18 and learner.report["n_val"] == 8
    assert learner.report["phase1_steps"] == 6
    assert learner.report["phase2_steps"] == 8
    assert acc == pytest.approx(ref_acc, abs=1e-6)
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-5)
    got = flat(speaker_tree_from_state_dict(got_sd, as_port(BASE), 3))
    ref = flat(jax.tree_util.tree_map(np.asarray, ref_vars))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # phase 2 moved the trunk; the batch statistics stayed the base's
    trunk = [k for k in ref if k.startswith("params/trunk/")]
    assert any(not np.array_equal(got[k], flat(tree)[k]) for k in trunk)
    for k in (k for k in ref if k.startswith("batch_stats/")):
        np.testing.assert_array_equal(got[k], flat(tree)[k])


def test_phase1_leaves_the_trunk_bit_unchanged(base):
    """With no phase 2, every trunk tensor is the base's, bit for bit, and
    the head moved; the same seed on a second learner gives the same
    run."""
    _, sd = base
    x, y = toy_data(20, seed=13)
    runs = []
    for _ in range(2):
        learner = TransferLearner(sd, 3, as_port(BASE), device="cpu")
        runs.append(learner.fit_once(x, y, seed=2, epochs_override=(3, 0)))
    got, acc, losses = runs[0]
    assert losses.shape == (3,) and np.isfinite(losses).all()
    for k, v in sd.items():
        if k.startswith("trunk."):
            assert torch.equal(got[k], v), k
    fresh = TransferLearner(sd, 3, as_port(BASE), device="cpu").init_model(2)
    assert not torch.equal(got["head.weight"],
                           fresh.head.weight.detach().cpu())
    assert acc == runs[1][1]
    assert all(torch.equal(got[k], runs[1][0][k]) for k in got)


def test_fit_until_gate_stops_at_the_gate(base):
    """Gate 0: the first round is kept; gate above 1: every round runs and
    the best is returned."""
    _, sd = base
    x, y = toy_data(12, seed=14)
    for gate, rounds in ((0.0, 1), (1.1, 3)):
        cfg = as_port(TransferConfig(accuracy_gate=gate, max_retrain_rounds=3))
        learner = TransferLearner(sd, 3, as_port(BASE), cfg, device="cpu")
        _, acc, _ = learner.fit_until_gate(x, y, seed=5,
                                           epochs_override=(1, 1))
        assert learner.report["rounds"] == rounds
        assert 0.0 <= acc <= 1.0


def test_transfer_defaults_to_the_card(base):
    """No CPU fallback: the learner's device defaults to the card."""
    assert inspect.signature(TransferLearner.__init__).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        x, y = toy_data(6, seed=1)
        with pytest.raises((AssertionError, RuntimeError)):
            TransferLearner(base[1], 3, as_port(BASE)).fit_once(
                x, y, epochs_override=(1, 0))
