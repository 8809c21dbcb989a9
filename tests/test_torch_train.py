"""The port's training layer vs the JAX package, on numpy-seeded inputs:
losses, the Keras optimizers, train-mode BatchNorm, ``l2_penalty``, the
inverse converter, one full training step and ``Trainer.fit`` of a narrow
``SpeakerResBLSTM``, and the checkpoint files.

Tolerances: losses rtol 1e-6 (the same float32 formula); optimizers rtol
2e-5 / atol 2e-6 against the float64 Keras rule and 1e-6 against optax;
BatchNorm rtol 1e-5 / atol 1e-6; parameters and batch statistics after
training steps rtol 1e-4 / atol 1e-5 (float32 accumulation order of the
forward and backward passes; no TF32 on the CPU).  One exception: every
trunk convolution's bias feeds a train-mode BatchNorm (directly, or through
the residual stream and a linear shortcut), so its exact gradient is zero
and each framework's is rounding noise, which RMSprop scales to a step of
up to lr * sqrt(1 / (1 - rho)) = lr * sqrt(10).  Those leaves are held to
2 * steps * lr * sqrt(10), the most two runs of such steps can differ, and
the running means, which take 1 - momentum = 1 % of a step's batch mean
(bias included), to 1 % of that per step on top of the usual tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmla_audio_tpu.core.config import SpeakerModelConfig
from mmla_audio_tpu.models.layers import KerasBatchNorm as JaxBatchNorm
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM as JaxSpeaker
from mmla_audio_tpu.models.speaker import l2_penalty as jax_l2_penalty
from mmla_audio_tpu.train import losses as jax_losses
from mmla_audio_tpu.train import optimizers as jax_optimizers
from mmla_audio_tpu.train.trainer import Trainer as JaxTrainer
from mmla_audio_tpu.train.trainer import pad_to_batches as jax_pad
from mmla_audio_torch.models.layers import (KerasBatchNorm, KerasBatchNorm1d,
                                            SeededDropout, transfer_mode_)
from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_torch.params import (speaker_state_dict_from_jax,
                                     speaker_tree_from_state_dict)
from mmla_audio_torch.train import losses, optimizers
from mmla_audio_torch.train.checkpoints import (BestCheckpointer,
                                                load_variables,
                                                save_variables)
from mmla_audio_torch.train.trainer import Trainer, pad_to_batches
from tests.test_torch_model import as_port
from tests.test_torch_speaker import perturbed_speaker_tree

torch.set_num_threads(1)

# narrow enough for short JAX compiles; dropout off, so both frameworks
# train the same function
NARROW = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                            num_speakers=3, dropout_trunk=0.0,
                            dropout_head=0.0)
T = 64
RTOL, ATOL = 1e-4, 1e-5


def flat(tree, prefix=""):
    """{'a/b/c': array} of a nested tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def dead_bias(key: str) -> bool:
    """A trunk convolution's bias (see the module docstring)."""
    return key.startswith("params/trunk/") and key.endswith(
        ("stem/bias", "conv_a/bias", "conv_b/bias", "shortcut/bias"))


def assert_trees_close(got, ref, steps, lr):
    """Every leaf within RTOL/ATOL; the dead biases and the running means
    within the bounds of the module docstring after ``steps`` RMSprop steps
    at ``lr``."""
    noise = 2 * steps * lr * np.sqrt(10.0)
    got, ref = flat(got), flat(ref)
    assert got.keys() == ref.keys()
    for k in ref:
        atol = noise if dead_bias(k) else ATOL + (
            0.01 * steps * noise if k.endswith("/mean") else 0.0)
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=atol,
                                   err_msg=k)


def port_model(tree, cfg=NARROW, head_units=None):
    model = SpeakerResBLSTM(as_port(cfg), head_units)
    model.load_state_dict(speaker_state_dict_from_jax(tree, as_port(cfg),
                                                      head_units))
    return model


@pytest.fixture(scope="module")
def narrow_tree():
    """One perturbed NARROW tree (3-way head) shared by the tests below: the
    JAX init of each tree costs seconds."""
    return perturbed_speaker_tree(NARROW, seed=5, input_shape=(T, 39))


def toy_data(n, n_classes=3, seed=0):
    """(n, T, 39) features with a class-dependent offset, one-hot labels."""
    rng = np.random.RandomState(seed)
    labels = np.arange(n) % n_classes
    x = rng.randn(n, T, 39).astype(np.float32)
    for c in range(n_classes):
        x[labels == c, :, c * 10:(c + 1) * 10] += 2.0
    return x, np.eye(n_classes, dtype=np.float32)[labels]


# -- losses -------------------------------------------------------------------
@pytest.fixture(scope="module")
def logits_and_labels():
    rng = np.random.RandomState(0)
    logits = (rng.randn(6, 5) * 4).astype(np.float32)
    logits[0, 2] = 40.0                      # saturates the clip
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 6)]
    return logits, y


@pytest.mark.parametrize("activation", ["softmax", "sigmoid"])
def test_keras_cce_matches_jax(logits_and_labels, activation):
    logits, y = logits_and_labels
    got = losses.keras_categorical_crossentropy(
        torch.from_numpy(logits), torch.from_numpy(y), activation)
    ref = jax_losses.keras_categorical_crossentropy(
        jnp.asarray(logits), jnp.asarray(y), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_weighted_cce_accuracy_and_penalty_match_jax(logits_and_labels):
    logits, y = logits_and_labels
    w = losses.cal_weighted_penalty(y)
    np.testing.assert_array_equal(w, jax_losses.cal_weighted_penalty(y))
    got = losses.weighted_categorical_crossentropy(
        torch.from_numpy(logits), torch.from_numpy(y), w)
    ref = jax_losses.weighted_categorical_crossentropy(
        jnp.asarray(logits), jnp.asarray(y), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert float(losses.categorical_accuracy(
        torch.from_numpy(logits), torch.from_numpy(y))) == float(
        jax_losses.categorical_accuracy(jnp.asarray(logits), jnp.asarray(y)))


# -- optimizers ---------------------------------------------------------------
def _keras_rmsprop(lr, rho, eps):
    state = {}

    def step(p, g):
        rms = state.get("rms", np.zeros_like(p))
        rms = rho * rms + (1 - rho) * g * g
        state["rms"] = rms
        return p - lr * g / (np.sqrt(rms) + eps)
    return step


def _keras_adadelta(lr, rho, eps):
    state = {}

    def step(p, g):
        acc = rho * state.get("acc", np.zeros_like(p)) + (1 - rho) * g * g
        acc_d = state.get("acc_d", np.zeros_like(p))
        delta = g * np.sqrt(acc_d + eps) / np.sqrt(acc + eps)
        state["acc"] = acc
        state["acc_d"] = rho * acc_d + (1 - rho) * delta ** 2
        return p - lr * delta
    return step


@pytest.mark.parametrize("name,lr,keras", [
    ("rmsprop", 1e-2, _keras_rmsprop), ("adadelta", 1e-1, _keras_adadelta)])
def test_optimizer_matches_optax_and_keras_rule(name, lr, keras):
    """8 steps, the first 3 with tiny gradients (where eps placement
    matters), against optax and the numpy Keras rule of
    tests/test_train.py."""
    ours = getattr(optimizers, name)(lr)
    tx = getattr(jax_optimizers, name)(lr)
    rule = keras(lr, 0.9 if name == "rmsprop" else 0.95, 1e-7)
    p0 = np.float32([0.5, -1.0, 2.0, 0.25])
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ours([param])
    p_jax = jnp.asarray(p0)
    opt_state = tx.init(p_jax)
    p_ref = p0.astype(np.float64)
    rng = np.random.RandomState(0)
    for step in range(8):
        g = rng.randn(4).astype(np.float32) * (1e-4 if step < 3 else 1.0)
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, p_jax)
        p_jax = optax.apply_updates(p_jax, updates)
        p_ref = rule(p_ref, g.astype(np.float64))
        got = param.detach().numpy()
        np.testing.assert_allclose(got, p_ref, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got, np.asarray(p_jax), rtol=1e-6,
                                   atol=1e-7)


# -- BatchNorm ----------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 3, 5), (2, 3, 2, 4)])
def test_train_batch_norm_matches_jax(shape):
    """B=2, T=3 (and 2x3x2 for the 2-D layer): n = 6 or 12, where torch's
    unbiased running variance would be 6/5 or 12/11 of the batch's.  Output,
    running mean and running variance equal the JAX package's after two
    steps."""
    rng = np.random.RandomState(1)
    C = shape[-1]
    xs = [(rng.randn(*shape) * 3 + 1).astype(np.float32) for _ in range(2)]
    scale = rng.uniform(0.5, 2, C).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    mean0 = rng.randn(C).astype(np.float32)
    var0 = rng.uniform(0.5, 2, C).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    bn = (KerasBatchNorm1d if len(shape) == 3 else KerasBatchNorm)(C)
    with torch.no_grad():
        for t, a in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        (scale, bias, mean0, var0)):
            t.copy_(torch.from_numpy(a))
    bn.train()
    for x in xs:
        ref, upd = JaxBatchNorm().apply(variables, jnp.asarray(x), True,
                                        mutable=["batch_stats"])
        variables = {**variables, "batch_stats": upd["batch_stats"]}
        # channels last in JAX, channel axis 1 here
        xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
        got = np.moveaxis(bn(xt).detach().numpy(), 1, -1)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    stats = variables["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               rtol=1e-6, atol=1e-7)
    bn.eval()                        # inference is torch's own BatchNorm
    ref = JaxBatchNorm().apply(variables, jnp.asarray(xs[0]), False)
    got = bn(torch.from_numpy(np.moveaxis(xs[0], -1, 1).copy()))
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1),
                               np.asarray(ref), rtol=1e-5, atol=1e-6)


# -- model pieces -------------------------------------------------------------
def test_l2_penalty_matches_jax(narrow_tree):
    cfg = dataclasses.replace(NARROW, stage_l2=(0.3, 0.1, 0.2))
    tree = narrow_tree
    got = l2_penalty(port_model(tree, cfg), as_port(cfg))
    ref = jax_l2_penalty(jax.tree_util.tree_map(jnp.asarray, tree["params"]),
                         cfg)
    assert float(ref) > 0
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)


@pytest.mark.parametrize("head_units", [None, 2])
def test_inverse_converter_round_trip_is_exact(head_units):
    tree = perturbed_speaker_tree(head_units=head_units, seed=4)
    cfg = as_port(SpeakerModelConfig())
    back = speaker_tree_from_state_dict(
        speaker_state_dict_from_jax(tree, cfg, head_units), cfg, head_units)
    got, ref = flat(back), flat(tree)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_transfer_mode_keeps_the_lstm_training():
    model = SpeakerResBLSTM(as_port(NARROW), 2)
    transfer_mode_(model)
    kinds = {}
    for m in model.modules():
        kinds.setdefault(type(m).__name__, set()).add(m.training)
    assert kinds["LSTM"] == {True}
    assert kinds["KerasBatchNorm1d"] == kinds["SeededDropout"] == {False}
    assert all(isinstance(m, SeededDropout) for m in
               (model.trunk.dropout_trunk, model.trunk.dropout_head))
    lstm = model.trunk.bilstm.lstm
    assert not lstm.bias_hh_l0.requires_grad
    assert not lstm.bias_hh_l0_reverse.requires_grad
    assert lstm.bias_ih_l0.requires_grad


def test_seeded_dropout_draws_from_its_generator():
    drop = SeededDropout(0.5).train()
    x = torch.ones(1000)
    drop.generator = torch.Generator().manual_seed(3)
    a = drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    assert torch.equal(a, drop(x))
    assert set(a.unique().tolist()) == {0.0, 2.0}


# -- training against the JAX Trainer -----------------------------------------
def _trainers(tree, lr=1e-4):
    model = JaxSpeaker(NARROW)
    jt = JaxTrainer(model, jax_optimizers.rmsprop(lr),
                    jax_losses.keras_categorical_crossentropy,
                    extra_penalty_fn=lambda p: jax_l2_penalty(p, NARROW))
    state = jt.init_state(jax.tree_util.tree_map(jnp.asarray, tree))
    pt = Trainer(port_model(tree), optimizers.rmsprop(lr),
                 losses.keras_categorical_crossentropy,
                 extra_penalty_fn=lambda m: l2_penalty(m, as_port(NARROW)),
                 device="cpu")
    return jt, state, pt


def _port_tree(trainer):
    return speaker_tree_from_state_dict(trainer.model.state_dict(),
                                        as_port(NARROW))


def test_train_steps_match_jax(narrow_tree):
    """Two forward, backward and RMSprop steps in train mode, the second
    batch with a masked padding row: parameters (the LSTM's bias_ih +
    bias_hh against JAX's one bias) and batch statistics through the
    inverse converter."""
    tree = narrow_tree
    jt, state, pt = _trainers(tree)
    x, y = toy_data(8, seed=6)
    batches = [(x[:4], y[:4], np.ones(4, np.float32)),
               (x[4:], y[4:], np.float32([1, 1, 1, 0]))]
    step = jax.jit(jt._train_step)
    for bx, by, bm in batches:
        state, jloss, jacc = step(state, jnp.asarray(bx), jnp.asarray(by),
                                  jnp.asarray(bm), jax.random.PRNGKey(0))
        loss, acc = pt.train_step(torch.from_numpy(bx), torch.from_numpy(by),
                                  torch.from_numpy(bm))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(acc) == float(jacc)
    ref = {"params": state.params, "batch_stats": state.batch_stats}
    got = _port_tree(pt)
    assert_trees_close(got, jax.tree_util.tree_map(np.asarray, ref),
                       steps=2, lr=1e-4)
    # the steps moved the parameters far beyond the tolerance
    moved = max(np.abs(flat(got)[k] - flat(tree)[k]).max() for k in flat(tree))
    assert moved > 100 * ATOL
    lstm = pt.model.trunk.bilstm.lstm
    assert not lstm.bias_hh_l0.any() and not lstm.bias_hh_l0_reverse.any()


def _jax_permutations(rng, epochs, n):
    """The per-epoch permutations of JAX's ``Trainer.fit``
    (trainer.py:130-131, :299)."""
    perms = []
    for _ in range(epochs):
        rng, ep_rng = jax.random.split(rng)
        perm_rng, _ = jax.random.split(ep_rng)
        perms.append(np.asarray(jax.random.permutation(perm_rng, n)))
    return perms


def test_fit_matches_jax_with_a_partial_batch(narrow_tree):
    """2 epochs of 21 rows at batch 8 (3 padded rows BatchNorm sees),
    JAX's permutations injected; history and final tree.  Chunked evaluate
    equals the whole split."""
    tree = narrow_tree
    jt, state, pt = _trainers(tree)
    x, y = toy_data(21, seed=8)
    xv, yv = toy_data(5, seed=9)
    rng = jax.random.PRNGKey(3)
    state, jhist = jt.fit(state, x, y, epochs=2, batch_size=8, x_val=xv,
                          y_val=yv, rng=rng)
    hist = pt.fit(x, y, epochs=2, batch_size=8, x_val=xv, y_val=yv,
                  permutations=_jax_permutations(rng, 2, 24))
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4)
    for key in ("acc", "val_acc"):                 # float32 quotients there
        assert hist[key] == pytest.approx(jhist[key], abs=1e-6)
    ref = {"params": state.params, "batch_stats": state.batch_stats}
    assert_trees_close(_port_tree(pt), jax.tree_util.tree_map(np.asarray, ref),
                       steps=6, lr=1e-4)
    whole = pt.evaluate(x, y)
    for bs in (8, 21, 64):                         # ragged, exact, > n
        np.testing.assert_allclose(pt.evaluate(x, y, batch_size=bs), whole,
                                   rtol=1e-6)
    np.testing.assert_allclose(whole, jt.evaluate(state, x, y), rtol=1e-4)


def test_fit_schedule_early_stop_and_seeded_order(narrow_tree):
    """The epoch-indexed lr lands in the optimizer; at lr 0 only the batch
    statistics move, and training stops once the validation loss has not
    improved for 2 epochs; the same seed gives the same run."""
    tree = narrow_tree
    x, y = toy_data(12, seed=1)
    runs = []
    for _ in range(2):
        pt = _trainers(tree)[2]
        seen = []
        hist = pt.fit(x, y, epochs=30, batch_size=4, x_val=x, y_val=y,
                      early_stop_patience=2,
                      lr_schedule_epoch=lambda e: seen.append(e) or 0.0)
        assert pt.optimizer.param_groups[0]["lr"] == 0.0
        runs.append(hist)
    vl = runs[0]["val_loss"]
    assert len(vl) < 30 and seen == list(range(len(vl)))
    assert min(vl[-2:]) >= min(vl[:-2])            # the stopping rule held
    assert runs[0] == runs[1]


def test_pad_to_batches_matches_jax():
    x, y = toy_data(5)
    ref = jax_pad(x, y, 4)
    got = pad_to_batches(torch.from_numpy(x), torch.from_numpy(y), 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


# -- checkpoints --------------------------------------------------------------
def test_checkpoint_round_trip_and_best(tmp_path, narrow_tree):
    tree = narrow_tree
    sd = speaker_state_dict_from_jax(tree, as_port(NARROW))
    save_variables(tmp_path / "m", sd, as_port(NARROW), None, {"n": 3})
    got, head = load_variables(tmp_path / "m", as_port(NARROW))
    assert head == 3 and got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert (tmp_path / "m" / "metadata.json").read_text() == '{"n": 3}'
    best = BestCheckpointer(tmp_path / "best", as_port(NARROW))
    assert best.update(0.5, sd) and not best.update(0.4, sd)
    assert best.update(0.7, sd) and best.best == 0.7
    assert '"best_metric": 0.7' in (tmp_path / "best" /
                                    "metadata.json").read_text()
    # the file is the flat .npz a JAX host reads with np.load
    with np.load(tmp_path / "m" / "variables.npz") as data:
        np.testing.assert_array_equal(
            data["params/trunk/BiLSTM_0/forward/bias"],
            tree["params"]["trunk"]["BiLSTM_0"]["forward"]["bias"])
