"""Pieces of the port's overlap training vs the JAX package, on
numpy-seeded inputs: the cosine schedule, the stratified k-fold split, the
pyramid ladder (also against OpenCV where ``cv2`` is installed; the port
never imports it), pyramid rebalancing, the inverse converter and overlap
checkpoints served by ``OverlapPredictor``, and ``evaluation`` whole and
chunked.

Tolerances: the schedule within 1e-6 of its eta_max (JAX computes it in
float32, the cosine's argument rounded to float32 too); the pyramid ops 1e-5 of JAX's
(the same float32 sums in the same order) and the JAX suite's own 1e-2 /
5e-2 against ``cv2`` (`tests/test_image_synth.py`); rebalanced copies
1e-4; the split, the counts, the converter round trip and the
evaluation's counts exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core.config import OverlapModelConfig, OverlapTrainConfig
from mmla_audio_tpu.ops import image as jax_image
from mmla_audio_tpu.train import overlap_trainer as jax_ot
from mmla_audio_tpu.train.schedules import cosine_annealing as jax_cosine
from mmla_audio_torch.inference import OverlapPredictor
from mmla_audio_torch.models.layers import SeededDropout
from mmla_audio_torch.models.overlap import OverlapResBLSTM, keras_init_
from mmla_audio_torch.ops import image
from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                     overlap_tree_from_state_dict,
                                     overlap_tree_shapes, save_npz)
from mmla_audio_torch.train.checkpoints import (BestCheckpointer,
                                                load_variables,
                                                save_variables)
from mmla_audio_torch.train.overlap_trainer import (OverlapTrainer,
                                                    augment_to_balance,
                                                    confusion_matrix,
                                                    stratified_kfold_indices)
from mmla_audio_torch.train.schedules import cosine_annealing
from tests.test_overlap_trainer import _toy_images
from tests.test_torch_model import as_port
from tests.test_torch_train import flat

torch.set_num_threads(1)

NARROW = OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8)


def numpy_tree(cfg, seed):
    """A tree of ``overlap_tree_shapes(cfg)`` drawn from a seed: BatchNorm
    variances and scales in [0.5, 2), kernels at a fan-in scale, every
    other leaf N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def draw(shapes):
        out = {}
        for k, v in shapes.items():
            if isinstance(v, dict):
                out[k] = draw(v)
            elif k in ("var", "scale"):
                out[k] = rng.uniform(0.5, 2.0, v).astype(np.float32)
            elif k in ("kernel", "recurrent_kernel"):
                out[k] = (rng.randn(*v) / np.sqrt(np.prod(v[:-1]))).astype(
                    np.float32)
            else:
                out[k] = (rng.randn(*v) * 0.1).astype(np.float32)
        return out
    return draw(overlap_tree_shapes(as_port(cfg)))


def test_cosine_annealing_matches_jax():
    """Epochs 0..300 at the default config and at another one; epoch 0 is
    eta_max, not the optimizer's lr."""
    for kw in (dict(eta_max=1e-2), dict(t_max=7, eta_max=0.5, eta_min=0.01,
                                        steps_per_epoch=3)):
        ours, theirs = cosine_annealing(**kw), jax_cosine(**kw)
        got = np.array([ours(e) for e in range(301)])
        ref = np.array([float(theirs(e)) for e in range(301)])
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * kw["eta_max"])
    assert cosine_annealing()(0) == 1e-2


@pytest.mark.parametrize("counts,n_splits,fold", [
    ((50, 30, 20), 5, 0), ((50, 30, 20), 5, 3), ((7, 13), 5, 0),
    ((6300, 6300), 5, 0), ((3, 4, 5, 6), 3, 2)])
def test_stratified_kfold_matches_jax(counts, n_splits, fold):
    """Classes in a shuffled order (first appearance decides the
    encoding)."""
    labels = np.concatenate([np.full(n, c) for c, n in enumerate(counts)])
    labels = labels[np.random.RandomState(len(labels)).permutation(
        len(labels))]
    got = stratified_kfold_indices(labels, n_splits, seed=0, fold=fold)
    ref = jax_ot.stratified_kfold_indices(labels, n_splits, seed=0,
                                          fold=fold)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def _images(shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) * 255).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(2, 128, 151, 3), (3, 33, 39, 3),
                                   (1, 32, 40, 1)])
def test_pyr_down_and_up_match_jax(shape):
    x = _images(shape)
    for name in ("pyr_down", "pyr_up"):
        got = getattr(image, name)(torch.from_numpy(x)).numpy()
        ref = np.asarray(getattr(jax_image, name)(jnp.asarray(x)))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 128, 151, 3), (3, 33, 39, 3)])
def test_pyramid_augment_matches_jax(shape, depth):
    """Odd and even sizes: the 151 -> 152 width carried through the rounds,
    an odd height cropped each round, the last column dropped at the
    end."""
    x = _images(shape, seed=depth)
    got = image.pyramid_augment(torch.from_numpy(x), depth).numpy()
    ref = np.asarray(jax_image.pyramid_augment(jnp.asarray(x), depth))
    assert got.shape == ref.shape == shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pyramid_augment_matches_cv2_ladder(depth):
    """The reference's own ladder (`augment_images`): cv2.pyrDown and
    pyrUp rounds, the final ``[:, :-1]``; pyrDown/pyrUp alone at the JAX
    suite's 1e-2."""
    cv2 = pytest.importorskip("cv2")
    x = _images((128, 151, 3), seed=10 + depth)
    np.testing.assert_allclose(
        image.pyr_down(torch.from_numpy(x)).numpy(), cv2.pyrDown(x),
        atol=1e-2)
    small = _images((64, 76, 3), seed=20 + depth)
    np.testing.assert_allclose(
        image.pyr_up(torch.from_numpy(small)).numpy(), cv2.pyrUp(small),
        atol=1e-2)
    src = x
    for _ in range(depth):
        src = cv2.pyrUp(cv2.pyrDown(src))
    got = image.pyramid_augment(torch.from_numpy(x)[None], depth)[0]
    np.testing.assert_allclose(got.numpy(), src[:, :-1], atol=5e-2)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_augment_to_balance_matches_jax(as_tensor):
    """20 singles, 8 overlaps: class 1 copied round(20 / 8 - 1) = 2 times,
    through 1 and 2 pyramid rounds.  Counts, labels and the originals
    equal JAX's; the blurred copies within 1e-4.  A tensor comes back a
    tensor; balanced classes come back untouched."""
    x, y = _toy_images(20, 8, seed=3)
    ref_x, ref_y = jax_ot.augment_to_balance(x, y)
    xin = torch.from_numpy(x) if as_tensor else x
    got_x, got_y = augment_to_balance(xin, y)
    assert isinstance(got_x, torch.Tensor) == as_tensor
    got_x = got_x.numpy() if as_tensor else got_x
    np.testing.assert_array_equal(got_y, ref_y)
    assert got_y.sum(0).tolist() == [20, 24]
    np.testing.assert_array_equal(got_x[:28], x)
    np.testing.assert_allclose(got_x, np.asarray(ref_x), rtol=1e-4,
                               atol=1e-4)
    balanced = y[:16].copy()
    balanced[8:] = balanced[8:, ::-1]
    xs = xin[:16]
    out_x, out_y = augment_to_balance(xs, balanced)
    assert out_x is xs and out_y is balanced


def test_confusion_matrix_matches_jax():
    t, p = np.array([0, 0, 1, 2, 2, 2]), np.array([0, 1, 1, 2, 0, 2])
    np.testing.assert_array_equal(confusion_matrix(t, p, 3),
                                  jax_ot.confusion_matrix(t, p, 3))


def test_inverse_converter_round_trip_is_exact():
    """Tree -> state_dict -> tree, leaf for leaf, at the narrow and the
    default width; with both torch LSTM biases set, the Keras bias is their
    sum."""
    for cfg in (NARROW, OverlapModelConfig()):
        tree = numpy_tree(cfg, seed=4)
        sd = overlap_state_dict_from_jax(tree, as_port(cfg))
        got, ref = flat(overlap_tree_from_state_dict(sd, as_port(cfg))), \
            flat(tree)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        hh = torch.randn(sd["bilstm.lstm.bias_hh_l0_reverse"].shape,
                         generator=torch.Generator().manual_seed(1))
        sd["bilstm.lstm.bias_hh_l0_reverse"] = hh
        back = overlap_tree_from_state_dict(sd, as_port(cfg))
        np.testing.assert_array_equal(
            back["params"]["BiLSTM_0"]["backward"]["bias"],
            (sd["bilstm.lstm.bias_ih_l0_reverse"] + hh).numpy())


def test_overlap_checkpoint_serves_through_the_predictor(tmp_path):
    """``save_variables`` of an overlap state_dict loads back bit for bit
    (``load_variables``, ``BestCheckpointer``), its ``variables.npz`` is
    what ``save_npz`` writes of the inverse tree, and ``OverlapPredictor``
    built from it gives the logits of the model it came from."""
    cfg = as_port(NARROW)
    model = keras_init_(OverlapResBLSTM(cfg), torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in model.parameters():
            if p.requires_grad:            # bias_hh stays 0, as in training
                p.add_(0.05 * torch.randn(
                    p.shape, generator=torch.Generator().manual_seed(p.numel())))
        for m in model.modules():
            if hasattr(m, "running_var"):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    sd = model.state_dict()
    save_variables(tmp_path / "m", sd, cfg, metadata={"epoch": 4})
    got, head = load_variables(tmp_path / "m", cfg)
    assert head is None
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    save_npz(overlap_tree_from_state_dict(sd, cfg), tmp_path / "ref.npz")
    with np.load(tmp_path / "m" / "variables.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    best = BestCheckpointer(tmp_path / "best", cfg)
    assert best.update(0.5, sd) and not best.update(0.5, sd)
    pred = OverlapPredictor(got, cfg, device="cpu")
    x = torch.from_numpy(_images((3, 32, 39, 3), seed=5))
    with torch.no_grad():
        np.testing.assert_array_equal(pred.apply_model(x).numpy(),
                                      model.eval()(x).numpy())


@pytest.mark.parametrize("eval_batch_size", [512, 4, 3])
def test_evaluation_matches_jax(eval_batch_size):
    """A perturbed narrow tree: confusion matrix, recall, precision and
    accuracy equal JAX's ``evaluation`` over 28 rows, whole (512), in
    chunks of 4 that divide them and in chunks of 3 whose tail is padded;
    chunked equals whole."""
    tree = numpy_tree(NARROW, seed=6)
    x, y = _toy_images(20, 8, seed=7)
    x = x / 255.0                  # keeps the narrow model input-sensitive
    state = types.SimpleNamespace(
        params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"]))
    jt = jax_ot.OverlapTrainer(NARROW, OverlapTrainConfig(
        eval_batch_size=eval_batch_size))
    ref = jt.evaluation(state, x, y)
    pt = OverlapTrainer(as_port(NARROW), as_port(OverlapTrainConfig(
        eval_batch_size=eval_batch_size)), device="cpu")
    got = pt.evaluation(overlap_state_dict_from_jax(tree, as_port(NARROW)),
                        x, y)
    np.testing.assert_array_equal(got["confusion"], ref["confusion"])
    np.testing.assert_array_equal(got["recall"], ref["recall"])
    np.testing.assert_array_equal(got["precision"], ref["precision"])
    assert got["accuracy"] == ref["accuracy"]
    assert 0 < ref["confusion"][:, 1].sum() < len(x)   # both labels occur


def test_model_blocks_see_contiguous_nchw_from_a_channels_last_image():
    """A contiguous (B, H, W, 3) image, as a gather, a concatenation or the
    plain featurizer gives, reaches every residual block as contiguous
    NCHW: a channels-last activation would make the fused block refuse it
    on the card."""
    model = OverlapResBLSTM(as_port(NARROW)).eval()
    seen = []
    for block in model.blocks:
        block.register_forward_pre_hook(
            lambda m, args: seen.append(args[0].is_contiguous()))
    with torch.no_grad():
        model(torch.from_numpy(_images((2, 32, 39, 3))))
    assert seen == [True] * len(model.blocks)


def test_overlap_dropout_draws_from_the_trainer_generator():
    """The head's dropout is ``SeededDropout`` (the state_dict keys are
    unchanged), and a ``Trainer`` gives it its device generator."""
    from mmla_audio_torch.train.losses import keras_categorical_crossentropy
    from mmla_audio_torch.train.optimizers import adadelta
    from mmla_audio_torch.train.trainer import Trainer

    model = OverlapResBLSTM(as_port(NARROW))
    assert isinstance(model.dropout, SeededDropout)
    assert set(model.state_dict()) == set(overlap_state_dict_from_jax(
        numpy_tree(NARROW, seed=8), as_port(NARROW)))
    tr = Trainer(model, adadelta(), keras_categorical_crossentropy,
                 device="cpu", seed=4)
    assert isinstance(model.dropout.generator, torch.Generator)
    x = torch.from_numpy(_images((4, 32, 39, 3)))
    tr.model.train()
    a = [tr.model(x) for _ in range(2)]
    assert not torch.equal(a[0], a[1])
