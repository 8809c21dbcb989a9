"""The port's speaker model, converter and predictor vs the JAX package:
``SpeakerResBLSTM`` + ``params.speaker_state_dict_from_jax`` against
``SpeakerResBLSTM.apply`` at the full width of ``SpeakerModelConfig()``,
and ``SpeakerPredictor`` against JAX's.

Both models are built from one numpy tree: the JAX init, every leaf
perturbed from a seed (BatchNorm statistics and scales far from identity,
so a converter that swapped or dropped them fails).  Logits: rtol 1e-4,
atol 1e-5 (fp32 accumulation order; no TF32 on the CPU); probabilities:
atol 1e-4.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.core.config import SpeakerModelConfig
from mmla_audio_tpu.inference import SpeakerPredictor as JaxPredictor
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM as JaxSpeaker
from mmla_audio_torch.inference import SILENT, SpeakerPredictor
from mmla_audio_torch.models.layers import keras_init_
from mmla_audio_torch.models.speaker import SpeakerResBLSTM
from mmla_audio_torch.params import (load_speaker_npz, save_npz,
                                     speaker_state_dict_from_jax,
                                     speaker_tree_shapes)
from tests.conftest import synth_speech_i16
from tests.test_torch_model import as_port

torch.set_num_threads(1)

FULL = SpeakerModelConfig()


def perturbed_speaker_tree(cfg=FULL, head_units=None, seed=0,
                           input_shape=(256, 39)):
    """The JAX model's init tree as numpy, every leaf perturbed: BN
    variance and scale uniform in [0.5, 2), BN means and every other leaf
    plus Gaussian noise."""
    rng = np.random.RandomState(seed)
    tree = JaxSpeaker(cfg, head_units=head_units).init_variables(
        jax.random.PRNGKey(seed), input_shape=input_shape)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "'var'" in name or "'scale'" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        sigma = 0.05 if "kernel" in name else 0.1
        return (a + rng.normal(0.0, sigma, a.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jax.tree_util.tree_map(np.asarray, _plain(tree))


def _plain(node):
    return {k: _plain(v) for k, v in node.items()} \
        if hasattr(node, "items") else node


def _logits(cfg, tree, x, head_units=None):
    ref = np.asarray(JaxSpeaker(cfg, head_units=head_units).apply(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    model = SpeakerResBLSTM(as_port(cfg), head_units)
    model.load_state_dict(speaker_state_dict_from_jax(tree, as_port(cfg),
                                                      head_units))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    return got, ref


@pytest.mark.parametrize("head_units", [None, 3])
def test_speaker_tree_shapes_match_jax_init(head_units):
    tree = JaxSpeaker(FULL, head_units=head_units).init_variables(
        jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), _plain(tree))
    assert shapes == speaker_tree_shapes(as_port(FULL), head_units)
    leaves = jax.tree_util.tree_leaves(
        shapes, is_leaf=lambda s: isinstance(s, tuple))
    if head_units is None:     # the 630-way model, batch statistics included
        assert sum(int(np.prod(s)) for s in leaves) == 1_491_382
        assert len(leaves) == 128


def test_speaker_logits_match_jax_full_width():
    tree = perturbed_speaker_tree(seed=1)
    x = (np.random.RandomState(2).randn(2, 256, 39) * 3).astype(np.float32)
    got, ref = _logits(FULL, tree, x)
    assert got.shape == (2, 630)
    assert np.ptp(ref) > 1.0                   # the logits depend on x
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_speaker_logits_odd_frames():
    """230 frames: 230 -> 115 -> 58 -> 29 through the stages, so one SAME
    max-pool pads an odd length with -inf and its strided shortcut takes
    ceil(T/2); the VALID avg-pool floors 29 to 7 steps.  Narrow widths, a
    3-way head."""
    cfg = SpeakerModelConfig(stage_filters=(8, 8, 16), lstm_units=8)
    tree = perturbed_speaker_tree(cfg, head_units=3, seed=3,
                                  input_shape=(230, 39))
    x = (np.random.RandomState(4).randn(3, 230, 39) * 3).astype(np.float32)
    got, ref = _logits(cfg, tree, x, head_units=3)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_speaker_npz_round_trip(tmp_path):
    """The flat .npz carries the tree; the head's width comes from the
    file; a wrong tree is refused."""
    tree = perturbed_speaker_tree(head_units=3, seed=5)
    save_npz(tree, tmp_path / "w.npz")
    loaded, head = load_speaker_npz(tmp_path / "w.npz", as_port(FULL))
    assert head == 3
    sd = speaker_state_dict_from_jax(loaded, as_port(FULL), head)
    ref = speaker_state_dict_from_jax(tree, as_port(FULL), 3)
    assert sd.keys() == ref.keys()
    assert all(torch.equal(sd[k], ref[k]) for k in ref)
    assert sd["trunk.stem.weight"].shape == (32, 39, 4)
    del tree["batch_stats"]["trunk"]["stage1_unit0"]
    save_npz(tree, tmp_path / "bad.npz")
    with pytest.raises(ValueError, match="mismatch"):
        load_speaker_npz(tmp_path / "bad.npz", as_port(FULL))


@pytest.fixture(scope="module")
def windows():
    bufs = np.stack([synth_speech_i16(40960, seed=s) for s in range(4)])
    n = np.array([40960, 30001, 3999, 12000], np.int32)
    return bufs, n


@pytest.mark.parametrize("head_units,sigmoid", [(None, False), (3, True)])
def test_predictor_matches_jax(windows, head_units, sigmoid):
    """A softmax 630-way base model and a sigmoid 3-way enrolled head:
    labels equal, probabilities to 1e-4; the count below 4,000 is silent."""
    bufs, n = windows
    tree = perturbed_speaker_tree(head_units=head_units, seed=6)
    jax_pred = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree),
                            head_units=head_units, sigmoid_head=sigmoid)
    pred = SpeakerPredictor(
        speaker_state_dict_from_jax(tree, as_port(FULL), head_units),
        head_units=head_units, sigmoid_head=sigmoid, device="cpu")
    ref_l, ref_p = jax_pred.predict(bufs, n)
    labels, probs = pred.predict(bufs, n)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_l))
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_p), atol=1e-4)
    assert labels[2] == SILENT and (labels[[0, 1, 3]] >= 0).all()
    assert probs.shape == (4, head_units or 630)
    if not sigmoid:
        np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    # the single-window form gives the same answer (to 1e-5: a batch of one
    # takes other GEMM paths)
    l0, p0 = pred.predict(bufs[0], 40960)
    assert l0 == labels[0]
    np.testing.assert_allclose(p0.numpy(), probs[0].numpy(), atol=1e-5)


def test_predictor_silent_gate_and_defaults():
    """Counts below 4,000 are SILENT; ``"auto"`` is ``"highest"`` for this
    model; the device defaults to the card, with no CPU fallback."""
    sd = keras_init_(SpeakerResBLSTM(as_port(FULL), 2),
                     torch.Generator().manual_seed(0)).state_dict()
    pred = SpeakerPredictor(sd, head_units=2, device="cpu")
    assert pred.matmul_precision == "highest"
    assert SpeakerPredictor(sd, head_units=2, device="cpu",
                            matmul_precision=None).matmul_precision is None
    buf = np.stack([synth_speech_i16(40960, seed=9)] * 4)
    labels, _ = pred.predict(buf, [3999, 0, 4000, 40960])
    assert labels.tolist()[:2] == [SILENT, SILENT]
    assert (labels[2:] >= 0).all()
    assert inspect.signature(SpeakerPredictor.__init__).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            SpeakerPredictor(sd, head_units=2)
