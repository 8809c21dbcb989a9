"""``analyze/accuracy_sweep.py`` vs the JAX package's: ``run_sweep`` at a
narrow speaker width (held-out accuracies of the transfer fine-tune across
seeds, the port's fine-tunes replaying the head init and permutations of
JAX's ``fit_once``), ``parse_acc_file`` and ``render_violin_html``.  The
rows and the documents are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmla_audio_tpu.analyze import accuracy_sweep as jax_sweep
from mmla_audio_tpu.core.config import SpeakerModelConfig, TransferConfig
from mmla_audio_tpu.train.transfer import TransferLearner as JaxLearner
from mmla_audio_torch.analyze import accuracy_sweep
from mmla_audio_torch.params import speaker_state_dict_from_jax
from mmla_audio_torch.train.transfer import TransferLearner, train_val_split
from tests.test_torch_model import as_port
from tests.test_torch_speaker import perturbed_speaker_tree
from tests.test_torch_train import T, toy_data
from tests.test_torch_transfer import _jax_head_and_permutations

torch.set_num_threads(1)


class _Replay:
    """The port's ``TransferLearner`` fed, for each fine-tune, the head init
    and permutations JAX's ``fit_once`` draws for the same call."""

    def __init__(self, learner, jax_learner):
        self.learner, self.jax_learner = learner, jax_learner

    def __getattr__(self, name):
        return getattr(self.learner, name)

    def fit_once(self, x, y, seed=0, epochs_override=None):
        n1, n2 = epochs_override
        n = len(train_val_split(x, y, 0.3, seed)[0])
        cfg = self.learner.cfg
        lcm = np.lcm(cfg.phase1_batch, cfg.phase2_batch)
        total = max(lcm, -(-n // lcm) * lcm)
        head, perms = _jax_head_and_permutations(self.jax_learner, seed,
                                                 total, n1, n2)
        return self.learner.fit_once(x, y, seed=seed, epochs_override=(n1, n2),
                                     head=head, permutations=perms)


def test_run_sweep_matches_jax_rows(tmp_path):
    """One ratio x three seeds (one shape, so JAX compiles its fine-tune
    once) at a narrow speaker width, 2 + 1 epochs: the ``acc.txt`` rows
    equal, and ``parse_acc_file`` reads them back."""
    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=10)
    tree = perturbed_speaker_tree(cfg, seed=11, input_shape=(T, 39))
    x, y = toy_data(30, seed=12)
    kw = dict(ratios=(0.3,), seeds=(0, 1, 2), epochs_override=(2, 1))
    jl = JaxLearner(jax.tree_util.tree_map(jnp.asarray, tree), 3, cfg,
                    TransferConfig())
    ref = jax_sweep.run_sweep(jl, x, y, acc_path=tmp_path / "jax.txt", **kw)
    port = TransferLearner(speaker_state_dict_from_jax(tree, as_port(cfg)), 3,
                           as_port(cfg), device="cpu")
    got = accuracy_sweep.run_sweep(_Replay(port, jl), x, y,
                                   acc_path=tmp_path / "acc.txt", **kw)
    assert got == ref
    assert (tmp_path / "acc.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    parsed = accuracy_sweep.parse_acc_file(tmp_path / "acc.txt")
    assert parsed == jax_sweep.parse_acc_file(tmp_path / "acc.txt") == got
    assert len(got[0.3]) == 3


@pytest.mark.parametrize("results", [
    {0.2: [0.8, 0.9, 0.85], 0.3: [0.7], 0.5: [0.6, 0.6]},
    {0.4: [1.0, 0.95, 0.5, 0.75, 0.9]}])
def test_render_violin_html_matches_jax(tmp_path, results):
    """Lanes of several points, of one point and of equal points (the
    kernel density's fallback bandwidth): the same document."""
    for mod, name in ((accuracy_sweep, "a.html"), (jax_sweep, "b.html")):
        mod.render_violin_html(results, tmp_path / name, title="t & u")
    assert (tmp_path / "a.html").read_text() == \
        (tmp_path / "b.html").read_text()
