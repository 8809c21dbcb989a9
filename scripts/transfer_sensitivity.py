"""How far the registration fine-tune amplifies a rounding-sized change of
its input.

    env PYTHONPATH=. python3 scripts/transfer_sensitivity.py [--device cpu]
        [--phase2-epochs 0 1 5 20] [--perturbation 1e-7]

Builds ``chip_smoke.py``'s registration corpus (its three seeded voices of
60 s, written straight to a corpus directory, no denoise or VAD) and base
model (phase 7's seeded tree, full width), then for each count of phase-2
epochs runs ``TransferLearner.fit_once`` twice on one device: on the
features, and on the features times ``1 + perturbation`` (about one float32
ulp at 1e-7).  Prints the largest difference of the validation logits as a
share of their largest magnitude, and both validation accuracies.  Both runs
share the split, the head init and the permutations, so the difference is
the training's own amplification of the perturbation; it bounds from below
how far two devices, whose arithmetic differs by rounding in every step,
can agree.  Runs on the CPU unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke as cs
from mmla_audio_torch.core.config import PipelineConfig
from mmla_audio_torch.data.corpus import featurize_corpus
from mmla_audio_torch.data.wavio import write_wav
from mmla_audio_torch.params import (speaker_state_dict_from_jax,
                                     speaker_tree_shapes)
from mmla_audio_torch.train.transfer import TransferLearner


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--phase2-epochs", type=int, nargs="+",
                    default=[0, 1, 5, 20])
    ap.add_argument("--perturbation", type=float, default=1e-7)
    args = ap.parse_args()
    cfg = PipelineConfig()
    mcfg = cfg.speaker_model
    base = speaker_state_dict_from_jax(cs.seeded_tree(
        speaker_tree_shapes(mcfg), np.random.RandomState(7)), mcfg)
    with tempfile.TemporaryDirectory() as tmp:
        for k, name in enumerate(cs.SPEAKERS):
            write_wav(Path(tmp) / f"{name}.wav",
                      cs.voice(cs.ENROLL_SECONDS, k, seed=70 + k))
        x, y, _ = featurize_corpus(tmp, cfg.speaker_feature,
                                   device=args.device)
    print(f"device {args.device}, {len(x)} windows, perturbation "
          f"{args.perturbation}", flush=True)
    for n2 in args.phase2_epochs:
        out = []
        for scale in (1.0, 1.0 + args.perturbation):
            learner = TransferLearner(base, len(cs.SPEAKERS), mcfg,
                                      cfg.transfer, device=args.device)
            _, acc, _ = learner.fit_once(
                x * np.float32(scale), y, seed=0,
                epochs_override=(cfg.transfer.phase1_epochs, n2))
            out.append((acc, learner.report["val_logits"]))
        (acc_a, za), (acc_b, zb) = out
        share = float(np.abs(za - zb).max() / np.abs(za).max())
        print(f"{cfg.transfer.phase1_epochs}+{n2} epochs: max |dlogit| "
              f"{share:.3g} of max |logit|; val acc {acc_a:.4f} / "
              f"{acc_b:.4f}", flush=True)


if __name__ == "__main__":
    main()
