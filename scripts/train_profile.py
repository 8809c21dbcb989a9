"""Where the time of speaker training goes on one CUDA card.

    env PYTHONPATH=. python3 scripts/train_profile.py [--steps 20]

At the full width of ``SpeakerModelConfig()`` from ``chip_smoke.py``'s
seeded base tree, on features of its seeded voices, three loops are warmed
up and then traced with ``torch.profiler``:

* registration phase 1: head-only steps at b16 on the trunk's embeddings
  (``TransferLearner._phase1``);
* registration phase 2: full-model steps at b8 in transfer mode
  (``TransferLearner._phase2``);
* pretrain: ``Trainer.train_step`` at b32 with the 630-way head, dropout
  on.

For each: the host-clock time a step (synchronized), the device's busy time
a step (the union of its kernels' and copies' intervals in the trace, user
annotations left out), the idle share (1 - busy / host time), the launches
a step and the kernels that take the most device time.  Prints the card's name and power limit first.
Without a CUDA device the script stops before doing anything.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from mmla_audio_torch.core.config import PipelineConfig
from mmla_audio_torch.data.corpus import featurize_clips
from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_torch.params import (speaker_state_dict_from_jax,
                                     speaker_tree_shapes)
from mmla_audio_torch.precision import fp32_policy
from mmla_audio_torch.train.losses import keras_categorical_crossentropy
from mmla_audio_torch.train.optimizers import rmsprop
from mmla_audio_torch.train.trainer import Trainer
from mmla_audio_torch.train.transfer import TransferLearner


def trace(name: str, run, steps: int) -> None:
    """Warm ``run`` up, then time and trace it (``chip_smoke.profile_steps``);
    ``run()`` does ``steps`` steps."""
    prof = cs.profile_steps(run, steps)
    if prof["busy_ms"] is None:
        print(f"[{name}] host {prof['host_ms']:.3f} ms a step; the trace "
              f"holds no device events: busy time not measured")
        return
    top = ", ".join(f"{n[:60]} {ms:.3f}" for n, ms in prof["top"])
    print(f"[{name}] host {prof['host_ms']:.3f} ms a step; device busy "
          f"{prof['busy_ms']:.3f} ms a step (idle share {prof['idle']:.3f}); "
          f"{prof['launches']:.1f} launches a step; top kernels (ms a "
          f"step): {top}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig()
    mcfg = cfg.speaker_model
    base = speaker_state_dict_from_jax(cs.seeded_tree(
        speaker_tree_shapes(mcfg), np.random.RandomState(7)), mcfg)
    clips = [cs.voice(2.6, i % 8, seed=500 + i) for i in range(64)]
    x, y, _ = featurize_clips(clips, [f"s{i % 8}" for i in range(64)],
                              dim=mcfg.num_speakers, cfg=cfg.speaker_feature,
                              device=dev)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    steps = args.steps

    learner = TransferLearner(base, 8, mcfg, cfg.transfer, device=dev)
    model = learner.init_model(0)
    y8, mask = yt[:, :8], torch.ones(len(x), device=dev)
    g = torch.Generator().manual_seed(0)
    for name, phase, batch in (("phase 1, b16", learner._phase1, 16),
                               ("phase 2, b8", learner._phase2, 8)):
        per_epoch = len(x) // batch
        perms = [torch.randperm(len(x), generator=g).to(dev)
                 for _ in range(-(-steps // per_epoch))]

        def run(phase=phase, perms=perms, batch=batch):
            with fp32_policy(False):
                phase(model, xt, y8, mask, perms, batch)
        trace(name, run, len(perms) * per_epoch)

    model = SpeakerResBLSTM(mcfg)
    model.load_state_dict(base)
    tr = Trainer(model, rmsprop(cfg.speaker_train.lr),
                 keras_categorical_crossentropy,
                 extra_penalty_fn=lambda m: l2_penalty(m, mcfg), device=dev)
    ones = torch.ones(32, device=dev)

    def pretrain():
        for i in range(steps):
            sl = slice(32 * (i % 2), 32 * (i % 2) + 32)
            tr.train_step(xt[sl], yt[sl], ones)
    trace("pretrain, b32", pretrain, steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
