"""Learning-rate schedules (counterpart of ``mmla_audio_tpu.train.schedules``).

Cosine annealing as the reference's Keras callback (`cosine_annealing.py:
6-28`): ``lr(e) = eta_min + (eta_max - eta_min) * (1 + cos(pi * e /
t_max)) / 2``, indexed by EPOCH (Keras callbacks fire at each epoch's
start), so epoch 0 trains at ``eta_max``, not at the optimizer's own lr.
``Trainer.fit(lr_schedule_epoch=)`` writes the value into every parameter
group.  ``steps_per_epoch`` maps a step index to its epoch, as the JAX
schedule does for optax; the port's trainers index by epoch and leave it
at 1, so it only keeps the JAX signature.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["cosine_annealing"]


def cosine_annealing(t_max: int = 100, eta_max: float = 1e-2,
                     eta_min: float = 1e-4, steps_per_epoch: int = 1
                     ) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return eta_min + (eta_max - eta_min) * (
            1.0 + math.cos(math.pi * epoch / t_max)) / 2.0
    return schedule
