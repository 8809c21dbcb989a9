"""The configuration kind ``speaker``: the program's ``SpeakerPredictor``
(a registered group's sigmoid head) and ``SpeakerSession`` built from a
configuration, and what the comparison needs of this kind."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.overlap import tf32_round

# where the program calls its featurizer, (module, name): the tap keeps
# its input, the trimmed window and its kept count
FEATURIZERS = (("mmla_audio_torch.streaming.multiplex",
                "speaker_feature_batch"),
               ("mmla_audio_torch.inference", "speaker_feature_batch"))

# the speaker model runs no fused block
FUSED = ()
BLOCK_WINDOWS = 0


def build(system):
    """``(cfg, predictor, silent_samples)`` of ``system``'s configuration."""
    from mmla_audio_torch.core.config import (PipelineConfig,
                                              SpeakerFeatureConfig,
                                              SpeakerModelConfig)
    from mmla_audio_torch.inference import SpeakerPredictor

    from perfbench.system import fields

    cfg = dataclasses.replace(
        PipelineConfig(),
        speaker_model=fields(SpeakerModelConfig, system.model),
        speaker_feature=fields(SpeakerFeatureConfig, system.feature))
    precision = None if system.config["matmul_precision"] == "tf32" \
        else "highest"
    pred = SpeakerPredictor(system.sd, cfg.speaker_model, cfg.speaker_feature,
                            head_units=system.model["head_units"],
                            sigmoid_head=True, device=system.device,
                            matmul_precision=precision)
    return cfg, pred, cfg.speaker_feature.silent_samples


def session(system, capture, dirs):
    from mmla_audio_torch.streaming.session import SpeakerSession

    return SpeakerSession(system.pred, capture, dirs, cfg=system.cfg)


def label_name(label: int) -> str:
    """The name the program's logs give a label (a speaker's index)."""
    return "silent" if label < 0 else str(label)


def featurizer_row(args, r: int):
    """What the tap keeps of row ``r`` of the featurizer's input."""
    return (args[0][r].detach().clone(), int(args[1][r]))


def program_trimmed(fin) -> tuple:
    """(the int16 samples, the kept count) of what the tap kept of the
    featurizer's input: the trimmed window at int16 scale, its count."""
    w, n = fin
    return torch.round(w.float()).to(torch.int32).numpy(), int(n)


def ref_inputs(system, trimmed, kept) -> torch.Tensor:
    """The reference's MFCC-39 rows of trimmed int16 windows."""
    return system.ref.features(trimmed, kept, system.feature, system.device)


def ref_inputs_of_program(system, rows) -> torch.Tensor:
    """The reference's MFCC-39 rows of the windows the program's
    featurizer was given."""
    x = torch.stack([w.float().cpu() for w, _ in rows])
    i16 = torch.round(x).clamp(-32768, 32767).to(torch.int16).numpy()
    kept = np.asarray([n for _, n in rows])
    return system.ref.features(i16, kept, system.feature, system.device)


def inputs_agree(xp, xr, limits) -> bool:
    """Every coefficient within ``feature_rtol`` of the largest."""
    d = (xp - xr).abs()
    return bool(d.max() <= limits["feature_rtol"]
                * xr.abs().max().clamp_min(1e-12))


def ref_logits(system, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Reference logits of MFCC rows ``x``, with TF32 off: ``fp32``;
    ``tf32``, each product's operands rounded to TF32; ``bf16``."""
    m, sd = system.model, system.sd
    if precision == "bf16":
        sd = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in sd.items()}
        return system.ref.forward(sd, x.to(torch.bfloat16), m).float()
    if precision == "tf32":
        return system.ref.forward(sd, x, m, rnd=tf32_round)
    if precision == "fp32":
        return system.ref.forward(sd, x, m)
    raise ValueError(f"unknown precision {precision!r}")


def block_gaps(system, blocks: dict, precision=None) -> list:
    return []
