"""The configuration kind ``overlap``: the program's ``OverlapPredictor``
and ``OverlapSession`` built from a configuration, and what the comparison
needs of this kind (the label names, the featurizer the tap watches, the
reference's model inputs and logits, when two inputs agree)."""

from __future__ import annotations

import dataclasses

import torch

from perfbench.reference.overlap import tf32_round

# where the program calls its featurizer, (module, name): the tap keeps
# its input, the trimmed window / 32768, for the sampled windows
FEATURIZERS = (("mmla_audio_torch.streaming.multiplex",
                "overlap_model_input_cuda"),
               ("mmla_audio_torch.inference", "overlap_model_input_cuda"))

# the program's fused residual block (kernel B3), (module, name): the tap
# keeps its input and output in the first BLOCK_WINDOWS compared windows
FUSED = (("mmla_audio_torch.models.overlap", "fused_resblock_cuda"),)
BLOCK_WINDOWS = 8


def build(system):
    """``(cfg, predictor, silent_samples)`` of ``system``'s configuration."""
    from mmla_audio_torch.core.config import (OverlapFeatureConfig,
                                              OverlapModelConfig,
                                              PipelineConfig)
    from mmla_audio_torch.inference import OverlapPredictor

    from perfbench.system import fields

    cfg = dataclasses.replace(
        PipelineConfig(),
        overlap_model=fields(OverlapModelConfig, system.model),
        overlap_feature=fields(OverlapFeatureConfig, system.feature))
    precision = None if system.config["matmul_precision"] == "tf32" \
        else "highest"
    pred = OverlapPredictor(system.sd, cfg.overlap_model, cfg.overlap_feature,
                            device=system.device, matmul_precision=precision,
                            silent_threshold=cfg.vad.silent_samples)
    return cfg, pred, cfg.vad.silent_samples


def session(system, capture, dirs):
    from mmla_audio_torch.streaming.session import OverlapSession

    return OverlapSession(system.pred, capture, dirs, cfg=system.cfg)


def label_name(label: int) -> str:
    """The name the program's logs give a label."""
    from mmla_audio_torch.analyze.logs import OVERLAP_LABELS

    return "silent" if label < 0 else OVERLAP_LABELS[str(label)]


def featurizer_row(args, r: int):
    """What the tap keeps of row ``r`` of the featurizer's input."""
    return args[0][r].detach().clone()


def program_trimmed(fin) -> tuple:
    """(the int16 samples, the kept count or None) of what the tap kept of
    the featurizer's input: the trimmed window's first samples / 32768."""
    return torch.round(fin.float() * 32768.0).to(torch.int32).numpy(), None


def ref_inputs(system, trimmed, kept) -> torch.Tensor:
    """The reference's images of trimmed int16 windows."""
    return system.ref.image(trimmed, system.feature, system.device)


def ref_inputs_of_program(system, rows) -> torch.Tensor:
    """The reference's images of the windows the program's featurizer was
    given (each at int16 scale / 32768)."""
    y = torch.stack([r.float().cpu() for r in rows]) * 32768.0
    i16 = torch.round(y).clamp(-32768, 32767).to(torch.int16).numpy()
    return system.ref.image(i16, system.feature, system.device)


def inputs_agree(xp, xr, limits) -> bool:
    """No pixel more than one level apart, at most ``pixel_share`` of them
    one level apart (float32 against float64 before the image's floor)."""
    d = (xp - xr).abs()
    return bool(d.max() <= 1.0
                and (d > 0).float().mean() <= limits["pixel_share"])


def ref_logits(system, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Reference logits of images ``x``, with TF32 off: ``fp32``;
    ``tf32``, each product's operands rounded to TF32; ``tf32_fused_fp32``,
    the same but the fused residual blocks (kernel B3, 3xTF32) in fp32;
    ``bf16``, everything in bfloat16."""
    m, sd = system.model, system.sd
    if precision == "bf16":
        sd = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in sd.items()}
        return system.ref.forward(sd, x.to(torch.bfloat16), m).float()
    if precision == "tf32":
        return system.ref.forward(sd, x, m, rnd=tf32_round)
    if precision == "tf32_fused_fp32":
        return system.ref.forward(sd, x, m, rnd=tf32_round,
                                  rnd_fused=lambda t: t)
    if precision == "fp32":
        return system.ref.forward(sd, x, m)
    raise ValueError(f"unknown precision {precision!r}")


def block_gaps(system, blocks: dict, precision=None) -> list:
    """Each kept window's fused blocks, in the model's order: the largest
    difference of the program's output (or, with ``precision``, the
    reference's at that precision) from the reference block's in fp32 on
    the same input, over the reference's largest."""
    prefixes = system.ref.fused_blocks(system.model)
    eps = system.model["bn_eps"]
    sd, dev = system.sd, system.device
    out = []
    for calls in blocks.values():
        for p, (x, y) in zip(prefixes, calls):
            x = x[None].float().to(dev)
            ref = system.ref.fused_block(sd, p, x, eps)
            if precision == "bf16":
                sdb = {k: v.to(torch.bfloat16) if v.is_floating_point()
                       else v for k, v in sd.items()}
                y = system.ref.fused_block(sdb, p, x.to(torch.bfloat16),
                                           eps).float()
            elif precision is not None:
                raise ValueError(f"unknown precision {precision!r}")
            y = y.float().to(dev).reshape(ref.shape)
            out.append(float((y - ref).abs().max()
                             / ref.abs().max().clamp_min(1e-30)))
    return out
