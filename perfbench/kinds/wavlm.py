"""The configuration kind ``wavlm``: the program's ``WavLMPredictor`` and
``WavLMSession`` built from a configuration (WavLM Large as the overlap
detector), and what the comparison needs of this kind: the overlap
detector's label names, the normalisation the tap watches, the
reference's model inputs (normalised samples, then the kept count) and
logits, when two inputs agree."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.overlap import tf32_round

# where the program calls its normalisation, (module, name): the tap keeps
# its input, the trimmed window at int16 scale and its kept count
FEATURIZERS = (("mmla_audio_torch.streaming.multiplex", "wavlm_input_batch"),
               ("mmla_audio_torch.inference", "wavlm_input_batch"))

# no fused block of the overlap model's
FUSED = ()
BLOCK_WINDOWS = 0

# rows of the reference's forward at a time (the conv encoder's first
# activations are 17 MB a row)
REF_ROWS = 32


def build(system):
    """``(cfg, predictor, silent_samples)`` of ``system``'s configuration,
    the bucket table first scaled to the source's N(0, 1) in ``system.sd``
    (``reference.wavlm.unit_table``)."""
    from mmla_audio_torch.core.config import PipelineConfig, WavLMConfig
    from mmla_audio_torch.inference import WavLMPredictor

    from perfbench.system import fields

    system.ref.unit_table(system.sd)
    cfg = PipelineConfig()
    precision = None if system.config["matmul_precision"] == "tf32" \
        else "highest"
    pred = WavLMPredictor(system.sd, fields(WavLMConfig, system.model),
                          device=system.device, matmul_precision=precision,
                          silent_threshold=cfg.vad.silent_samples)
    return cfg, pred, cfg.vad.silent_samples


def session(system, capture, dirs):
    from mmla_audio_torch.streaming.session import WavLMSession

    return WavLMSession(system.pred, capture, dirs, cfg=system.cfg)


def label_name(label: int) -> str:
    """The name the program's logs give a label."""
    from mmla_audio_torch.analyze.logs import OVERLAP_LABELS

    return "silent" if label < 0 else OVERLAP_LABELS[str(label)]


def featurizer_row(args, r: int):
    """What the tap keeps of row ``r`` of the normalisation's input: the
    trimmed window and its count, both left on the device (no wait)."""
    return (args[0][r].detach().clone(), args[1][r].detach().clone())


def program_trimmed(fin) -> tuple:
    """(the int16 samples, the kept count) of what the tap kept."""
    w, n = fin
    return torch.round(w.float()).to(torch.int32).numpy(), int(n)


def ref_inputs(system, trimmed, kept) -> torch.Tensor:
    """The reference's model input rows of trimmed int16 windows."""
    return system.ref.inputs(trimmed, kept, system.model["input_eps"],
                             system.device)


def ref_inputs_of_program(system, rows) -> torch.Tensor:
    """The reference's model input rows of the windows the program's
    normalisation was given."""
    x = torch.stack([w.float().cpu() for w, _ in rows])
    i16 = torch.round(x).clamp(-32768, 32767).to(torch.int16).numpy()
    kept = np.asarray([int(n) for _, n in rows])
    return ref_inputs(system, i16, kept)


def inputs_agree(xp, xr, limits) -> bool:
    """The same kept count, every sample within ``feature_rtol`` of the
    largest (float32 sums against float64)."""
    return bool(xp[-1] == xr[-1] and (xp[:-1] - xr[:-1]).abs().max()
                <= limits["feature_rtol"] * xr[:-1].abs().max())


def ref_logits(system, x: torch.Tensor, precision: str) -> torch.Tensor:
    """Reference logits of input rows ``x``, with TF32 off: ``fp32``;
    ``tf32``, each product's operands rounded to TF32 (the configuration's
    GEMMs, convolutions and kernel A1's dots); ``bf16``, the whole model in
    bfloat16."""
    m, sd = system.model, system.sd
    if precision == "bf16":
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    elif precision not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    rnd = tf32_round if precision == "tf32" else (lambda t: t)
    out = []
    for a in range(0, x.shape[0], REF_ROWS):
        rows = x[a: a + REF_ROWS]
        n = rows[:, -1].round().to(torch.int64).tolist()
        out.append(system.ref.forward(sd, rows[:, :-1].to(
            next(iter(sd.values())).dtype), n, m, rnd).float())
    return torch.cat(out)


def block_gaps(system, blocks: dict, precision=None) -> list:
    return []
