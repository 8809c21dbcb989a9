"""The configuration kind ``conformer``: the program's ``ConformerPredictor``
and ``WavLMSession`` built from a configuration (wav2vec 2.0 Conformer
Large as the overlap detector).  What the comparison needs of this kind is
the ``wavlm`` kind's (``kinds/wavlm.py``): the same label names, input
normalisation and tap, the reference's inputs and logits computed by
``reference/conformer.py`` in ``reference/wavlm.py``'s place."""

from __future__ import annotations

# the program's predictor, imported first: a program without the Conformer
# fails here, before any weight is made
from mmla_audio_torch.inference import ConformerPredictor

from perfbench.kinds.wavlm import (BLOCK_WINDOWS, FEATURIZERS, FUSED,  # noqa: F401
                                   block_gaps, featurizer_row, inputs_agree,
                                   label_name, program_trimmed, ref_inputs,
                                   ref_inputs_of_program, ref_logits,
                                   session)


def build(system):
    """``(cfg, predictor, silent_samples)`` of ``system``'s configuration."""
    from mmla_audio_torch.core.config import ConformerConfig, PipelineConfig

    from perfbench.system import fields

    cfg = PipelineConfig()
    precision = None if system.config["matmul_precision"] == "tf32" \
        else "highest"
    pred = ConformerPredictor(system.sd, fields(ConformerConfig,
                                                system.model),
                              device=system.device,
                              matmul_precision=precision,
                              silent_threshold=cfg.vad.silent_samples)
    return cfg, pred, cfg.vad.silent_samples
