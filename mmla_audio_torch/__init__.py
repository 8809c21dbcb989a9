"""mmla_audio_torch — the PyTorch/CUDA port of ``mmla_audio_tpu`` for one
NVIDIA H100.

The module layout mirrors the JAX package, so each module's counterpart has
the same path.  The port imports ``torch`` and never JAX, Flax or any
module of the JAX package: it carries its own copies of the configuration
(``core.config``) and the experiment layout (``utils.experiment``), and
builds the webrtcvad engine from its own copies of the JAX package's C++
sources (``csrc/host``).  Hand-written Hopper kernels live under ``csrc/`` and
are built at first use into the git-ignored ``_build/``.

Ported so far: overlap detection, live and post-time — denoise, webrtc VAD
and hysteresis trim, the log-mel/ZCR featurizer and the fused residual
block (CUDA kernels on the card), ``OverlapResBLSTM``, ``OverlapPredictor``,
``OverlapSession``; speaker identification, live and post-time — MFCC-39,
``SpeakerResBLSTM``, ``SpeakerPredictor``, ``SpeakerSession``; speaker
training — registration (the two-phase transfer fine-tune) and the
base-model pretrain (``train/``); overlap-detector training — corpus
synthesis, the image dataset, pyramid rebalancing and ``OverlapTrainer``;
the accuracy sweep; and the CLI's ``setup``, ``overlap-live``/
``speaker-live --fake`` (``--register``), ``overlap-run``,
``overlap-post``, ``speaker-post``, ``speaker-pretrain``,
``synth-corpus``, ``overlap-train`` and ``charts``; data parallelism
(``parallel``: one process's cards for serving, ``torch.distributed`` for
training); stage timers and ``torch.profiler`` traces (``utils.timers``).
"""

from mmla_audio_torch.version import __version__

__all__ = ["__version__"]
