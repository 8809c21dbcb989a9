"""mmla_audio_torch — the PyTorch/CUDA port of ``mmla_audio_tpu`` for one
NVIDIA H100.

The module layout mirrors the JAX package, so each module's counterpart has
the same path.  The port imports ``torch`` and never JAX, Flax or any
module of the JAX package: it carries its own copies of the configuration
(``core.config``) and the experiment layout (``utils.experiment``), and
builds the webrtcvad engine from its own copies of the JAX package's C++
sources (``csrc/host``).  Hand-written Hopper kernels live under ``csrc/`` and
are built at first use into the git-ignored ``_build/``.

Ported so far: the overlap-detection main path — denoise, webrtc VAD and
hysteresis trim, the log-mel/ZCR featurizer (CUDA kernel on the card),
``OverlapResBLSTM``, ``OverlapPredictor``, ``OverlapSession`` and the CLI's
``setup``, ``overlap-live --fake`` and ``overlap-run``.
"""
