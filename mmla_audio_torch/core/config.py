"""Typed configuration of the port's slice (counterpart of
``mmla_audio_tpu.core.config``).

The port runs where the JAX package cannot be imported, so it carries its own
copy of the configuration it uses.  Every class here has the same fields and
defaults as its JAX counterpart (pinned by ``tests/test_torch_inference.py``);
``PipelineConfig`` holds only the parts the overlap and speaker serving
paths, the two models' training and the device mesh read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["AudioConfig", "OverlapFeatureConfig", "SpeakerFeatureConfig",
           "VadConfig", "DenoiseConfig", "OverlapModelConfig",
           "SpeakerModelConfig", "OverlapTrainConfig", "SpeakerTrainConfig",
           "TransferConfig", "MeshConfig", "PipelineConfig", "DEFAULT"]


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Capture-side PCM geometry."""

    sample_rate: int = 16_000          # Hz
    sample_width: int = 2              # bytes (int16)
    channels: int = 1
    chunk_samples: int = 2_000         # one capture read = 0.125 s
    window_seconds: float = 2.56       # streaming decision window
    noise_profile_seconds: float = 10.0  # ambient-noise calibration clip
    enroll_seconds: float = 60.0       # per-speaker registration clip

    @property
    def window_samples(self) -> int:
        return int(self.window_seconds * self.sample_rate)


@dataclasses.dataclass(frozen=True)
class OverlapFeatureConfig:
    """ZCR-enhanced log-mel image: 1.5 s of 16 kHz audio -> 151 frames
    (25 ms window, 10 ms hop, centered) x 128 mels x 3 channels, PNG
    round-trip quantized, mel axis flipped."""

    sample_rate: int = 16_000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    n_mels: int = 128
    time_dim: int = 150                # hops covered -> time_dim+1 frames
    fmin: float = 0.0
    fmax: Optional[float] = None       # None -> sr/2
    png_quantize: bool = True          # reproduce uint8 PNG round-trip
    flip_mel_axis: bool = True         # reproduce origin="lower" row flip

    @property
    def win_length(self) -> int:
        return int(self.sample_rate * self.win_ms / 1000)   # 400

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.hop_ms / 1000)   # 160

    @property
    def n_samples(self) -> int:
        """Audio consumed per feature: hop * time_dim = 24 000 (1.5 s)."""
        return self.hop_length * self.time_dim

    @property
    def n_frames(self) -> int:
        """Centered STFT frames: 1 + n_samples // hop = 151."""
        return 1 + self.n_samples // self.hop_length

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.n_mels, self.n_frames, 3)               # (128, 151, 3)


@dataclasses.dataclass(frozen=True)
class SpeakerFeatureConfig:
    """MFCC-13 + delta + delta-delta over 256 frames, python_speech_features
    semantics: 25 ms / 10 ms frames, NFFT 512, 26 HTK mel filters, DCT-II
    ortho, ceplifter 22, log-energy in c0, preemphasis 0.97, rectangular
    window, on raw int16 sample values."""

    sample_rate: int = 16_000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    n_fft: int = 512
    n_filt: int = 26
    n_cep: int = 13
    ceplifter: int = 22
    preemph: float = 0.97
    append_energy: bool = True
    delta_n: int = 2
    max_frames: int = 256              # pad/truncate target (~2.56 s)
    silent_samples: int = 4_000        # < 0.25 s post-VAD -> 'silent'

    @property
    def win_length(self) -> int:
        return int(round(self.win_ms / 1000 * self.sample_rate))   # 400

    @property
    def hop_length(self) -> int:
        return int(round(self.hop_ms / 1000 * self.sample_rate))   # 160

    @property
    def feat_dim(self) -> int:
        return self.n_cep * 3                                       # 39

    @property
    def feature_shape(self) -> Tuple[int, int]:
        return (self.max_frames, self.feat_dim)                     # (256, 39)


@dataclasses.dataclass(frozen=True)
class VadConfig:
    """WebRTC-VAD gating geometry.  ``decision``: "webrtc" is the bit-exact
    webrtcvad engine (the reference's ``Vad(3)``), "energy" the calibrated
    log-energy detector.  The float GMM approximation (``vad/gmm.py``) is a
    probe, not a serving option: ``preprocess_window(gmm_state=)`` only."""

    frame_ms: int = 30                 # decision frame
    padding_ms: int = 300              # hysteresis ring buffer
    trigger_ratio: float = 0.9         # >90% voiced -> TRIGGERED
    aggressiveness: int = 3            # webrtcvad mode 0..3
    silent_samples: int = 4_000        # post-VAD silence gate (0.25 s)
    decision: str = "webrtc"

    def __post_init__(self):
        if self.decision not in ("energy", "webrtc"):
            extra = " ('gmm' was demoted to a benchmark probe in round 4; " \
                    "see vad/gmm.py)" if self.decision == "gmm" else ""
            raise ValueError(
                f"VadConfig.decision must be 'energy' or 'webrtc'"
                f"{extra}: {self.decision!r}")

    @property
    def ring_frames(self) -> int:
        return self.padding_ms // self.frame_ms                     # 10


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    """Stationary spectral gating (noisereduce semantics).  ``precision``:
    "highest" keeps the STFT/ISTFT/smoothing GEMMs in IEEE fp32 on the card;
    any other value allows TF32."""

    n_fft: int = 1024
    hop_length: int = 256
    n_std_thresh: float = 1.5
    prop_decrease: float = 1.0
    freq_mask_smooth_hz: float = 500.0
    time_mask_smooth_ms: float = 50.0
    passes_live: int = 1
    passes_post: int = 3
    passes_edge: int = 4
    precision: str = "highest"


@dataclasses.dataclass(frozen=True)
class OverlapModelConfig:
    """OverlapResBLSTM.  ``input_scale`` multiplies the 0..255 feature image
    at the model boundary (1.0 is the reference contract)."""

    input_scale: float = 1.0
    stem_filters: int = 16
    stage_filters: Tuple[int, ...] = (32, 64, 128)
    blocks_per_stage: int = 3
    lstm_units: int = 256
    dropout: float = 0.25
    num_classes: int = 2
    bn_momentum: float = 0.99          # Keras defaults
    bn_eps: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SpeakerModelConfig:
    """SpeakerResBLSTM.  ``stage_l2`` is the Keras l2 of the inner convs,
    a training-time penalty the serving path does not read."""

    stem_filters: int = 32
    stem_kernel: int = 4
    stage_filters: Tuple[int, ...] = (32, 64, 128)
    stage_l2: Tuple[float, ...] = (0.0, 0.1, 0.2)
    blocks_per_stage: int = 3
    lstm_units: int = 256
    dropout_trunk: float = 0.25
    dropout_head: float = 0.2
    avg_pool: int = 4
    num_speakers: int = 630            # TIMIT
    bn_momentum: float = 0.99
    bn_eps: float = 1e-3


@dataclasses.dataclass(frozen=True)
class OverlapTrainConfig:
    """Overlap-detector training: Adadelta 1e-3 under an epoch-indexed
    cosine annealing from 1e-2 to 1e-4, early stopping, weighted CCE;
    ``eval_batch_size`` bounds the rows of one evaluation chunk."""

    optimizer: str = "adadelta"
    lr: float = 1e-3
    cosine_t_max: int = 100
    cosine_eta_max: float = 1e-2
    cosine_eta_min: float = 1e-4
    early_stop_patience: int = 10
    epochs: int = 100
    batch_size: int = 32
    weighted_loss: bool = True
    eval_batch_size: int = 512


@dataclasses.dataclass(frozen=True)
class SpeakerTrainConfig:
    """Base-model pretrain: RMSprop 1e-4, batch 32, early stopping on the
    validation loss."""

    lr: float = 1e-4
    batch_size: int = 32
    epochs: int = 200
    early_stop_patience: int = 10


@dataclasses.dataclass(frozen=True)
class TransferConfig:
    """Two-phase registration fine-tune: the head alone on the frozen trunk,
    then everything; retrained until the validation accuracy reaches the
    gate."""

    phase1_epochs: int = 500
    phase1_batch: int = 16
    phase1_lr: float = 1e-4
    phase2_epochs: int = 20
    phase2_batch: int = 8
    phase2_lr: float = 1e-6
    accuracy_gate: float = 0.80
    max_retrain_rounds: int = 5


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (``parallel.make_mesh``).  Windows are
    independent, so the ``data`` axis is pure data parallelism; ``model``
    stays 1 (the port has no tensor parallelism)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1            # -1 -> all devices
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """What an overlap or speaker session, the training of either model,
    and a mesh need."""

    audio: AudioConfig = AudioConfig()
    overlap_feature: OverlapFeatureConfig = OverlapFeatureConfig()
    speaker_feature: SpeakerFeatureConfig = SpeakerFeatureConfig()
    vad: VadConfig = VadConfig()
    denoise: DenoiseConfig = DenoiseConfig()
    overlap_model: OverlapModelConfig = OverlapModelConfig()
    speaker_model: SpeakerModelConfig = SpeakerModelConfig()
    overlap_train: OverlapTrainConfig = OverlapTrainConfig()
    speaker_train: SpeakerTrainConfig = SpeakerTrainConfig()
    transfer: TransferConfig = TransferConfig()
    mesh: MeshConfig = MeshConfig()


DEFAULT = PipelineConfig()
