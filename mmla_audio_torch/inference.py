"""Window-to-label inference (counterpart of ``mmla_audio_tpu.inference``).

Every predictor runs one decision step (``Predictor``) on trimmed windows,
``(B, L)`` int16-scale samples zero beyond their valid counts ``n``:

    the kind's featurizer -> ``apply_model`` -> argmax of the logits
        -> ``SILENT`` where ``n`` is below the gate

``predict`` casts raw PCM, masks it beyond ``n`` and gates at the
predictor's ``silent_threshold``; the multiplexer runs the step on its
trimmed batch at the gate ``serving_gate`` reads from a ``PipelineConfig``;
a session takes ``score``'s logits and probabilities and decides on the
host.  What differs by kind:

* ``OverlapPredictor`` (``"overlap"``): the first 1.5 s / 32768 ->
  ``overlap_model_input_cuda`` (128, 151, 3) (on the card the hand-written
  kernel; for CPU tensors its plain version) -> OverlapResBLSTM ->
  softmax.
* ``SpeakerPredictor`` (``"speaker"``): ``speaker_feature_batch`` MFCC-39
  (256, 39) -> SpeakerResBLSTM -> softmax, or sigmoid for a
  transfer-learned head; gated at ``cfg.speaker_feature.silent_samples``
  and logged by speaker index.  All of it is torch ops (cuBLAS GEMMs,
  cuDNN convolutions and LSTM on the card), as the JAX package runs it
  outside any Pallas kernel.
* ``WavLMPredictor`` (``"wavlm"``, the port's own; ``models/wavlm.py``): the
  first 40,960 samples -> ``wavlm_input_batch`` (kept samples normalised,
  the count beside them) -> WavLMForSequenceClassification (attention:
  kernel A1) -> softmax; labelled and logged as the overlap detector.
  ``frame_stats()`` counts the frames its forwards computed and those of
  them that lay within a row's valid frames.
* ``ConformerPredictor`` (``"conformer"``, the port's own;
  ``models/conformer.py``): ``WavLMPredictor``'s step and counter with
  wav2vec 2.0 Conformer Large (attention: kernel A2) in WavLM's place.

The step calls the featurizers through this module's names, so a patch of
``inference.<name>`` sees every call.

On the card ``OverlapPredictor.apply_model`` replays the overlap model's
stretches between its fused blocks (``OverlapResBLSTM.segments``) as CUDA
graphs, captured the second time a shape comes, and launches the six fused
blocks (B3) between them from Python; ``graph_stats()`` counts captures,
replays and eager forwards.

A predictor's construction is the set-up span ``setup.predictor``; a batch
spans ``model.features``, ``model.forward`` and ``model.labels``
(``utils.timers``).
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict
from typing import Mapping

import torch

from mmla_audio_torch.analyze.logs import OVERLAP_LABELS
from mmla_audio_torch.core.config import (AudioConfig, ConformerConfig,
                                          OverlapFeatureConfig,
                                          OverlapModelConfig, PipelineConfig,
                                          SpeakerFeatureConfig,
                                          SpeakerModelConfig, WavLMConfig)
from mmla_audio_torch.models.conformer import (
    Wav2Vec2ConformerForSequenceClassification)
from mmla_audio_torch.models.overlap import OverlapResBLSTM
from mmla_audio_torch.models.speaker import SpeakerResBLSTM
from mmla_audio_torch.models.wavlm import (WavLMForSequenceClassification,
                                           split_input, wavlm_input_batch)
from mmla_audio_torch.ops.cuda_features import (
    check_feature_config,
    overlap_model_input_cuda,
)
from mmla_audio_torch.ops.cuda_resblock import check_block_width
from mmla_audio_torch.ops.features import speaker_feature_batch
from mmla_audio_torch.precision import fp32_policy
from mmla_audio_torch.utils.timers import setup_span, span

__all__ = ["SILENT", "Predictor", "OverlapPredictor", "SpeakerPredictor",
           "WavLMPredictor", "ConformerPredictor"]

SILENT = -1  # label index for the silent gate (the log writes "silent")

# the most keys (model, device, input shape, TF32 flags) whose CUDA graphs an
# OverlapPredictor keeps, least recently used out first: the multiplexer's
# two buckets on up to four mesh replicas
GRAPH_SHAPES = 8


def _as_pcm(buf, device: torch.device) -> torch.Tensor:
    """int16 and float32 pass through (int16 moves at half the bytes and is
    cast on the device); anything else is cast to float32."""
    buf = torch.as_tensor(buf)
    if buf.dtype not in (torch.int16, torch.float32):
        buf = buf.to(torch.float32)
    return buf.to(device)


def _resolve_precision(matmul_precision, auto):
    """``"auto"`` -> the model's default ``auto``; then None or "highest"."""
    if matmul_precision == "auto":
        matmul_precision = auto
    if matmul_precision not in (None, "highest"):
        raise ValueError(f"matmul_precision must be 'auto', 'highest' or "
                         f"None: {matmul_precision!r}")
    return matmul_precision


def _apply(model, x, device, compute_dtype, matmul_precision, *more):
    """Model forward of ``x`` (and ``more``) under a predictor's numerics
    policy: bf16 autocast if ``compute_dtype``; TF32 only where
    ``matmul_precision`` is None; float32 out."""
    autocast = torch.autocast(device.type, dtype=compute_dtype) \
        if compute_dtype is not None else contextlib.nullcontext()
    with fp32_policy(matmul_precision is None), autocast:
        return model(x, *more).float()


def _run(layers, x):
    for layer in layers:
        x = layer(x)
    return x


class _StretchGraphs:
    """One input shape's CUDA graphs of a model's stretches
    (``OverlapResBLSTM.segments``), in one memory pool, each reading its
    static input buffer and writing its static output.  The graphs read the
    parameters where they were at capture: an in-place update
    (``load_state_dict``) shows at the next replay."""

    def __init__(self):
        self.inputs, self.graphs, self.outputs = [], [], []

    @classmethod
    def capture(cls, model, x: torch.Tensor):
        """``(graphs, logits)``: each stretch captured in turn, and the
        forward of ``x``.  A stretch is warmed up on a side stream (cuDNN
        plans, cuBLAS workspaces), captured there, then replayed on the
        current stream, and its fused blocks run on the replay's output, so
        the blocks launch once, as in a replay."""
        self = cls()
        pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        for name, stretch, blocks in model.segments():
            with span(name):
                buf = torch.empty_like(x)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    buf.copy_(x)
                    _run(stretch, buf)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool, stream=side,
                                          capture_error_mode="thread_local"):
                        out = _run(stretch, buf)
                main.wait_stream(side)
                graph.replay()
                x = _run(blocks, out)
            self.inputs.append(buf)
            self.graphs.append(graph)
            self.outputs.append(out)
        return self, x.clone()

    def replay(self, model, x: torch.Tensor) -> torch.Tensor:
        """The forward of ``x`` (this shape): copy in, replay, the fused
        blocks; logits the caller owns."""
        for (name, _, blocks), buf, graph, out in zip(
                model.segments(), self.inputs, self.graphs, self.outputs):
            with span(name):
                buf.copy_(x)
                graph.replay()
                x = _run(blocks, out)
        return x.clone()


class Predictor:
    """The decision step every predictor shares.  A subclass gives what
    differs by kind (``kind``, ``features``, ``apply_model``,
    ``probabilities``, ``log_kind``, ``label_names``, ``cfg_features``,
    ``serving_gate``) and sets ``device``, ``model`` and
    ``silent_threshold``.

    ``predict(buf, n)``: ``buf (B, L)`` or ``(L,)`` raw PCM, int16 or
    float32 at int16 scale, with valid counts ``n`` -> ``(labels, probs)``
    on ``device``; label ``SILENT`` where ``n < silent_threshold``."""

    kind = ""
    log_kind = "overlap"            # the SessionLog schema
    label_names = OVERLAP_LABELS    # a label's name when none is given
    # the ``PipelineConfig`` field that must equal ``feat_cfg`` where a
    # multiplexer serves this predictor under that config (None: none)
    cfg_features: str | None = None

    def features(self, samples: torch.Tensor, n: torch.Tensor):
        """The model input of trimmed rows (``step``)."""
        raise NotImplementedError

    def probabilities(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.softmax(logits, dim=-1)

    def serving_gate(self, cfg: PipelineConfig) -> int:
        """The kept-sample count below which a served window is SILENT."""
        return cfg.vad.silent_samples

    def label_name(self, label: int, names=None) -> str:
        """A label's log name: ``"silent"``, else its name in ``names`` (a
        stream's or an enrollment's) or in ``label_names``, else its
        index."""
        if label < 0:
            return "silent"
        names = self.label_names if names is None else names
        return names.get(str(label), str(label))

    def _logits(self, samples, n, model=None) -> torch.Tensor:
        with span("model.features"):
            x = self.features(samples, n)
        with span("model.forward"):
            return self.apply_model(x, model)

    def step(self, samples: torch.Tensor, n: torch.Tensor, gate: int,
             model=None):
        """The decision step of trimmed rows ``samples (B, L)`` float32 at
        int16 scale, zero beyond the counts ``n (B,)`` int32, on the model's
        device (``model``: a replica there, default this predictor's):
        ``(labels, logits)``, the labels ``(B,)`` int32 the argmax of the
        logits, ``SILENT`` where ``n < gate``."""
        logits = self._logits(samples, n, model)
        with span("model.labels"):
            labels = torch.argmax(logits, dim=-1).to(torch.int32)
            return torch.where(n < gate, torch.full_like(labels, SILENT),
                               labels), logits

    @torch.no_grad()
    def score(self, samples, n) -> tuple[torch.Tensor, torch.Tensor]:
        """``(logits, probs)`` of ``(B, L)`` rows zero beyond their valid
        counts ``n``, no gate (a session decides on the host)."""
        samples = _as_pcm(samples, self.device).to(torch.float32)
        n = torch.as_tensor(n).to(self.device, torch.int32)
        logits = self._logits(samples, n)
        with span("model.labels"):
            return logits, self.probabilities(logits)

    def _batch(self, model, buf: torch.Tensor, n: torch.Tensor):
        samples = buf.to(torch.float32)
        idx = torch.arange(samples.shape[-1], device=samples.device)
        samples = torch.where(idx < n[:, None], samples,
                              torch.zeros_like(samples))
        labels, logits = self.step(samples, n, self.silent_threshold, model)
        return labels, self.probabilities(logits)

    def lower_fn(self):
        """``fn(model, buf, n) -> (labels, probs)``: the batch forward of
        ``predict`` with the model passed in and ``buf (B, L)``, ``n (B,)``
        int32 already on the model's device, for wrappers that place both
        (``parallel.DataParallel(pred.lower_fn(), mesh)(pred.model, buf,
        n)``)."""
        return torch.no_grad()(self._batch)

    @torch.no_grad()
    def predict(self, buf, n):
        buf = _as_pcm(buf, self.device)
        n = torch.as_tensor(n).to(self.device, torch.int32)
        if buf.ndim == 1:
            labels, probs = self.predict(buf[None], n.reshape(1))
            return labels[0], probs[0]
        return self._batch(self.model, buf, n)


class OverlapPredictor(Predictor):
    """Overlap detection over (denoised, VAD-trimmed) windows: ``predict``'s
    ``buf`` is ``(B, >=24000)`` or ``(>=24000,)``."""

    kind = "overlap"
    cfg_features = "overlap_feature"

    @setup_span("setup.predictor")
    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 model_cfg: OverlapModelConfig = OverlapModelConfig(),
                 feat_cfg: OverlapFeatureConfig = OverlapFeatureConfig(),
                 device: torch.device | str = "cuda",
                 compute_dtype: torch.dtype | None = None,
                 matmul_precision: str | None = "auto",
                 silent_threshold: int = 4000):
        """``compute_dtype=torch.bfloat16`` runs the model under autocast
        (the featurizer stays fp32).  ``matmul_precision="highest"`` keeps
        the model's convolutions, LSTM and GEMMs in IEEE fp32 (TF32 off);
        ``None`` allows TF32; ``"auto"`` is the overlap model's fast
        default, ``None``, as in the JAX predictor.  ``silent_threshold``:
        post-VAD sample count below which the window is SILENT
        (`record_on_pc.py:142`); pass ``cfg.vad.silent_samples`` to mirror
        a tuned session gate."""
        matmul_precision = _resolve_precision(matmul_precision, None)
        self.device = torch.device(device)
        check_feature_config(feat_cfg, on_card=self.device.type == "cuda")
        if self.device.type == "cuda":
            for width in model_cfg.stage_filters:
                check_block_width(width)
        self.model = OverlapResBLSTM(model_cfg)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.feat_cfg = feat_cfg
        self.compute_dtype = compute_dtype
        self.matmul_precision = matmul_precision
        self.silent_threshold = silent_threshold
        self._graphs: OrderedDict = OrderedDict()   # key -> _StretchGraphs
        self._seen: OrderedDict = OrderedDict()     # keys met once
        self._counts = {"captures": 0, "replays": 0, "eager": 0}
        # one forward at a time through the graphs' shared buffers
        self._lock = threading.RLock()

    def apply_model(self, x: torch.Tensor, model=None) -> torch.Tensor:
        """Model forward (``model``: a replica on ``x``'s device, default
        this predictor's) under this predictor's numerics policy; float32
        logits, which the caller owns.

        The stretches between the fused blocks replay as CUDA graphs where
        ``x`` is a CUDA float32 tensor, ``compute_dtype`` is None, the model
        is in eval mode, autograd and autocast are off, no stream capture is
        under way, and this model met this shape on this device, under the
        same TF32 flags, before: the first time runs eagerly, the second
        captures.  The replay launches the very kernels of the eager
        forward, so the logits are the same bits.  Every other forward runs
        eagerly.  Threads take the graphs in turn; callers on different
        streams order their calls (a stream's ``wait_stream``), since the
        graphs' buffers are shared."""
        model = self.model if model is None else model
        if not (x.is_cuda and x.dtype == torch.float32
                and self.compute_dtype is None and not model.training
                and not torch.is_grad_enabled()
                and not torch.is_autocast_enabled(x.device.type)
                and not torch.cuda.is_current_stream_capturing()):
            return self._eager(model, x)
        with self._lock, fp32_policy(self.matmul_precision is None):
            key = (weakref.ref(model), x.device, tuple(x.shape),
                   torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
            graphs = self._graphs.get(key)
            if graphs is not None:
                self._graphs.move_to_end(key)
                self._counts["replays"] += 1
                return graphs.replay(model, x)
            if self._seen.pop(key, None) is None:
                self._seen[key] = True
                if len(self._seen) > GRAPH_SHAPES:
                    self._seen.popitem(last=False)
                return self._eager(model, x)
            if len(self._graphs) == GRAPH_SHAPES:
                old, _ = self._graphs.popitem(last=False)
                torch.cuda.synchronize(old[1])    # no replay of it in flight
            self._graphs[key], logits = _StretchGraphs.capture(model, x)
            self._counts["captures"] += 1
            self._counts["replays"] += 1
            return logits

    def _eager(self, model, x: torch.Tensor) -> torch.Tensor:
        with self._lock:
            self._counts["eager"] += 1
        return _apply(model, x, x.device, self.compute_dtype,
                      self.matmul_precision)

    def graph_stats(self) -> dict:
        """``captures`` (shapes whose graphs were captured), ``replays``
        (forwards through the graphs, a capture's own included) and
        ``eager`` (forwards without them) since construction."""
        with self._lock:
            return dict(self._counts)

    def features(self, samples, n):
        """The first 1.5 s / 32768 -> images ``(B, 128, 151, 3)``."""
        return overlap_model_input_cuda(
            samples[:, : self.feat_cfg.n_samples] / 32768.0, self.feat_cfg)


class SpeakerPredictor(Predictor):
    """Speaker identification over (denoised, VAD-trimmed) windows:
    ``predict``'s ``buf`` is ``(B, 40960)`` or ``(40960,)``, its gate
    ``feat_cfg.silent_samples``.  A label indexes the enrollment
    ``speaker_id_dict``."""

    kind = "speaker"
    log_kind = "speaker"
    label_names: Mapping[str, str] = {}
    cfg_features = "speaker_feature"

    @setup_span("setup.predictor")
    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 model_cfg: SpeakerModelConfig = SpeakerModelConfig(),
                 feat_cfg: SpeakerFeatureConfig = SpeakerFeatureConfig(),
                 head_units: int | None = None, sigmoid_head: bool = False,
                 device: torch.device | str = "cuda",
                 compute_dtype: torch.dtype | None = None,
                 matmul_precision: str | None = "auto"):
        """``head_units``: the head's width (None: ``num_speakers``, the
        base model); ``sigmoid_head``: a transfer-learned head's sigmoid
        probabilities instead of the softmax.  ``matmul_precision``:
        ``"auto"`` is ``"highest"`` for this model, as in the JAX
        predictor: the convolutions, LSTM and GEMMs in IEEE fp32 (TF32 off;
        cuDNN would take TF32 by default on the card); ``None`` allows
        TF32.  The MFCC is IEEE fp32 either way."""
        self.matmul_precision = _resolve_precision(matmul_precision,
                                                   "highest")
        self.device = torch.device(device)
        self.model = SpeakerResBLSTM(model_cfg, head_units,
                                     feat_dim=feat_cfg.feat_dim)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.feat_cfg = feat_cfg
        self.sigmoid_head = sigmoid_head
        self.compute_dtype = compute_dtype
        self.silent_threshold = feat_cfg.silent_samples

    def apply_model(self, x: torch.Tensor, model=None) -> torch.Tensor:
        """Model forward on MFCC-39 rows ``(B, 256, 39)`` (``model``: a
        replica on ``x``'s device, default this predictor's) under this
        predictor's numerics policy; float32 logits."""
        return _apply(self.model if model is None else model, x, x.device,
                      self.compute_dtype, self.matmul_precision)

    @torch.no_grad()
    def logits_from_features(self, feats) -> torch.Tensor:
        """Logits of precomputed ``(B, 256, 39)`` features (the post-time
        path featurizes whole conversations in one pass and slices)."""
        return self.apply_model(torch.as_tensor(feats).to(self.device,
                                                          torch.float32))

    def features(self, samples, n):
        """MFCC-39 rows ``(B, 256, 39)``."""
        return speaker_feature_batch(samples, n, self.feat_cfg)[0]

    def probabilities(self, logits):
        """A transfer-learned head's sigmoids
        (`speaker_identification.py:409`), the base model's softmax."""
        return torch.sigmoid(logits) if self.sigmoid_head else \
            torch.softmax(logits, dim=-1)

    def serving_gate(self, cfg: PipelineConfig) -> int:
        return cfg.speaker_feature.silent_samples


class WavLMPredictor(Predictor):
    """Overlap detection with WavLM Large over (denoised, VAD-trimmed)
    windows: ``predict``'s ``buf`` is ``(B, >=window)`` or ``(>=window,)``.
    A row's first 40,960 samples (the 2.56 s window at 16 kHz,
    ``AudioConfig().window_samples``) are the model's input."""

    kind = "wavlm"
    model_class = WavLMForSequenceClassification

    @setup_span("setup.predictor")
    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 model_cfg: WavLMConfig = WavLMConfig(),
                 device: torch.device | str = "cuda",
                 matmul_precision: str | None = "auto",
                 silent_threshold: int = 4000):
        """``matmul_precision``: ``None`` allows TF32 in the GEMMs, the
        convolutions and kernel A1's dots; ``"highest"`` keeps them IEEE
        fp32 (A1 in 3xTF32); ``"auto"`` is ``None``, as for the overlap
        model."""
        self.matmul_precision = _resolve_precision(matmul_precision, None)
        self.device = torch.device(device)
        self.model = self.model_class(model_cfg)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.cfg = model_cfg
        self.silent_threshold = silent_threshold
        self.window_samples = AudioConfig().window_samples
        self._lock = threading.Lock()
        self._frames = {"batches": 0, "computed": 0}
        self._valid = torch.zeros((), dtype=torch.int64, device=self.device)

    def apply_model(self, x: torch.Tensor, model=None) -> torch.Tensor:
        """Model forward of ``wavlm_input_batch``'s rows ``x (B, L + 1)``
        (``model``: a replica on ``x``'s device, default this predictor's)
        under this predictor's numerics policy; float32 logits.  Counts the
        frames computed and, on the device without a wait, those within the
        rows' valid frames."""
        model = self.model if model is None else model
        samples, n = split_input(x)
        T = int(model.frames(samples.shape[-1]))
        valid = model.frames(n).clamp(0, T).sum()
        with self._lock:
            self._frames["batches"] += 1
            self._frames["computed"] += samples.shape[0] * T
            self._valid += valid.to(self._valid.device)
        return _apply(model, samples, x.device, None, self.matmul_precision,
                      n)

    def frame_stats(self) -> dict:
        """``batches`` forwards, ``computed`` frames (rows x frames a row)
        and ``valid`` frames among them (within the rows' kept samples)
        since construction; reading ``valid`` waits for the card."""
        with self._lock:
            return dict(self._frames, valid=int(self._valid))

    def features(self, samples, n):
        """``wavlm_input_batch`` rows ``(B, 40961)`` of the windows."""
        return wavlm_input_batch(samples[:, : self.window_samples], n,
                                 self.cfg.input_eps)


class ConformerPredictor(WavLMPredictor):
    """Overlap detection with wav2vec 2.0 Conformer Large over (denoised,
    VAD-trimmed) windows: ``WavLMPredictor``'s input, step, gate, labels
    and frame counter, the Conformer in WavLM's place
    (``matmul_precision`` governs kernel A2's dots as it does A1's)."""

    kind = "conformer"
    model_class = Wav2Vec2ConformerForSequenceClassification

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 model_cfg: ConformerConfig = ConformerConfig(), **kw):
        super().__init__(state_dict, model_cfg, **kw)
