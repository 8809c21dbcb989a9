"""Window-to-label inference (counterpart of ``mmla_audio_tpu.inference``).

Overlap detection:

    (B, >=24000) int16-scale samples + (B,) valid counts
        -> masked prefix / 32768 -> featurize -> model -> softmax, argmax
        -> silent gate -> (labels (B,), probs (B, C))

The featurizer is ``overlap_model_input_cuda``: on the card it is the
hand-written kernel; for CPU tensors its plain version.

Speaker identification:

    (B, 40960) int16-scale samples + (B,) valid counts
        -> MFCC-39 (256, 39) -> SpeakerResBLSTM -> softmax (or sigmoid for a
        transfer-learned head), argmax of the logits -> silent gate

All of it is torch ops (cuBLAS GEMMs, cuDNN convolutions and LSTM on the
card), as the JAX package runs it outside any Pallas kernel.

Overlap detection with WavLM Large (the port's own; ``models/wavlm.py``):

    (B, 40960) int16-scale samples + (B,) valid counts
        -> ``wavlm_input_batch`` (kept samples normalised, the count beside
        them) -> WavLMForSequenceClassification (attention: kernel A1)
        -> softmax, argmax -> silent gate

``WavLMPredictor.frame_stats()`` counts the frames its forwards computed
and those of them that lay within a row's valid frames.

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

from mmla_audio_torch.core.config import (AudioConfig, OverlapFeatureConfig,
                                          OverlapModelConfig,
                                          SpeakerFeatureConfig,
                                          SpeakerModelConfig, WavLMConfig)
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

__all__ = ["SILENT", "OverlapPredictor", "SpeakerPredictor",
           "WavLMPredictor"]

SILENT = -1  # label index for the silent gate (the log writes "silent")

# the most keys (model, device, input shape, TF32 flags) whose CUDA graphs an
# OverlapPredictor keeps, least recently used out first: the multiplexer's
# two buckets on up to four mesh replicas
GRAPH_SHAPES = 8


def _masked_prefix(buf: torch.Tensor, n: torch.Tensor,
                   length: int) -> torch.Tensor:
    """First ``length`` samples of each row, zero beyond the valid count."""
    pre = buf[..., :length]
    idx = torch.arange(pre.shape[-1], device=buf.device)
    return torch.where(idx < n[..., None], pre, torch.zeros_like(pre))


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


class OverlapPredictor:
    """Overlap detection over (denoised, VAD-trimmed) windows.

    ``predict(buf, n)``: ``buf (B, >=24000)`` or ``(>=24000,)`` raw PCM,
    int16 or float32 at int16 scale, with valid counts ``n`` ->
    ``(labels, probs)`` on ``device``; label ``SILENT`` where
    ``n < silent_threshold``.
    """

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

    def _forward(self, model, buf: torch.Tensor, n: torch.Tensor):
        with span("model.features"):
            y = _masked_prefix(buf.to(torch.float32), n,
                               self.feat_cfg.n_samples) / 32768.0
            img = overlap_model_input_cuda(y, self.feat_cfg)  # (B, 128, 151, 3)
        with span("model.forward"):
            logits = self.apply_model(img, model)
        with span("model.labels"):
            probs = torch.softmax(logits, dim=-1)
            labels = torch.argmax(probs, dim=-1).to(torch.int32)
            labels = torch.where(n < self.silent_threshold,
                                 torch.full_like(labels, SILENT), labels)
        return labels, probs

    def lower_fn(self):
        """``fn(model, buf, n) -> (labels, probs)``: the batch forward of
        ``predict`` with the model passed in and ``buf (B, >=24000)``,
        ``n (B,)`` int32 already on the model's device, for wrappers that
        place both (``parallel.DataParallel(pred.lower_fn(), mesh)(
        pred.model, buf, n)``)."""
        return torch.no_grad()(self._forward)

    @torch.no_grad()
    def predict(self, buf, n):
        buf = _as_pcm(buf, self.device)
        n = torch.as_tensor(n).to(self.device, torch.int32)
        if buf.ndim == 1:
            labels, probs = self.predict(buf[None], n.reshape(1))
            return labels[0], probs[0]
        return self._forward(self.model, buf, n)


class SpeakerPredictor:
    """Speaker identification over (denoised, VAD-trimmed) windows.

    ``predict(buf, n)``: ``buf (B, 40960)`` or ``(40960,)`` raw PCM, int16
    or float32 at int16 scale, with valid counts ``n`` -> ``(labels,
    probs)`` on ``device``; label ``SILENT`` where ``n <
    feat_cfg.silent_samples``.  A label indexes the enrollment
    ``speaker_id_dict``.
    """

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

    def _score(self, model, buf: torch.Tensor, n: torch.Tensor):
        with span("model.features"):
            feats, _ = speaker_feature_batch(buf.to(torch.float32), n,
                                             self.feat_cfg)
        with span("model.forward"):
            logits = self.apply_model(feats, model)
        with span("model.labels"):
            probs = torch.sigmoid(logits) if self.sigmoid_head else \
                torch.softmax(logits, dim=-1)
        return logits, probs

    @torch.no_grad()
    def score(self, buf, n) -> tuple[torch.Tensor, torch.Tensor]:
        """``(logits, probs)`` of ``(B, max_samples)`` windows, no gate:
        a transfer-learned head's probabilities are sigmoids
        (`speaker_identification.py:409`), the base model's a softmax."""
        buf = _as_pcm(buf, self.device)
        n = torch.as_tensor(n).to(self.device, torch.int32)
        return self._score(self.model, buf, n)

    def _forward(self, model, buf: torch.Tensor, n: torch.Tensor):
        logits, probs = self._score(model, buf, n)
        with span("model.labels"):
            labels = torch.argmax(logits, dim=-1).to(torch.int32)
            labels = torch.where(n < self.feat_cfg.silent_samples,
                                 torch.full_like(labels, SILENT), labels)
        return labels, probs

    def lower_fn(self):
        """``fn(model, buf, n) -> (labels, probs)``: ``predict``'s batch
        forward with the model passed in, its inputs already on the
        model's device (see ``OverlapPredictor.lower_fn``)."""
        return torch.no_grad()(self._forward)

    @torch.no_grad()
    def predict(self, buf, n):
        buf = _as_pcm(buf, self.device)
        n = torch.as_tensor(n).to(self.device, torch.int32)
        if buf.ndim == 1:
            labels, probs = self.predict(buf[None], n.reshape(1))
            return labels[0], probs[0]
        return self._forward(self.model, buf, n)


class WavLMPredictor:
    """Overlap detection with WavLM Large over (denoised, VAD-trimmed)
    windows.

    ``predict(buf, n)``: ``buf (B, >=window)`` or ``(>=window,)`` raw PCM,
    int16 or float32 at int16 scale, with valid counts ``n`` ->
    ``(labels, probs)`` on ``device``; label ``SILENT`` where ``n <
    silent_threshold``.  A row's first 40,960 samples (the 2.56 s window
    at 16 kHz, ``AudioConfig().window_samples``) are the model's input.
    """

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
        self.model = WavLMForSequenceClassification(model_cfg)
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

    def _forward(self, buf: torch.Tensor, n: torch.Tensor):
        with span("model.features"):
            x = wavlm_input_batch(
                _masked_prefix(buf.to(torch.float32), n, self.window_samples),
                n, self.cfg.input_eps)
        with span("model.forward"):
            logits = self.apply_model(x)
        with span("model.labels"):
            probs = torch.softmax(logits, dim=-1)
            labels = torch.argmax(probs, dim=-1).to(torch.int32)
            labels = torch.where(n < self.silent_threshold,
                                 torch.full_like(labels, SILENT), labels)
        return labels, probs

    @torch.no_grad()
    def predict(self, buf, n):
        buf = _as_pcm(buf, self.device)
        n = torch.as_tensor(n).to(self.device, torch.int32)
        if buf.ndim == 1:
            labels, probs = self.predict(buf[None], n.reshape(1))
            return labels[0], probs[0]
        return self._forward(buf, n)
