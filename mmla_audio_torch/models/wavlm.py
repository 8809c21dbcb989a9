"""WavLM Large as an overlap detector: ``WavLMForSequenceClassification``
(Hugging Face ``transformers``' ``modeling_wavlm.py``) over a window's raw
samples, two labels.  The port's own model: the JAX package has none.

Sources: Chen et al., "WavLM: Large-Scale Self-Supervised Pre-Training for
Full Stack Speech Processing" (arXiv:2110.13900), the ``config.json`` of
``microsoft/wavlm-large``, and the layer equations of ``modeling_wavlm.py``.
Sizes are ``core.config.WavLMConfig``'s.

* Input: each window's kept samples / 32768, normalised to zero mean and
  unit variance over the kept samples (``input_eps`` under the root), zero
  beyond them (``wavlm_input_batch``).
* Feature encoder: 7 x (Conv1d without bias, LayerNorm over channels,
  exact GELU); 40,960 samples -> 127 frames of 512.  Channels-last
  throughout, ``(B, T, C)``: each layer is one call of
  ``ops.cuda_conv_encoder.wavlm_conv``, kernel E1 on the card (one launch
  a layer: layer 0 a stencil from the samples, layers 1-6 an implicit GEMM
  with the LayerNorm and GELU in its epilogue, on the weights repacked once
  a device, ``WavLMConvLayer.packed``, outside the state dict), its plain
  version (``F.conv1d``, ``F.layer_norm``, ``F.gelu``) on the CPU.  A
  row's valid frames are the conv length formula ``floor((L - k) / s) + 1``
  a layer over its kept count (``frames``).
* Feature projection: LayerNorm(512) -> Linear(512 -> 1024), on E1's
  channels-last output as it is.
* Frames past a row's valid ones are zeroed; then the positional
  convolution, Conv1d(1024, 1024, k=128, pad 64, 16 groups), weight-normed
  over dim 2 (``weight_g``, ``weight_v``), its last frame dropped, GELU,
  added to its input.
* 24 pre-LN layers (``do_stable_layer_norm``): ``h += attn(LN(h))``, ``h +=
  FFN(LN(h))`` (4096, exact GELU).  Attention: 16 heads of 64, scores
  ``q.k / 8 + g[b, h, i] * E[h, bucket(j - i)]`` over the valid keys, where
  ``E`` is layer 0's ``rel_attn_embed`` (bidirectional buckets over
  ``max_bucket_distance``: exact below 80, logarithmic above) and every
  layer gates it by its own ``g = a (b c_h - 1) + 2``, ``(a, b) =
  sigmoid(gru_rel_pos_linear(x_h).view(.., 2, 4).sum(-1))`` of the
  attention's input ``x`` split per head, ``c_h`` its ``gru_rel_pos_const``.
  The attention is kernel A1 (``ops/cuda_attention.py``), one launch a
  layer, called through this module's name ``wavlm_attention``.
* Final LayerNorm; head (``use_weighted_layer_sum``): a softmax over
  ``layer_weights`` weighs the 24 layers' inputs and the normed output ->
  ``projector`` (1024 -> 256) -> mean over valid frames -> ``classifier``
  (256 -> 2).

Parameter names are Hugging Face's under ``WavLMForSequenceClassification``
with the ``wavlm.`` prefix dropped
(``feature_extractor.conv_layers.{i}.conv``,
``encoder.layers.{i}.attention.{q,k,v,out}_proj``, ``gru_rel_pos_linear``,
``gru_rel_pos_const``, ``rel_attn_embed``,
``encoder.pos_conv_embed.conv.weight_g`` / ``weight_v``, ``layer_weights``,
``projector``, ``classifier``, ...), so that a checkpoint loads by name once
its files are in the repository.

Departures from ``modeling_wavlm.py``, all for serving: inference only (no
dropout, no time masking, so no ``masked_spec_embed``); a row with no whole
frame (fewer than 400 kept samples) keeps its first frame as a key and in
the mean, and a row with no kept sample normalises to zeros, where Hugging
Face would put NaN into the row (such rows lie under the silent gate); the
weighted layer sum is accumulated layer by layer instead of over a stack
of the 25 hidden states (the same sum, in another order).

GEMMs are ``F.linear``, the positional convolution ``F.conv1d``, under the
caller's TF32 policy (``precision.fp32_policy``), which E1 and A1 follow
too (one TF32 pass where it allows TF32, else 3xTF32).  A forward spans
``model.encoder`` (conv encoder, projection, positional convolution),
``model.layers`` with a ``model.layer`` a layer, and ``model.head``
(``utils.timers``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mmla_audio_torch.core.config import WavLMConfig
from mmla_audio_torch.ops.cuda_attention import wavlm_attention
from mmla_audio_torch.ops.cuda_conv_encoder import (pack_conv_weight,
                                                    wavlm_conv)
from mmla_audio_torch.utils.timers import span

__all__ = ["relative_position_bucket", "wavlm_input_batch", "split_input",
           "RawWaveformClassifier", "WavLMForSequenceClassification"]


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 320,
                             max_distance: int = 800) -> torch.Tensor:
    """The bucket of each relative position ``j - i`` (``WavLMAttention.
    _relative_positions_bucket``): half the buckets a side, exact below a
    quarter of them, logarithmic up to ``max_distance``, the last beyond."""
    half = num_buckets // 2
    buckets = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    exact = half // 2
    large = torch.log(rel.float() / exact) / math.log(max_distance / exact)
    large = (exact + large * (half - exact)).to(torch.long)
    large = torch.minimum(large, torch.full_like(large, half - 1))
    return buckets + torch.where(rel < exact, rel, large)


def wavlm_input_batch(trimmed: torch.Tensor, n: torch.Tensor,
                      eps: float = 1e-7) -> torch.Tensor:
    """The model's input of trimmed windows ``(B, L)`` at int16 scale and
    their kept counts ``n (B,)``: ``(B, L + 1)`` float32, each row the kept
    samples / 32768 normalised to zero mean and unit variance over the kept
    samples (``(x - mean) / sqrt(var + eps)``), zeros beyond them, then the
    kept count (exact in float32).  A row keeps its count beside its samples
    so that one tensor carries a batch (``split_input``)."""
    x = trimmed.to(torch.float32) / 32768.0
    L = x.shape[-1]
    n = n.to(x.device)
    kept = torch.arange(L, device=x.device)[None, :] < n[:, None]
    count = n.clamp(1, L).to(torch.float32)[:, None]
    x = torch.where(kept, x, torch.zeros_like(x))
    mean = x.sum(-1, keepdim=True) / count
    d = torch.where(kept, x - mean, torch.zeros_like(x))
    var = (d * d).sum(-1, keepdim=True) / count
    return torch.cat([d / torch.sqrt(var + eps),
                      n.to(torch.float32)[:, None]], dim=1)


def split_input(x: torch.Tensor) -> tuple:
    """``(samples (B, L), kept counts (B,) int32)`` of ``wavlm_input_batch``'s
    rows."""
    return x[:, :-1], x[:, -1].round().to(torch.int32)


class WavLMConvLayer(nn.Module):
    """``WavLMLayerNormConvLayer``: conv, LayerNorm over channels, GELU, on
    channels-last ``(B, T, C)`` in and out (``wavlm_conv``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 bias: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride, bias=bias)
        self.layer_norm = nn.LayerNorm(cout)
        self._packed = None                 # (key, the kernel's weight)

    def packed(self) -> torch.Tensor:
        """The conv weight in E1's layout (``pack_conv_weight``), made once
        for each device, storage and version of the weight."""
        w = self.conv.weight
        key = (w.device, w.data_ptr(), w._version)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_conv_weight(w))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return wavlm_conv(x, self.conv.weight, self.layer_norm.weight,
                          self.layer_norm.bias, self.conv.stride[0],
                          self.layer_norm.eps, self.conv.bias,
                          packed=self.packed() if x.is_cuda else None)


class WavLMFeatureEncoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            WavLMConvLayer(dims[i], dims[i + 1], k, s, cfg.conv_bias)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Samples ``(B, L)`` -> ``(B, T, C)``, channels-last."""
        x = x[..., None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class WavLMFeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class WeightNormConv1d(nn.Module):
    """A grouped Conv1d weight-normed over dim 2 (``torch.nn.utils.
    weight_norm(conv, dim=2)``): ``weight = weight_g * weight_v /
    ||weight_v||``, the norm over the other two dims a tap."""

    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(
            torch.empty(channels, channels // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(channels))
        nn.init.normal_(self.weight_v, std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        w = self.weight_g * v / torch.linalg.vector_norm(v, dim=(0, 1),
                                                         keepdim=True)
        return F.conv1d(x, w, self.bias, padding=v.shape[-1] // 2,
                        groups=self.groups)


class WavLMPositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.conv = WeightNormConv1d(cfg.hidden_size,
                                     cfg.num_conv_pos_embeddings,
                                     cfg.num_conv_pos_embedding_groups)
        self.drop_last = cfg.num_conv_pos_embeddings % 2 == 0

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = self.conv(h.transpose(1, 2))
        if self.drop_last:
            x = x[..., :-1]
        return F.gelu(x).transpose(1, 2)


class WavLMAttention(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        D, H = cfg.hidden_size, cfg.num_attention_heads
        self.num_heads, self.head_dim = H, D // H
        self.num_buckets = cfg.num_buckets
        self.max_distance = cfg.max_bucket_distance
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8)
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, H)

    def position_bias(self, T: int, device) -> torch.Tensor:
        """Layer 0's ungated bias table ``(H, 2T - 1)``: ``E[h, bucket(r)]``
        for ``r = -(T - 1) .. T - 1``."""
        rel = torch.arange(-(T - 1), T, device=device)
        buckets = relative_position_bucket(rel, self.num_buckets,
                                           self.max_distance)
        return self.rel_attn_embed(buckets).t().contiguous()

    def gate(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, T)``: ``a (b c_h - 1) + 2`` of the input split per head."""
        B, T, _ = x.shape
        proj = self.gru_rel_pos_linear(x.view(B, T, self.num_heads, -1))
        a, b = torch.sigmoid(proj.view(B, T, self.num_heads, 2, 4)
                             .sum(-1)).unbind(-1)
        c = self.gru_rel_pos_const.view(self.num_heads)
        return (a * (b * c - 1.0) + 2.0).transpose(1, 2)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape

        def heads(t):
            return t.view(B, T, self.num_heads, self.head_dim).transpose(1, 2)

        out = wavlm_attention(heads(self.q_proj(x)), heads(self.k_proj(x)),
                              heads(self.v_proj(x)), self.gate(x), bias, lens)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class WavLMFeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class WavLMEncoderLayer(nn.Module):
    """``WavLMEncoderLayerStableLayerNorm``: pre-LN attention and FFN."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool):
        super().__init__()
        self.attention = WavLMAttention(cfg, has_relative_position_bias)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.feed_forward = WavLMFeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, h, bias, lens):
        h = h + self.attention(self.layer_norm(h), bias, lens)
        return h + self.feed_forward(self.final_layer_norm(h))


class WavLMEncoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = WavLMPositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(WavLMEncoderLayer(cfg, i == 0)
                                    for i in range(cfg.num_hidden_layers))


class RawWaveformClassifier(nn.Module):
    """What the raw-waveform sequence classifiers (WavLM's here, the
    Conformer's in ``models/conformer.py``) share: the conv encoder (kernel
    E1), the feature projection, padded frames zeroed, the encoder's layers
    under the spans, and the weighted-layer-sum head.  A subclass passes its
    ``encoder`` (``layers`` and a final ``layer_norm``) and gives
    ``prepare(h, lens)``: the hidden states the first layer takes, and the
    arguments each layer takes after them, one tuple a layer.

    ``forward(x, n)``: logits ``(B, num_labels)`` of normalised samples
    ``x (B, L)`` (``wavlm_input_batch``'s rows without their count) and the
    kept counts ``n (B,)``."""

    def __init__(self, cfg, encoder: nn.Module):
        super().__init__()
        if not cfg.use_weighted_layer_sum:
            raise ValueError(f"{type(self).__name__}: the port builds the "
                             f"weighted layer sum's head only")
        self.cfg = cfg
        self.feature_extractor = WavLMFeatureEncoder(cfg)
        self.feature_projection = WavLMFeatureProjection(cfg)
        self.encoder = encoder
        n = cfg.num_hidden_layers + 1
        self.layer_weights = nn.Parameter(torch.ones(n) / n)
        self.projector = nn.Linear(cfg.hidden_size, cfg.classifier_proj_size)
        self.classifier = nn.Linear(cfg.classifier_proj_size, cfg.num_labels)

    def frames(self, n):
        """Whole frames of the conv encoder over ``n`` samples (an int or an
        integer tensor; negative where there is none)."""
        for k, s in zip(self.cfg.conv_kernel, self.cfg.conv_stride):
            n = (n - k) // s + 1
        return n

    def prepare(self, h: torch.Tensor, lens: torch.Tensor) -> tuple:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        with span("model.encoder"):
            h = self.feature_projection(self.feature_extractor(x))
            B, T, _ = h.shape
            lens = self.frames(n.to(h.device)).clamp(1, T).to(torch.int32)
            valid = torch.arange(T, device=h.device)[None, :] < lens[:, None]
            h, args = self.prepare(h * valid[..., None], lens)
            w = torch.softmax(self.layer_weights, dim=0)
            acc = h * w[0]
        with span("model.layers"):
            for i, layer in enumerate(self.encoder.layers):
                with span("model.layer"):
                    h = layer(h, *args[i])
                    if i + 1 < len(self.encoder.layers):
                        acc = acc + h * w[i + 1]
        with span("model.head"):
            h = self.encoder.layer_norm(h)
            acc = acc + h * w[-1]
            p = self.projector(acc) * valid[..., None]
            pooled = p.sum(1) / lens[:, None].to(p.dtype)
            return self.classifier(pooled)


class WavLMForSequenceClassification(RawWaveformClassifier):
    """``forward(x, n)``: logits ``(B, num_labels)`` of normalised samples
    ``x (B, L)`` (``wavlm_input_batch``'s rows without their count) and the
    kept counts ``n (B,)``."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig()):
        super().__init__(cfg, WavLMEncoder(cfg))

    def prepare(self, h, lens):
        """The positional convolution added; every layer takes layer 0's
        bias table and the key lengths."""
        h = h + self.encoder.pos_conv_embed(h)
        bias = self.encoder.layers[0].attention.position_bias(h.shape[1],
                                                              h.device)
        return h, [(bias, lens)] * len(self.encoder.layers)
