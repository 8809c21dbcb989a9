"""wav2vec 2.0 Conformer Large (relative positions) as an overlap detector:
``Wav2Vec2ConformerForSequenceClassification`` (Hugging Face
``transformers``' ``modeling_wav2vec2_conformer.py``) over a window's raw
samples, two labels.  The port's own model: the JAX package has none.

Sources: Gulati et al., "Conformer" (arXiv:2005.08100); the relative
attention of Transformer-XL (Dai et al., arXiv:1901.02860); fairseq S2T
(arXiv:2010.05171); ``facebook/wav2vec2-conformer-rel-pos-large``; the
layer equations of ``modeling_wav2vec2_conformer.py``.  Sizes are
``core.config.ConformerConfig``'s.

* Input, conv encoder (kernel E1, with the convolutions' biases),
  feature projection, padded frames zeroed and the weighted-layer-sum head
  are WavLM's (``models/wavlm.py``: ``wavlm_input_batch``,
  ``RawWaveformClassifier``), shared, not copied.
* Positions: the sinusoids of relative positions ``T - 1 .. -(T - 1)``
  (``relative_positions``, ``Wav2Vec2ConformerRelPositionalEmbedding``'s
  centre ``2T - 1`` rows); each layer's ``linear_pos`` of them, split per
  head, is its table ``p (H, 2T - 1, 64)``.  The tables depend on the
  weights and ``T`` alone: all 24 are made at once for each device, ``T``,
  TF32 policy and version of the weights (``position_tables``,
  ``table_builds`` counts the builds), outside the state dict.
* 24 macaron Conformer layers, each:
  ``h += FFN1(LN(h)) / 2``; ``h += MHSA(LN(h))``; ``h += Conv(h)``;
  ``h += FFN2(LN(h)) / 2``; ``h = LN(h)``.  FFNs 1024 -> 4096 -> 1024 with
  swish (SiLU).  MHSA: 16 heads of 64, scores ``((q_i + u_h) . k_j + (q_i +
  v_h) . p_h[j - i + T - 1]) / 8`` over the valid keys (``pos_bias_u``,
  ``pos_bias_v``): kernel A2 (``ops/cuda_conformer_attention.py``), one
  launch a layer, called through this module's name
  ``conformer_attention``.  Conv module: LN -> pointwise 1024 -> 2048
  (``F.linear``) -> GLU -> depthwise conv k = 31 -> BatchNorm on its
  running statistics -> swish -> pointwise 1024 -> 1024, channels-last
  throughout; GLU to swish as kernel C1 (``ops/cuda_conformer_conv.py``),
  one launch a layer, called through this module's name
  ``conformer_conv``, on the depthwise taps with the BatchNorm folded in,
  made once a device and version of the weights and statistics
  (``ConformerConvolutionModule.folded``, ``fold_builds`` counts the
  builds), outside the state dict.
* A final LayerNorm after the layers, none before them.

Parameter names are Hugging Face's under
``Wav2Vec2ConformerForSequenceClassification`` with the
``wav2vec2_conformer.`` prefix dropped
(``encoder.layers.{i}.ffn1.intermediate_dense``, ``self_attn.linear_pos``,
``self_attn.pos_bias_u``, ``conv_module.depthwise_conv``,
``conv_module.batch_norm.running_var``, ``layer_weights``, ...), so that a
checkpoint loads by name once its files are in the repository.
Hugging Face's encoder builds a positional convolution
(``encoder.pos_conv_embed``) that its ``forward`` never applies: the port
computes none, and ``load_state_dict`` accepts and drops those keys.

Departures from ``modeling_wav2vec2_conformer.py``, all for serving:
inference only (no dropout, no time masking, so no ``masked_spec_embed``;
the position tables and C1's folded taps are made without autograd; the
BatchNorm on its running statistics alone); WavLM's for rows with no whole
frame and the weighted layer sum's order (``models/wavlm.py``).  As in
Hugging Face, padded frames are zeroed before the first layer and masked
as keys, and are not zeroed again between layers, so the depthwise
convolution sees what the layers left there.

GEMMs are ``F.linear`` under the caller's TF32 policy
(``precision.fp32_policy``), which E1 and A2 follow too (one TF32 pass
where it allows TF32, else 3xTF32); C1 computes in fp32 under either.  A
forward spans ``model.encoder``, ``model.layers`` with a ``model.layer`` a
layer (inside it ``model.attention`` and ``model.conv_module``) and
``model.head`` (``utils.timers``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mmla_audio_torch.core.config import ConformerConfig
from mmla_audio_torch.models.wavlm import RawWaveformClassifier
from mmla_audio_torch.ops.cuda_conformer_attention import conformer_attention
from mmla_audio_torch.ops.cuda_conformer_conv import (conformer_conv,
                                                      fold_batch_norm)
from mmla_audio_torch.utils.timers import span

__all__ = ["relative_positions", "Wav2Vec2ConformerForSequenceClassification"]

# keys of Hugging Face's unused positional convolution, dropped on loading
UNUSED = "encoder.pos_conv_embed."


def relative_positions(T: int, d_model: int) -> torch.Tensor:
    """``(2T - 1, d_model)`` float32 on the CPU: row ``m`` the sinusoid of
    relative position ``T - 1 - m`` (sines at even channels, cosines at
    odd), computed as ``Wav2Vec2ConformerRelPositionalEmbedding`` computes
    its rows."""
    position = torch.arange(0, T, dtype=torch.int64).float().unsqueeze(1)
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.int64)
                         .float() * -(math.log(10000.0) / d_model))
    pos = torch.zeros(T, d_model)
    neg = torch.zeros(T, d_model)
    pos[:, 0::2] = torch.sin(position * div_term)
    pos[:, 1::2] = torch.cos(position * div_term)
    neg[:, 0::2] = torch.sin(-1 * position * div_term)
    neg[:, 1::2] = torch.cos(-1 * position * div_term)
    return torch.cat([torch.flip(pos, [0]), neg[1:]])


class ConformerFeedForward(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.silu(self.intermediate_dense(x)))


class ConformerSelfAttention(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        D, H = cfg.hidden_size, cfg.num_attention_heads
        self.num_heads, self.head_dim = H, D // H
        self.linear_q = nn.Linear(D, D)
        self.linear_k = nn.Linear(D, D)
        self.linear_v = nn.Linear(D, D)
        self.linear_out = nn.Linear(D, D)
        self.linear_pos = nn.Linear(D, D, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(H, self.head_dim))
        self.pos_bias_v = nn.Parameter(torch.zeros(H, self.head_dim))

    def table(self, pe: torch.Tensor) -> torch.Tensor:
        """``(H, 2T - 1, d)`` contiguous: ``linear_pos`` of the sinusoids
        ``pe (2T - 1, D)`` split per head."""
        p = self.linear_pos(pe).view(pe.shape[0], self.num_heads, -1)
        return p.transpose(0, 1).contiguous()

    def forward(self, x: torch.Tensor, p: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape

        def heads(t):
            return t.view(B, T, self.num_heads, self.head_dim).transpose(1, 2)

        out = conformer_attention(heads(self.linear_q(x)),
                                  heads(self.linear_k(x)),
                                  heads(self.linear_v(x)), self.pos_bias_u,
                                  self.pos_bias_v, p, lens)
        return self.linear_out(out.transpose(1, 2).reshape(B, T, D))


class ConformerConvolutionModule(nn.Module):
    """``Wav2Vec2ConformerConvolutionModule`` on channels-last ``(B, T, C)``
    in and out: the pointwise convolutions as ``F.linear``; GLU, the
    depthwise convolution, eval BatchNorm and swish between them as kernel
    C1 (``conformer_conv``) on the depthwise weights with the BatchNorm
    folded in (``folded``)."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        D, K = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        if K % 2 == 0:
            raise ValueError(f"conv_depthwise_kernel_size must be odd for "
                             f"'same' padding, got {K}")
        self.layer_norm = nn.LayerNorm(D)
        self.pointwise_conv1 = nn.Conv1d(D, 2 * D, 1, bias=False)
        self.depthwise_conv = nn.Conv1d(D, D, K, padding=(K - 1) // 2,
                                        groups=D, bias=False)
        self.batch_norm = nn.BatchNorm1d(D)
        self.pointwise_conv2 = nn.Conv1d(D, D, 1, bias=False)
        self._folded = None                 # (key, (taps, bias))
        self.fold_builds = 0

    def folded(self) -> tuple:
        """C1's ``(taps (K, C), bias (C,))``: the depthwise weights with the
        BatchNorm folded in (``fold_batch_norm``), made once for each
        device, ``eps`` and storage and version of the five tensors.  Eval
        BatchNorm is the map ``x scale + shift`` a channel: its values at 0
        and 1 (``F.batch_norm`` in float64) give both."""
        bn = self.batch_norm
        ts = (self.depthwise_conv.weight, bn.weight, bn.bias,
              bn.running_mean, bn.running_var)
        key = (ts[0].device, bn.eps,
               tuple((t.data_ptr(), t._version) for t in ts))
        if self._folded is None or self._folded[0] != key:
            with torch.no_grad():
                unit = torch.tensor([[0.0], [1.0]], dtype=torch.float64,
                                    device=ts[0].device)
                at = F.batch_norm(unit.expand(2, ts[0].shape[0]),
                                  bn.running_mean.double(),
                                  bn.running_var.double(), bn.weight.double(),
                                  bn.bias.double(), False, 0.0, bn.eps)
            self._folded = (key, fold_batch_norm(ts[0], at[1] - at[0], at[0]))
            self.fold_builds += 1
        return self._folded[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(self.layer_norm(x), self.pointwise_conv1.weight[..., 0])
        return F.linear(conformer_conv(y, *self.folded()),
                        self.pointwise_conv2.weight[..., 0])


class ConformerEncoderLayer(nn.Module):
    """``Wav2Vec2ConformerEncoderLayer``: the macaron layer."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        D = cfg.hidden_size
        self.ffn1_layer_norm = nn.LayerNorm(D)
        self.ffn1 = ConformerFeedForward(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(D)
        self.self_attn = ConformerSelfAttention(cfg)
        self.conv_module = ConformerConvolutionModule(cfg)
        self.ffn2_layer_norm = nn.LayerNorm(D)
        self.ffn2 = ConformerFeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(D)

    def forward(self, h, p, lens):
        h = h + 0.5 * self.ffn1(self.ffn1_layer_norm(h))
        with span("model.attention"):
            h = h + self.self_attn(self.self_attn_layer_norm(h), p, lens)
        with span("model.conv_module"):
            h = h + self.conv_module(h)
        h = h + 0.5 * self.ffn2(self.ffn2_layer_norm(h))
        return self.final_layer_norm(h)


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(ConformerEncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))


def _drop_unused(state_dict, prefix, *args):
    for key in [k for k in state_dict if k.startswith(prefix + UNUSED)]:
        del state_dict[key]


class Wav2Vec2ConformerForSequenceClassification(RawWaveformClassifier):
    """``forward(x, n)``: logits ``(B, num_labels)`` of normalised samples
    ``x (B, L)`` (``wavlm_input_batch``'s rows without their count) and the
    kept counts ``n (B,)``."""

    def __init__(self, cfg: ConformerConfig = ConformerConfig()):
        if cfg.position_embeddings_type != "relative" or \
                cfg.feat_extract_norm != "layer" or \
                cfg.hidden_act not in ("swish", "silu"):
            raise ValueError("Wav2Vec2ConformerForSequenceClassification: the "
                             "port builds relative positions, the "
                             "layer-normed conv encoder and swish only")
        super().__init__(cfg, ConformerEncoder(cfg))
        self._tables = None            # (key, [each layer's table])
        self.table_builds = 0
        self._register_load_state_dict_pre_hook(_drop_unused)

    def position_tables(self, T: int, device) -> list:
        """Each layer's table ``(H, 2T - 1, d)`` on ``device``, made once for
        each device, ``T``, TF32 policy and storage and version of the
        layers' ``linear_pos`` weights."""
        if T > self.cfg.max_source_positions:
            raise ValueError(f"{T} frames exceed max_source_positions "
                             f"{self.cfg.max_source_positions}")
        attn = [layer.self_attn for layer in self.encoder.layers]
        key = (torch.device(device), T, torch.backends.cuda.matmul.allow_tf32,
               tuple((a.linear_pos.weight.data_ptr(),
                      a.linear_pos.weight._version) for a in attn))
        if self._tables is None or self._tables[0] != key:
            pe = relative_positions(T, self.cfg.hidden_size).to(device)
            with torch.no_grad():
                self._tables = (key, [a.table(pe) for a in attn])
            self.table_builds += 1
        return self._tables[1]

    def prepare(self, h, lens):
        """Each layer takes its position table and the key lengths."""
        return h, [(p, lens) for p in self.position_tables(h.shape[1],
                                                           h.device)]
