"""A plain reference of wav2vec 2.0 Conformer's sequence classifier, written
from Hugging Face ``transformers``' ``modeling_wav2vec2_conformer.py``
(``Wav2Vec2ConformerForSequenceClassification`` with
``feat_extract_norm="layer"``, ``position_embeddings_type="relative"`` and
``use_weighted_layer_sum``) as a function of a state dict keyed as the port
keys it (Hugging Face's names, the ``wav2vec2_conformer.`` prefix dropped).

Plain ``torch`` in float32 (the input normalisation in float64), TF32 off
in the libraries; it imports neither JAX, nor ``transformers``, nor
anything of ``mmla_audio_torch``, so that the port is held against
equations it does not share code with.  As in Hugging Face: the sinusoids
of the relative positions are made and projected by each layer's
``linear_pos`` every forward; the positional scores ``(q + v) . p`` are
computed against all ``2T - 1`` positions and rel-shifted by padding a
zero column, viewing and slicing; the conv module runs channels-first with
its BatchNorm written out from the running statistics.  Where the port
departs from Hugging Face for rows with no whole frame, this reference
follows the port: such a row keeps its first frame.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tests.wavlm_reference import frames, normalize

__all__ = ["normalize", "frames", "sinusoids", "attention", "conv_module",
           "forward"]


def sinusoids(T: int, d_model: int) -> torch.Tensor:
    """``(2T - 1, d_model)``: row ``m`` the sinusoid of relative position
    ``T - 1 - m``, as ``Wav2Vec2ConformerRelPositionalEmbedding`` slices
    its table."""
    rel = torch.arange(T - 1, -T, -1, dtype=torch.int64).float()[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.int64).float()
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(2 * T - 1, d_model)
    pe[:, 0::2] = torch.sin(rel * div)
    pe[:, 1::2] = torch.cos(rel * div)
    return pe


def attention(x, sd, p, pe, key_mask, heads):
    """``Wav2Vec2ConformerSelfAttention`` (relative) of the layer under
    prefix ``p`` on its input ``x (B, T, D)``; ``key_mask (B, T)`` True at
    padded keys."""
    B, T, D = x.shape
    d = D // heads

    def proj(name):
        return F.linear(x, sd[p + name + ".weight"], sd[p + name + ".bias"]
                        ).view(B, T, heads, d).transpose(1, 2)

    q, k, v = proj("linear_q"), proj("linear_k"), proj("linear_v")
    pos = F.linear(pe, sd[p + "linear_pos.weight"])
    pos = pos.view(1, -1, heads, d).transpose(1, 2).transpose(2, 3)
    qt = q.transpose(1, 2)
    q_u = (qt + sd[p + "pos_bias_u"]).transpose(1, 2)
    q_v = (qt + sd[p + "pos_bias_v"]).transpose(1, 2)
    ac = torch.matmul(q_u, k.transpose(-2, -1))
    bd = torch.matmul(q_v, pos)                          # (B, H, T, 2T - 1)
    # the rel shift: pad a zero column, view, slice
    pad = torch.zeros((*bd.shape[:3], 1), dtype=bd.dtype, device=bd.device)
    shifted = torch.cat([pad, bd], dim=-1).view(
        *bd.shape[:2], bd.shape[3] + 1, bd.shape[2])
    bd = shifted[:, :, 1:].view_as(bd)[:, :, :, : bd.shape[-1] // 2 + 1]
    scores = (ac + bd) / math.sqrt(d)
    scores = scores.masked_fill(key_mask[:, None, None, :], float("-inf"))
    out = torch.matmul(torch.softmax(scores, dim=-1), v)
    out = out.transpose(1, 2).reshape(B, T, D)
    return F.linear(out, sd[p + "linear_out.weight"],
                    sd[p + "linear_out.bias"])


def conv_module(x, sd, p, kernel: int):
    """``Wav2Vec2ConformerConvolutionModule`` of the layer under prefix
    ``p``, channels-first inside, its BatchNorm written out."""
    y = _ln(x, sd, p + "layer_norm.", 1e-5).transpose(1, 2)
    y = F.glu(F.conv1d(y, sd[p + "pointwise_conv1.weight"]), dim=1)
    y = F.conv1d(y, sd[p + "depthwise_conv.weight"],
                 padding=(kernel - 1) // 2, groups=y.shape[1])
    b = p + "batch_norm."
    y = (y - sd[b + "running_mean"][:, None]) \
        / torch.sqrt(sd[b + "running_var"][:, None] + 1e-5) \
        * sd[b + "weight"][:, None] + sd[b + "bias"][:, None]
    y = F.conv1d(F.silu(y), sd[p + "pointwise_conv2.weight"])
    return y.transpose(1, 2)


def _ln(x, sd, p, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + "weight"], sd[p + "bias"],
                        eps)


def _ffn(x, sd, p):
    x = F.silu(F.linear(x, sd[p + "intermediate_dense.weight"],
                        sd[p + "intermediate_dense.bias"]))
    return F.linear(x, sd[p + "output_dense.weight"],
                    sd[p + "output_dense.bias"])


@torch.no_grad()
def forward(sd: dict, x: torch.Tensor, kept, cfg) -> torch.Tensor:
    """Logits ``(B, num_labels)`` of normalised samples ``x (B, L)`` with
    kept counts ``kept``; ``cfg`` a ``ConformerConfig``-like object."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(sd, x, kept, cfg)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _forward(sd, x, kept, cfg):
    h = x[:, None]
    for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
        p = f"feature_extractor.conv_layers.{i}."
        h = F.conv1d(h, sd[p + "conv.weight"], sd.get(p + "conv.bias"),
                     stride=s)
        h = F.gelu(F.layer_norm(h.transpose(-2, -1), h.shape[1:2],
                                sd[p + "layer_norm.weight"],
                                sd[p + "layer_norm.bias"]).transpose(-2, -1))
    h = _ln(h.transpose(1, 2), sd, "feature_projection.layer_norm.",
            cfg.layer_norm_eps)
    h = F.linear(h, sd["feature_projection.projection.weight"],
                 sd["feature_projection.projection.bias"])
    B, T, D = h.shape
    lens = [max(1, min(T, frames(int(n), cfg.conv_kernel, cfg.conv_stride)))
            for n in kept]
    valid = torch.arange(T, device=h.device)[None, :] < torch.tensor(
        lens, device=h.device)[:, None]
    h = h.clone()
    h[~valid] = 0.0
    pe = sinusoids(T, D).to(h.device)
    hidden = []
    for i in range(cfg.num_hidden_layers):
        hidden.append(h)
        p = f"encoder.layers.{i}."
        h = _ffn(_ln(h, sd, p + "ffn1_layer_norm.", 1e-5), sd,
                 p + "ffn1.") * 0.5 + h
        h = attention(_ln(h, sd, p + "self_attn_layer_norm.", 1e-5), sd,
                      p + "self_attn.", pe, ~valid,
                      cfg.num_attention_heads) + h
        h = h + conv_module(h, sd, p + "conv_module.",
                            cfg.conv_depthwise_kernel_size)
        h = _ffn(_ln(h, sd, p + "ffn2_layer_norm.", 1e-5), sd,
                 p + "ffn2.") * 0.5 + h
        h = _ln(h, sd, p + "final_layer_norm.", 1e-5)
    hidden.append(_ln(h, sd, "encoder.layer_norm.", cfg.layer_norm_eps))
    stacked = torch.stack(hidden, dim=1)
    weights = torch.softmax(sd["layer_weights"], dim=-1)
    h = (stacked * weights.view(-1, 1, 1)).sum(dim=1)
    h = F.linear(h, sd["projector.weight"], sd["projector.bias"])
    h = h.clone()
    h[~valid] = 0.0
    pooled = h.sum(dim=1) / valid.sum(dim=1).view(-1, 1)
    return F.linear(pooled, sd["classifier.weight"], sd["classifier.bias"])
