"""WavLM Large's sequence classifier in plain PyTorch, the benchmark's copy
of the reference: its input normalisation and its model as a function of a
state dict, keyed as ``param_spec`` names it (Hugging Face's names under
``WavLMForSequenceClassification``, the ``wavlm.`` prefix dropped).

Written from ``transformers``' ``modeling_wavlm.py`` and the paper (arXiv
2110.13900): a conv encoder of 7 x (Conv1d, LayerNorm over channels, GELU);
LayerNorm and a projection to the hidden size; padded frames zeroed; a
weight-normed grouped positional convolution, its last frame dropped,
GELU, added; pre-LN layers whose attention adds to ``q.k / sqrt(d)`` layer
0's bucketed relative position bias gated by each layer's
``a (b c - 1) + 2``, the padded keys masked; a final LayerNorm; a softmax
over ``layer_weights`` weighing the layers' inputs and the normed output;
``projector``, the mean over valid frames, ``classifier``.  A row with no
whole frame keeps its first frame (where Hugging Face would give NaN).

``forward(..., rnd)`` rounds each product's operands (``rnd``: the
benchmark's TF32 yardstick); in bfloat16 the whole forward runs in bf16.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.overlap import _same

__all__ = ["param_spec", "unit_table", "frames", "bucket", "inputs",
           "forward"]


def param_spec(m: dict) -> "OrderedDict[str, tuple]":
    """``name -> (shape, kind)`` of the model's state dict (``gen.weights``'
    kinds: ``kernel``, ``bias``, ``scale``).  The bucket table is drawn as
    a ``kernel`` and scaled to N(0, 1) by ``unit_table``."""
    spec = OrderedDict()
    dims = [1] + list(m["conv_dim"])
    for i, k in enumerate(m["conv_kernel"]):
        p = f"feature_extractor.conv_layers.{i}."
        spec[p + "conv.weight"] = ((dims[i + 1], dims[i], k), "kernel")
        if m["conv_bias"]:
            spec[p + "conv.bias"] = ((dims[i + 1],), "bias")
        spec[p + "layer_norm.weight"] = ((dims[i + 1],), "scale")
        spec[p + "layer_norm.bias"] = ((dims[i + 1],), "bias")
    D, H, C = m["hidden_size"], m["num_attention_heads"], dims[-1]
    spec["feature_projection.layer_norm.weight"] = ((C,), "scale")
    spec["feature_projection.layer_norm.bias"] = ((C,), "bias")
    spec["feature_projection.projection.weight"] = ((D, C), "kernel")
    spec["feature_projection.projection.bias"] = ((D,), "bias")
    K, G = m["num_conv_pos_embeddings"], m["num_conv_pos_embedding_groups"]
    p = "encoder.pos_conv_embed.conv."
    spec[p + "weight_g"] = ((1, 1, K), "scale")
    spec[p + "weight_v"] = ((D, D // G, K), "kernel")
    spec[p + "bias"] = ((D,), "bias")
    spec["encoder.layer_norm.weight"] = ((D,), "scale")
    spec["encoder.layer_norm.bias"] = ((D,), "bias")
    for i in range(m["num_hidden_layers"]):
        p = f"encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            spec[p + f"attention.{name}.weight"] = ((D, D), "kernel")
            spec[p + f"attention.{name}.bias"] = ((D,), "bias")
        spec[p + "attention.gru_rel_pos_const"] = ((1, H, 1, 1), "scale")
        spec[p + "attention.gru_rel_pos_linear.weight"] = ((8, D // H),
                                                           "kernel")
        spec[p + "attention.gru_rel_pos_linear.bias"] = ((8,), "bias")
        if i == 0:
            spec[p + "attention.rel_attn_embed.weight"] = (
                (m["num_buckets"], H), "kernel")
        spec[p + "layer_norm.weight"] = ((D,), "scale")
        spec[p + "layer_norm.bias"] = ((D,), "bias")
        F_ = m["intermediate_size"]
        spec[p + "feed_forward.intermediate_dense.weight"] = ((F_, D),
                                                              "kernel")
        spec[p + "feed_forward.intermediate_dense.bias"] = ((F_,), "bias")
        spec[p + "feed_forward.output_dense.weight"] = ((D, F_), "kernel")
        spec[p + "feed_forward.output_dense.bias"] = ((D,), "bias")
        spec[p + "final_layer_norm.weight"] = ((D,), "scale")
        spec[p + "final_layer_norm.bias"] = ((D,), "bias")
    spec["layer_weights"] = ((m["num_hidden_layers"] + 1,), "scale")
    P = m["classifier_proj_size"]
    spec["projector.weight"] = ((P, D), "kernel")
    spec["projector.bias"] = ((P,), "bias")
    spec["classifier.weight"] = ((m["num_labels"], P), "kernel")
    spec["classifier.bias"] = ((m["num_labels"],), "bias")
    return spec


TABLE = "encoder.layers.0.attention.rel_attn_embed.weight"


def unit_table(sd: dict) -> None:
    """Scale the bucket table of ``gen.weights``' ``kernel`` draw, N(0, 2 /
    (buckets + heads)), to N(0, 1): ``nn.Embedding``'s initialisation,
    which ``transformers`` leaves the table at."""
    sd[TABLE] = sd[TABLE] * math.sqrt(sum(sd[TABLE].shape) / 2.0)


def frames(m: dict, n: int) -> int:
    """Whole frames of the conv encoder over ``n`` samples."""
    for k, s in zip(m["conv_kernel"], m["conv_stride"]):
        n = (n - k) // s + 1
    return n


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int
           ) -> torch.Tensor:
    """``WavLMAttention._relative_positions_bucket``."""
    half = num_buckets // 2
    out = (rel > 0).to(torch.long) * half
    rel = torch.abs(rel)
    exact = half // 2
    large = torch.log(rel.float() / exact) / math.log(max_distance / exact)
    large = (exact + large * (half - exact)).to(torch.long)
    large = torch.min(large, torch.full_like(large, half - 1))
    return out + torch.where(rel < exact, rel, large)


@torch.no_grad()
def inputs(trimmed_i16, kept, eps: float, device) -> torch.Tensor:
    """The model's input rows of trimmed int16 windows ``(B, L)`` and their
    kept counts, in float64: the kept samples / 32768 less their mean over
    their standard deviation (``sqrt(var + eps)``), zero beyond them, then
    the kept count: ``(B, L + 1)`` float32."""
    x = torch.as_tensor(np.asarray(trimmed_i16), dtype=torch.float64,
                        device=device) / 32768.0
    n = torch.as_tensor(np.asarray(kept), dtype=torch.int64, device=device)
    L = x.shape[1]
    kept_ = torch.arange(L, device=device)[None, :] < n[:, None]
    count = n.clamp(1, L).to(torch.float64)[:, None]
    x = torch.where(kept_, x, 0.0)
    d = torch.where(kept_, x - x.sum(1, keepdim=True) / count, 0.0)
    var = (d * d).sum(1, keepdim=True) / count
    return torch.cat([d / torch.sqrt(var + eps),
                      n.to(torch.float64)[:, None]], 1).to(torch.float32)


def _ln(x, sd, p, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + "weight"], sd[p + "bias"],
                        eps)


@torch.no_grad()
def forward(sd: dict, x: torch.Tensor, n, m: dict, rnd=_same
            ) -> torch.Tensor:
    """Logits ``(B, num_labels)`` of normalised samples ``x (B, L)`` (in
    the state dict's dtype) with kept counts ``n``."""
    eps = m["layer_norm_eps"]

    def linear(t, p):
        return F.linear(rnd(t), rnd(sd[p + "weight"]), sd.get(p + "bias"))

    h = x[:, None]
    for i, s in enumerate(m["conv_stride"]):
        p = f"feature_extractor.conv_layers.{i}."
        h = F.conv1d(rnd(h), rnd(sd[p + "conv.weight"]),
                     sd.get(p + "conv.bias"), stride=s)
        h = F.gelu(_ln(h.transpose(1, 2), sd, p + "layer_norm.", 1e-5)
                   ).transpose(1, 2)
    h = _ln(h.transpose(1, 2), sd, "feature_projection.layer_norm.", eps)
    h = linear(h, "feature_projection.projection.")
    B, T, D = h.shape
    lens = torch.as_tensor([max(1, min(T, frames(m, int(c)))) for c in n],
                           device=h.device)
    valid = torch.arange(T, device=h.device)[None, :] < lens[:, None]
    h = h * valid[..., None].to(h.dtype)
    p = "encoder.pos_conv_embed.conv."
    v = sd[p + "weight_v"]
    w = sd[p + "weight_g"] * v / v.norm(dim=(0, 1), keepdim=True)
    K = m["num_conv_pos_embeddings"]
    pos = F.conv1d(rnd(h.transpose(1, 2)), rnd(w), sd[p + "bias"],
                   padding=K // 2, groups=m["num_conv_pos_embedding_groups"])
    if K % 2 == 0:
        pos = pos[..., :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    H = m["num_attention_heads"]
    dh = D // H
    r = torch.arange(T, device=h.device)
    table = sd[TABLE]
    bias = F.embedding(bucket(r[None, :] - r[:, None], m["num_buckets"],
                              m["max_bucket_distance"]),
                       table).permute(2, 0, 1)                  # (H, T, T)
    masked = ~valid[:, None, None, :]
    hidden = []
    for i in range(m["num_hidden_layers"]):
        hidden.append(h)
        p = f"encoder.layers.{i}."
        a = p + "attention."
        y = _ln(h, sd, p + "layer_norm.", eps)

        def heads(t):
            return t.view(B, T, H, dh).transpose(1, 2)

        q = heads(linear(y, a + "q_proj."))
        k = heads(linear(y, a + "k_proj."))
        vv = heads(linear(y, a + "v_proj."))
        g = linear(y.view(B, T, H, dh), a + "gru_rel_pos_linear.")
        ga, gb = torch.sigmoid(g.view(B, T, H, 2, 4).sum(-1)).unbind(-1)
        gate = (ga * (gb * sd[a + "gru_rel_pos_const"].view(H) - 1.0)
                + 2.0).transpose(1, 2)                          # (B, H, T)
        scores = rnd(q / math.sqrt(dh)) @ rnd(k).transpose(-1, -2) \
            + gate[..., None] * bias
        prob = torch.softmax(scores.masked_fill(masked, float("-inf")), -1)
        out = (rnd(prob) @ rnd(vv)).transpose(1, 2).reshape(B, T, D)
        h = h + linear(out, a + "out_proj.")
        f = _ln(h, sd, p + "final_layer_norm.", eps)
        f = F.gelu(linear(f, p + "feed_forward.intermediate_dense."))
        h = h + linear(f, p + "feed_forward.output_dense.")
    hidden.append(_ln(h, sd, "encoder.layer_norm.", eps))
    weights = torch.softmax(sd["layer_weights"], dim=-1)
    h = (torch.stack(hidden, 1) * weights.view(-1, 1, 1)).sum(1)
    h = linear(h, "projector.") * valid[..., None].to(h.dtype)
    pooled = h.sum(1) / lens[:, None].to(h.dtype)
    return linear(pooled, "classifier.")
