"""wav2vec 2.0 Conformer's sequence classifier in plain PyTorch, the
benchmark's copy of the reference: its model as a function of a state
dict, keyed as ``param_spec`` names it (Hugging Face's names under
``Wav2Vec2ConformerForSequenceClassification``, the ``wav2vec2_conformer.``
prefix dropped); the input normalisation is WavLM's
(``reference/wavlm.py::inputs``).

Written from ``transformers``' ``modeling_wav2vec2_conformer.py`` and the
papers (arXiv:2005.08100, 1901.02860, 2010.05171): a conv encoder of 7 x
(Conv1d with bias, LayerNorm over channels, GELU); LayerNorm and a
projection to the hidden size; padded frames zeroed; the sinusoids of the
relative positions, projected by each layer's ``linear_pos`` every forward;
macaron layers (half FFN, relative self-attention whose positional scores
against all ``2T - 1`` positions are rel-shifted by padding a zero column,
viewing and slicing, the conv module channels-first with its BatchNorm
written out from the running statistics, half FFN, LayerNorm), the padded
keys masked; a final LayerNorm; a softmax over ``layer_weights`` weighing
the layers' inputs and the normed output; ``projector``, the mean over
valid frames, ``classifier``.  A row with no whole frame keeps its first
frame (where Hugging Face would attend to every frame).

``forward(..., rnd)`` rounds each product's operands (``rnd``: the
benchmark's TF32 yardstick); in bfloat16 the whole forward runs in bf16.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

from perfbench.reference.overlap import _same
from perfbench.reference.wavlm import frames, inputs

__all__ = ["param_spec", "frames", "inputs", "sinusoids", "forward"]


def param_spec(m: dict) -> "OrderedDict[str, tuple]":
    """``name -> (shape, kind)`` of the model's state dict (``gen.weights``'
    kinds: ``kernel``, ``bias``, ``scale``, ``shift``, ``var``, ``count``).
    ``pos_bias_u`` and ``pos_bias_v`` are drawn as ``kernel``s: the variance
    of the Xavier initialisation ``transformers`` gives them."""
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
    F_, K = m["intermediate_size"], m["conv_depthwise_kernel_size"]
    spec["feature_projection.layer_norm.weight"] = ((C,), "scale")
    spec["feature_projection.layer_norm.bias"] = ((C,), "bias")
    spec["feature_projection.projection.weight"] = ((D, C), "kernel")
    spec["feature_projection.projection.bias"] = ((D,), "bias")
    spec["encoder.layer_norm.weight"] = ((D,), "scale")
    spec["encoder.layer_norm.bias"] = ((D,), "bias")

    def norm(p):
        spec[p + "weight"] = ((D,), "scale")
        spec[p + "bias"] = ((D,), "bias")

    def ffn(p):
        spec[p + "intermediate_dense.weight"] = ((F_, D), "kernel")
        spec[p + "intermediate_dense.bias"] = ((F_,), "bias")
        spec[p + "output_dense.weight"] = ((D, F_), "kernel")
        spec[p + "output_dense.bias"] = ((D,), "bias")

    for i in range(m["num_hidden_layers"]):
        p = f"encoder.layers.{i}."
        norm(p + "ffn1_layer_norm.")
        ffn(p + "ffn1.")
        norm(p + "self_attn_layer_norm.")
        a = p + "self_attn."
        spec[a + "pos_bias_u"] = ((H, D // H), "kernel")
        spec[a + "pos_bias_v"] = ((H, D // H), "kernel")
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            spec[a + name + ".weight"] = ((D, D), "kernel")
            spec[a + name + ".bias"] = ((D,), "bias")
        spec[a + "linear_pos.weight"] = ((D, D), "kernel")
        c = p + "conv_module."
        norm(c + "layer_norm.")
        spec[c + "pointwise_conv1.weight"] = ((2 * D, D, 1), "kernel")
        spec[c + "depthwise_conv.weight"] = ((D, 1, K), "kernel")
        spec[c + "batch_norm.weight"] = ((D,), "scale")
        spec[c + "batch_norm.bias"] = ((D,), "bias")
        spec[c + "batch_norm.running_mean"] = ((D,), "shift")
        spec[c + "batch_norm.running_var"] = ((D,), "var")
        spec[c + "batch_norm.num_batches_tracked"] = ((), "count")
        spec[c + "pointwise_conv2.weight"] = ((D, D, 1), "kernel")
        norm(p + "ffn2_layer_norm.")
        ffn(p + "ffn2.")
        norm(p + "final_layer_norm.")
    spec["layer_weights"] = ((m["num_hidden_layers"] + 1,), "scale")
    P = m["classifier_proj_size"]
    spec["projector.weight"] = ((P, D), "kernel")
    spec["projector.bias"] = ((P,), "bias")
    spec["classifier.weight"] = ((m["num_labels"], P), "kernel")
    spec["classifier.bias"] = ((m["num_labels"],), "bias")
    return spec


def sinusoids(T: int, d_model: int) -> torch.Tensor:
    """``(2T - 1, d_model)`` float32: row ``m`` the sinusoid of relative
    position ``T - 1 - m`` (``Wav2Vec2ConformerRelPositionalEmbedding``'s
    centre rows)."""
    rel = torch.arange(T - 1, -T, -1, dtype=torch.int64).float()[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.int64).float()
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(2 * T - 1, d_model)
    pe[:, 0::2] = torch.sin(rel * div)
    pe[:, 1::2] = torch.cos(rel * div)
    return pe


def _ln(x, sd, p, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], sd[p + "weight"], sd[p + "bias"],
                        eps)


@torch.no_grad()
def forward(sd: dict, x: torch.Tensor, n, m: dict, rnd=_same
            ) -> torch.Tensor:
    """Logits ``(B, num_labels)`` of normalised samples ``x (B, L)`` (in
    the state dict's dtype) with kept counts ``n``."""

    def linear(t, p):
        return F.linear(rnd(t), rnd(sd[p + "weight"]), sd.get(p + "bias"))

    def ffn(t, p):
        return linear(F.silu(linear(t, p + "intermediate_dense.")),
                      p + "output_dense.")

    h = x[:, None]
    for i, s in enumerate(m["conv_stride"]):
        p = f"feature_extractor.conv_layers.{i}."
        h = F.conv1d(rnd(h), rnd(sd[p + "conv.weight"]),
                     sd.get(p + "conv.bias"), stride=s)
        h = F.gelu(_ln(h.transpose(1, 2), sd, p + "layer_norm.")
                   ).transpose(1, 2)
    h = _ln(h.transpose(1, 2), sd, "feature_projection.layer_norm.",
            m["layer_norm_eps"])
    h = linear(h, "feature_projection.projection.")
    B, T, D = h.shape
    lens = torch.as_tensor([max(1, min(T, frames(m, int(c)))) for c in n],
                           device=h.device)
    valid = torch.arange(T, device=h.device)[None, :] < lens[:, None]
    h = h * valid[..., None].to(h.dtype)
    H = m["num_attention_heads"]
    dh, K = D // H, m["conv_depthwise_kernel_size"]
    pe = sinusoids(T, D).to(h.device, h.dtype)
    masked = ~valid[:, None, None, :]

    def heads(t):
        return t.view(B, T, H, dh).transpose(1, 2)

    hidden = []
    for i in range(m["num_hidden_layers"]):
        hidden.append(h)
        p = f"encoder.layers.{i}."
        h = ffn(_ln(h, sd, p + "ffn1_layer_norm."), p + "ffn1.") * 0.5 + h
        a = p + "self_attn."
        y = _ln(h, sd, p + "self_attn_layer_norm.")
        q = heads(linear(y, a + "linear_q."))
        k = heads(linear(y, a + "linear_k."))
        v = heads(linear(y, a + "linear_v."))
        pos = F.linear(rnd(pe), rnd(sd[a + "linear_pos.weight"]))
        pos = pos.view(2 * T - 1, H, dh).permute(1, 2, 0)    # (H, d, 2T-1)
        ac = rnd(q + sd[a + "pos_bias_u"][:, None]) @ rnd(k).transpose(-1, -2)
        bd = rnd(q + sd[a + "pos_bias_v"][:, None]) @ rnd(pos)
        # the rel shift: pad a zero column, view, slice
        pad = torch.zeros((B, H, T, 1), dtype=bd.dtype, device=bd.device)
        bd = torch.cat([pad, bd], -1).view(B, H, 2 * T, T)[:, :, 1:]
        bd = bd.reshape(B, H, T, 2 * T - 1)[..., :T]
        scores = (ac + bd) / math.sqrt(dh)
        prob = torch.softmax(scores.masked_fill(masked, float("-inf")), -1)
        out = (rnd(prob) @ rnd(v)).transpose(1, 2).reshape(B, T, D)
        h = h + linear(out, a + "linear_out.")
        c = p + "conv_module."
        y = _ln(h, sd, c + "layer_norm.").transpose(1, 2)
        y = F.glu(F.conv1d(rnd(y), rnd(sd[c + "pointwise_conv1.weight"])),
                  dim=1)
        y = F.conv1d(rnd(y), rnd(sd[c + "depthwise_conv.weight"]),
                     padding=(K - 1) // 2, groups=D)
        b = c + "batch_norm."
        y = (y - sd[b + "running_mean"][:, None]) \
            / torch.sqrt(sd[b + "running_var"][:, None] + 1e-5) \
            * sd[b + "weight"][:, None] + sd[b + "bias"][:, None]
        y = F.conv1d(rnd(F.silu(y)), rnd(sd[c + "pointwise_conv2.weight"]))
        h = h + y.transpose(1, 2)
        h = ffn(_ln(h, sd, p + "ffn2_layer_norm."), p + "ffn2.") * 0.5 + h
        h = _ln(h, sd, p + "final_layer_norm.")
    hidden.append(_ln(h, sd, "encoder.layer_norm.", m["layer_norm_eps"]))
    weights = torch.softmax(sd["layer_weights"], dim=-1)
    h = (torch.stack(hidden, 1) * weights.view(-1, 1, 1)).sum(1)
    h = linear(h, "projector.") * valid[..., None].to(h.dtype)
    pooled = h.sum(1) / lens[:, None].to(h.dtype)
    return linear(pooled, "classifier.")
