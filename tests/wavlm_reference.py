"""A plain reference of WavLM's sequence classifier, written from Hugging
Face ``transformers``' ``modeling_wavlm.py``
(``WavLMForSequenceClassification`` with ``feat_extract_norm="layer"``,
``do_stable_layer_norm`` and ``use_weighted_layer_sum``) as a function of a
state dict.

Plain ``torch`` in float32 (the input normalisation in float64), TF32 off
in the libraries; it imports neither JAX nor anything of
``mmla_audio_torch``, so that the port is held against equations it does
not share code with.  The attention is ``F.multi_head_attention_forward``
with the gated bias as its float mask and the padded keys as its
``key_padding_mask``, as Hugging Face calls it.  Where the port departs
from Hugging Face for rows with no whole frame (``models/wavlm.py``), this
reference follows the port: such a row keeps its first frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["bucket", "normalize", "frames", "attention", "forward"]


def bucket(rel: torch.Tensor, num_buckets: int = 320,
           max_distance: int = 800) -> torch.Tensor:
    """``WavLMAttention._relative_positions_bucket``."""
    num_buckets = num_buckets // 2
    buckets = (rel > 0).to(torch.long) * num_buckets
    rel = torch.abs(rel)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = torch.log(rel.float() / max_exact)
    large = large / math.log(max_distance / max_exact)
    large = large * (num_buckets - max_exact)
    large = (max_exact + large).to(torch.long)
    large = torch.min(large, torch.full_like(large, num_buckets - 1))
    return buckets + torch.where(is_small, rel, large)


def normalize(trimmed, kept, eps: float = 1e-7) -> torch.Tensor:
    """The feature extractor's ``do_normalize`` over each row's kept
    samples / 32768 (zero beyond them), in float64: ``(B, L)`` float32."""
    x = np.asarray(trimmed, np.float64) / 32768.0
    out = np.zeros_like(x)
    for b, n in enumerate(np.asarray(kept).tolist()):
        n = min(int(n), x.shape[1])
        if n > 0:
            v = x[b, :n]
            out[b, :n] = (v - v.mean()) / np.sqrt(v.var() + eps)
    return torch.from_numpy(out.astype(np.float32))


def frames(n: int, kernels, strides) -> int:
    """``_get_feat_extract_output_lengths``."""
    for k, s in zip(kernels, strides):
        n = (n - k) // s + 1
    return n


def attention(x, sd, p, position_bias, key_padding, heads):
    """One ``WavLMAttention`` of the layer under prefix ``p`` on its input
    ``x (B, T, D)``: the gate, then ``F.multi_head_attention_forward``."""
    B, T, D = x.shape
    gated = x.view(B, T, heads, -1).permute(0, 2, 1, 3)
    proj = F.linear(gated, sd[p + "gru_rel_pos_linear.weight"],
                    sd[p + "gru_rel_pos_linear.bias"])
    proj = proj.view(gated.shape[:-1] + (2, 4)).sum(-1)
    gate_a, gate_b = torch.sigmoid(proj).chunk(2, dim=-1)
    gate = gate_a * (gate_b * sd[p + "gru_rel_pos_const"] - 1.0) + 2.0
    gated_bias = gate.view(B * heads, -1, 1) * position_bias
    out, _ = F.multi_head_attention_forward(
        x.transpose(0, 1), x.transpose(0, 1), x.transpose(0, 1), D, heads,
        torch.empty([0]),
        torch.cat((sd[p + "q_proj.bias"], sd[p + "k_proj.bias"],
                   sd[p + "v_proj.bias"])),
        None, None, False, 0.0, sd[p + "out_proj.weight"],
        sd[p + "out_proj.bias"], training=False,
        key_padding_mask=key_padding, need_weights=False,
        attn_mask=gated_bias.view(B * heads, T, T),
        use_separate_proj_weight=True, q_proj_weight=sd[p + "q_proj.weight"],
        k_proj_weight=sd[p + "k_proj.weight"],
        v_proj_weight=sd[p + "v_proj.weight"])
    return out.transpose(0, 1)


def _ln(x, sd, p, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + "weight"], sd[p + "bias"],
                        eps)


@torch.no_grad()
def forward(sd: dict, x: torch.Tensor, kept, cfg) -> torch.Tensor:
    """Logits ``(B, num_labels)`` of normalised samples ``x (B, L)`` with
    kept counts ``kept``; ``cfg`` a ``WavLMConfig``-like object."""
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
    eps = cfg.layer_norm_eps
    h = x[:, None]
    for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
        p = f"feature_extractor.conv_layers.{i}."
        h = F.conv1d(h, sd[p + "conv.weight"], sd.get(p + "conv.bias"),
                     stride=s)
        h = F.gelu(F.layer_norm(h.transpose(-2, -1), h.shape[1:2],
                                sd[p + "layer_norm.weight"],
                                sd[p + "layer_norm.bias"]).transpose(-2, -1))
    h = _ln(h.transpose(1, 2), sd, "feature_projection.layer_norm.", eps)
    h = F.linear(h, sd["feature_projection.projection.weight"],
                 sd["feature_projection.projection.bias"])
    B, T, D = h.shape
    lens = [max(1, min(T, frames(int(n), cfg.conv_kernel, cfg.conv_stride)))
            for n in kept]
    valid = torch.arange(T, device=h.device)[None, :] < torch.tensor(
        lens, device=h.device)[:, None]
    h = h.clone()
    h[~valid] = 0.0
    p = "encoder.pos_conv_embed.conv."
    v = sd[p + "weight_v"]
    w = sd[p + "weight_g"] * v / v.norm(dim=(0, 1), keepdim=True)
    pos = F.conv1d(h.transpose(1, 2), w, sd[p + "bias"],
                   padding=cfg.num_conv_pos_embeddings // 2,
                   groups=cfg.num_conv_pos_embedding_groups)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    heads = cfg.num_attention_heads
    ctx = torch.arange(T, device=h.device)[:, None]
    mem = torch.arange(T, device=h.device)[None, :]
    table = sd["encoder.layers.0.attention.rel_attn_embed.weight"]
    position_bias = F.embedding(
        bucket(mem - ctx, cfg.num_buckets, cfg.max_bucket_distance),
        table).permute(2, 0, 1)
    position_bias = position_bias.unsqueeze(0).repeat(B, 1, 1, 1).view(
        B * heads, T, T)
    # the padded keys as a float mask, the type of the gated bias
    key_padding = torch.zeros(valid.shape, device=h.device).masked_fill(
        ~valid, float("-inf"))
    hidden = []
    for i in range(cfg.num_hidden_layers):
        hidden.append(h)
        p = f"encoder.layers.{i}."
        a = attention(_ln(h, sd, p + "layer_norm.", eps), sd,
                      p + "attention.", position_bias, key_padding, heads)
        h = h + a
        f = _ln(h, sd, p + "final_layer_norm.", eps)
        f = F.linear(F.gelu(F.linear(
            f, sd[p + "feed_forward.intermediate_dense.weight"],
            sd[p + "feed_forward.intermediate_dense.bias"])),
            sd[p + "feed_forward.output_dense.weight"],
            sd[p + "feed_forward.output_dense.bias"])
        h = h + f
    hidden.append(_ln(h, sd, "encoder.layer_norm.", eps))
    stacked = torch.stack(hidden, dim=1)
    weights = torch.softmax(sd["layer_weights"], dim=-1)
    h = (stacked * weights.view(-1, 1, 1)).sum(dim=1)
    h = F.linear(h, sd["projector.weight"], sd["projector.bias"])
    h = h.clone()
    h[~valid] = 0.0
    pooled = h.sum(dim=1) / valid.sum(dim=1).view(-1, 1)
    return F.linear(pooled, sd["classifier.weight"], sd["classifier.bias"])
