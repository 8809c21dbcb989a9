"""The overlap detector in plain PyTorch: its input image and its model.

``image``: librosa 0.8 semantics on the first 1.5 s of a trimmed window
(centered reflect STFT of 400 points, hop 160, periodic Hann; Slaney mel
filterbank of 128 bands; ``power_to_db`` against the peak with top_db 80;
min-max normalized, a constant image mapping to 0; the edge-padded
zero-crossing rate), the mel axis flipped and truncated to uint8 as the
reference's PNG round trip does; float64 until that truncation.

``forward``: OverlapResBLSTM (a 1x1 stem; 3 stages of 3 pre-activation
residual blocks, the first of each pooling 2x2 and projecting its shortcut
with a strided 1x1; the mean over the mel axis; a Keras bidirectional LSTM;
LeakyReLU 0.3; a dense head) from a state dict keyed as ``param_spec``
names it, in the dtype and precision the caller sets.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["param_spec", "image", "forward", "fused_block", "fused_blocks",
           "tf32_round"]


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest even:
    what the tensor cores read of an operand when TF32 is allowed."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _same(t):
    return t


def param_spec(m: dict) -> "OrderedDict[str, tuple]":
    """``name -> (shape, kind)`` of the model's state dict; kind is
    ``kernel`` (with its fan), ``bias``, ``scale``, ``shift``, ``var``,
    ``zero`` or ``count``."""
    spec = OrderedDict()
    spec["stem.weight"] = ((m["stem_filters"], 3, 1, 1), "kernel")
    spec["stem.bias"] = ((m["stem_filters"],), "bias")
    ch, i = m["stem_filters"], 0
    for f in m["stage_filters"]:
        for b in range(m["blocks_per_stage"]):
            p = f"blocks.{i}."
            if b == 0:
                spec[p + "shortcut.weight"] = ((f, ch, 1, 1), "kernel")
                spec[p + "shortcut.bias"] = ((f,), "bias")
            _bn(spec, p + "bn0.", ch)
            spec[p + "conv0.weight"] = ((f, ch, 3, 3), "kernel")
            spec[p + "conv0.bias"] = ((f,), "bias")
            _bn(spec, p + "bn1.", f)
            spec[p + "conv1.weight"] = ((f, f, 4, 1), "kernel")
            spec[p + "conv1.bias"] = ((f,), "bias")
            ch, i = f, i + 1
    _lstm(spec, "bilstm.lstm.", ch, m["lstm_units"])
    spec["head.weight"] = ((m["num_classes"], 2 * m["lstm_units"]), "kernel")
    spec["head.bias"] = ((m["num_classes"],), "bias")
    return spec


def _bn(spec, p, c):
    spec[p + "weight"] = ((c,), "scale")
    spec[p + "bias"] = ((c,), "shift")
    spec[p + "running_mean"] = ((c,), "shift")
    spec[p + "running_var"] = ((c,), "var")
    spec[p + "num_batches_tracked"] = ((), "count")


def _lstm(spec, p, c, h):
    for sfx in ("", "_reverse"):
        spec[p + f"weight_ih_l0{sfx}"] = ((4 * h, c), "kernel")
        spec[p + f"weight_hh_l0{sfx}"] = ((4 * h, h), "kernel")
        spec[p + f"bias_ih_l0{sfx}"] = ((4 * h,), "bias")
        # Keras has one LSTM bias: the second stays zero
        spec[p + f"bias_hh_l0{sfx}"] = ((4 * h,), "zero")


# -- the image ---------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10)
                                               / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel (Slaney scale and norm, fmin 0, fmax sr/2)."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    return w * (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]


@torch.no_grad()
def image(trimmed_i16: np.ndarray, feat: dict, device) -> torch.Tensor:
    """Model input ``(B, n_mels, frames, 3)`` float32 in 0..255 of trimmed
    int16 windows ``(B, >= n)``."""
    sr = feat["sample_rate"]
    win = int(sr * feat["win_ms"] / 1000)
    hop = int(sr * feat["hop_ms"] / 1000)
    n = hop * feat["time_dim"]
    y = torch.as_tensor(trimmed_i16[:, :n].astype(np.float64) / 32768.0,
                        device=device)
    k = torch.arange(win, dtype=torch.float64, device=device)
    w = 0.5 - 0.5 * torch.cos(2.0 * np.pi * k / win)
    yp = F.pad(y[:, None], (win // 2, win // 2), mode="reflect")[:, 0]
    power = torch.fft.rfft(yp.unfold(-1, win, hop) * w, n=win,
                           dim=-1).abs() ** 2                 # (B, T, bins)
    fb = torch.as_tensor(mel_filterbank(sr, win, feat["n_mels"]),
                         device=device)
    mel = torch.einsum("mk,btk->bmt", fb, power)
    ref = mel.amax(dim=(1, 2), keepdim=True)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10)) \
        - 10.0 * torch.log10(torch.clamp(ref, min=1e-10))
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    lo = db.amin(dim=(1, 2), keepdim=True)
    span = db.amax(dim=(1, 2), keepdim=True) - lo
    norm = torch.where(span > 0, (db - lo) / torch.where(span > 0, span, 1.0),
                       torch.zeros_like(db))
    ye = F.pad(y[:, None], (win // 2, win // 2), mode="replicate")[:, 0]
    fr = ye.unfold(-1, win, hop)
    fr = torch.where(fr.abs() <= 1e-10, torch.zeros_like(fr), fr)
    neg = torch.signbit(fr)
    zcr = (neg[..., 1:] != neg[..., :-1]).to(torch.float64).sum(-1) / win
    T = norm.shape[-1]
    zcr = zcr[:, :T]
    img = torch.stack([zcr[:, None, :].expand_as(norm), 1.0 - norm,
                       1.0 - norm], dim=-1)                   # (B, M, T, 3)
    img = torch.flip(img, dims=(1,))
    return torch.floor(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.float32)


# -- the model ---------------------------------------------------------------

def _batch_norm(x, sd, p, eps):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    scale = sd[p + "weight"] / torch.sqrt(sd[p + "running_var"] + eps)
    return (x - sd[p + "running_mean"].reshape(shape)) * scale.reshape(shape) \
        + sd[p + "bias"].reshape(shape)


def bilstm(x: torch.Tensor, sd, p: str, rnd=_same) -> torch.Tensor:
    """Keras ``Bidirectional(LSTM)`` over ``x (B, T, C)``: the forward
    direction's last state, then the backward direction's (which reads the
    sequence from its end), gates i, f, g, o."""
    outs = []
    for sfx, steps in (("", range(x.shape[1])),
                       ("_reverse", range(x.shape[1] - 1, -1, -1))):
        w_ih, w_hh = sd[p + f"weight_ih_l0{sfx}"], sd[p + f"weight_hh_l0{sfx}"]
        bias = sd[p + f"bias_ih_l0{sfx}"] + sd[p + f"bias_hh_l0{sfx}"]
        H = w_hh.shape[1]
        h = x.new_zeros((x.shape[0], H))
        c = x.new_zeros((x.shape[0], H))
        xin = rnd(x) @ rnd(w_ih).T + bias
        for t in steps:
            g = xin[:, t] + rnd(h) @ rnd(w_hh).T
            i, f, gg, o = g.split(H, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.cat(outs, dim=1)


def fused_block(sd: dict, p: str, x: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """One residual block that does not pool, ``p`` its key prefix, on
    ``x (B, C, H, W)``, in the dtype and precision the caller sets."""
    out = F.conv2d(F.elu(_batch_norm(x, sd, p + "bn0.", eps)),
                   sd[p + "conv0.weight"], sd[p + "conv0.bias"], padding=1)
    out = F.elu(_batch_norm(out, sd, p + "bn1.", eps))
    return x + F.conv2d(F.pad(out, (0, 0, 1, 2)), sd[p + "conv1.weight"],
                        sd[p + "conv1.bias"])


def fused_blocks(m: dict) -> list:
    """Key prefixes of the blocks that do not pool, in the model's order."""
    b = m["blocks_per_stage"]
    return [f"blocks.{i}." for i in range(len(m["stage_filters"]) * b)
            if i % b]


def forward(sd: dict, x: torch.Tensor, m: dict, rnd=_same,
            rnd_fused=None) -> torch.Tensor:
    """Logits ``(B, classes)`` of images ``x (B, 128, 151, 3)``; ``rnd``
    rounds each product's operands (``tf32_round``: TF32's), and
    ``rnd_fused`` (default ``rnd``) those of the two convolutions of each
    block that does not pool, the fused residual block."""
    eps = m["bn_eps"]
    rnd_fused = rnd if rnd_fused is None else rnd_fused

    def conv(t, w, b, r=rnd, **kw):
        return F.conv2d(r(t), r(w), b, **kw)

    net = x.permute(0, 3, 1, 2) * m["input_scale"]
    net = conv(net, sd["stem.weight"], sd["stem.bias"])
    i = 0
    for f in m["stage_filters"]:
        for b in range(m["blocks_per_stage"]):
            p = f"blocks.{i}."
            pool = b == 0
            res = conv(net, sd[p + "shortcut.weight"],
                       sd[p + "shortcut.bias"], stride=2) if pool else net
            r = rnd if pool else rnd_fused
            out = conv(F.elu(_batch_norm(net, sd, p + "bn0.", eps)),
                       sd[p + "conv0.weight"], sd[p + "conv0.bias"], r,
                       padding=1)
            out = F.elu(_batch_norm(out, sd, p + "bn1.", eps))
            out = conv(F.pad(out, (0, 0, 1, 2)), sd[p + "conv1.weight"],
                       sd[p + "conv1.bias"], r)
            if pool:
                out = F.max_pool2d(out, 2, 2, ceil_mode=True)
            net = res + out
            i += 1
    seq = net.mean(dim=2).transpose(1, 2)                    # (B, T, C)
    h = bilstm(seq, sd, "bilstm.lstm.", rnd)
    h = torch.where(h >= 0, h, 0.3 * h)
    return rnd(h) @ rnd(sd["head.weight"]).T + sd["head.bias"]
