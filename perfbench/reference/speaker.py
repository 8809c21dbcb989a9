"""The speaker identifier in plain PyTorch: its MFCC-39 rows and its model.

``features``: python_speech_features semantics on each trimmed window's
kept samples (preemphasis 0.97; 25 ms frames every 10 ms, the last one
zero-padded, rectangular window; power spectrum of 512 points; 26 HTK mel
filters snapped to FFT bins; log; DCT-II ortho, 13 coefficients; lifter 22;
c0 the log frame energy) plus the reference's delta and delta-delta over
+-2 frames with edge padding, rows past the last frame zero, padded to 256
rows; float64.

``forward``: SpeakerResBLSTM (a k4 stem; 3 stages of 3 residual units, the
first of each max-pooling its main path and projecting its shortcut with a
strided 1x1; BatchNorm, ReLU; average pooling by 4; a Keras bidirectional
LSTM; a dense head), keyed as ``param_spec`` names it.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.overlap import _batch_norm, _bn, _lstm, _same, bilstm

__all__ = ["param_spec", "features", "forward"]


def param_spec(m: dict, feat_dim: int = 39) -> "OrderedDict[str, tuple]":
    spec = OrderedDict()
    spec["trunk.stem.weight"] = ((m["stem_filters"], feat_dim,
                                  m["stem_kernel"]), "kernel")
    spec["trunk.stem.bias"] = ((m["stem_filters"],), "bias")
    ch, i = m["stem_filters"], 0
    for f in m["stage_filters"]:
        for b in range(m["blocks_per_stage"]):
            p = f"trunk.units.{i}."
            if b == 0:
                spec[p + "shortcut.weight"] = ((f, ch, 1), "kernel")
                spec[p + "shortcut.bias"] = ((f,), "bias")
            _bn(spec, p + "bn0.", ch)
            spec[p + "conv_a.weight"] = ((f, ch, 3), "kernel")
            spec[p + "conv_a.bias"] = ((f,), "bias")
            _bn(spec, p + "bn1.", f)
            spec[p + "conv_b.weight"] = ((f, f, 3), "kernel")
            spec[p + "conv_b.bias"] = ((f,), "bias")
            ch, i = f, i + 1
    _bn(spec, "trunk.bn.", ch)
    _lstm(spec, "trunk.bilstm.lstm.", ch, m["lstm_units"])
    spec["head.weight"] = ((m["head_units"], 2 * m["lstm_units"]), "kernel")
    spec["head.bias"] = ((m["head_units"],), "bias")
    return spec


def _filterbank(n_filt, n_fft, sr) -> np.ndarray:
    def hz2mel(hz):
        return 2595 * np.log10(1 + hz / 700.0)

    def mel2hz(mel):
        return 700 * (10 ** (mel / 2595.0) - 1)

    pts = np.linspace(hz2mel(0.0), hz2mel(sr / 2), n_filt + 2)
    bins = np.floor((n_fft + 1) * mel2hz(pts) / sr)
    fb = np.zeros((n_filt, n_fft // 2 + 1))
    for j in range(n_filt):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fb[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fb[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fb


def _delta(feat: torch.Tensor, N: int) -> torch.Tensor:
    T = feat.shape[0]
    pad = torch.cat([feat[:1].expand(N, -1), feat, feat[-1:].expand(N, -1)])
    num = sum(k * (pad[N + k: N + k + T] - pad[N - k: N - k + T])
              for k in range(1, N + 1))
    return num / (2 * sum(k * k for k in range(1, N + 1)))


@torch.no_grad()
def features(trimmed_i16: np.ndarray, kept: np.ndarray, feat: dict,
             device) -> torch.Tensor:
    """MFCC-39 rows ``(B, max_frames, 39)`` float32 of trimmed windows and
    their kept sample counts."""
    sr, nfft = feat["sample_rate"], feat["n_fft"]
    win = int(round(feat["win_ms"] / 1000 * sr))
    hop = int(round(feat["hop_ms"] / 1000 * sr))
    ncep, L, N = feat["n_cep"], feat["ceplifter"], feat["delta_n"]
    fb = torch.as_tensor(_filterbank(feat["n_filt"], nfft, sr), device=device)
    n_lift = torch.arange(ncep, dtype=torch.float64, device=device)
    lift = 1 + (L / 2.0) * torch.sin(np.pi * n_lift / L)
    k = torch.arange(ncep, dtype=torch.float64, device=device)[:, None]
    j = torch.arange(feat["n_filt"], dtype=torch.float64, device=device)
    nf = feat["n_filt"]
    dct = torch.cos(np.pi * k * (2 * j + 1) / (2.0 * nf)) * 2.0 * torch.where(
        k == 0, math.sqrt(1.0 / (4.0 * nf)), math.sqrt(1.0 / (2.0 * nf)))
    eps = float(np.finfo(np.float64).eps)
    out = torch.zeros((len(kept), feat["max_frames"], 3 * ncep),
                      dtype=torch.float64, device=device)
    for b, n in enumerate(kept.tolist()):
        sig = torch.as_tensor(trimmed_i16[b, :n].astype(np.float64),
                              device=device)
        if n == 0:
            sig = sig.new_zeros(1)
        sig = torch.cat([sig[:1], sig[1:] - feat["preemph"] * sig[:-1]])
        frames_n = 1 if len(sig) <= win else \
            1 + int(math.ceil((len(sig) - win) / hop))
        padded = F.pad(sig, (0, (frames_n - 1) * hop + win - len(sig)))
        frames = padded.unfold(0, win, hop)
        pspec = torch.fft.rfft(frames, nfft, dim=1).abs() ** 2 / nfft
        energy = pspec.sum(1)
        energy = torch.where(energy == 0, eps, energy)
        mel = pspec @ fb.T
        mel = torch.where(mel == 0, eps, mel)
        cep = (torch.log(mel) @ dct.T) * lift
        cep[:, 0] = torch.log(energy)
        d = _delta(cep, N)
        rows = torch.cat([cep, d, _delta(d, N)], dim=1)
        m = min(len(rows), feat["max_frames"])
        out[b, :m] = rows[:m]
    return out.to(torch.float32)


def forward(sd: dict, x: torch.Tensor, m: dict, rnd=_same) -> torch.Tensor:
    """Logits ``(B, head_units)`` of MFCC rows ``x (B, 256, 39)``; ``rnd``
    rounds each product's operands."""
    eps = m["bn_eps"]
    k = m["stem_kernel"]

    def conv(t, w, b, **kw):
        return F.conv1d(rnd(t), rnd(w), b, **kw)

    net = conv(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2)),
               sd["trunk.stem.weight"], sd["trunk.stem.bias"])
    i = 0
    for _ in m["stage_filters"]:
        for b in range(m["blocks_per_stage"]):
            p = f"trunk.units.{i}."
            res = net
            if b == 0:
                res = conv(net, sd[p + "shortcut.weight"],
                           sd[p + "shortcut.bias"], stride=2)
                net = F.max_pool1d(F.pad(net, (0, net.shape[-1] % 2),
                                         value=float("-inf")), 2, 2)
            out = conv(F.relu(_batch_norm(net, sd, p + "bn0.", eps)),
                       sd[p + "conv_a.weight"], sd[p + "conv_a.bias"],
                       padding=1)
            out = conv(F.relu(_batch_norm(out, sd, p + "bn1.", eps)),
                       sd[p + "conv_b.weight"], sd[p + "conv_b.bias"],
                       padding=1)
            net = res + out
            i += 1
    net = F.relu(_batch_norm(net, sd, "trunk.bn.", eps))
    net = F.avg_pool1d(net, m["avg_pool"])
    h = bilstm(net.transpose(1, 2), sd, "trunk.bilstm.lstm.", rnd)
    return rnd(h) @ rnd(sd["head.weight"]).T + sd["head.bias"]
