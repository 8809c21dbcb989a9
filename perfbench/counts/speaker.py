"""Counts of the speaker model (``SpeakerResBLSTM``) from its shapes."""

from __future__ import annotations

from perfbench.counts import lstm, pool


def model_flops(model: dict, feature: dict) -> float:
    """Forward FLOPs of one window: convolutions, the bidirectional LSTM
    and the head (multiply-adds as two)."""
    L = feature["max_frames"]
    d = 3 * feature["n_cep"]
    ch = model["stem_filters"]
    flop = 2 * d * ch * model["stem_kernel"] * L
    for f in model["stage_filters"]:
        Lo = pool(L)
        flop += 2 * ch * f * Lo                            # strided shortcut
        flop += 2 * 3 * ch * f * Lo + 2 * 3 * f * f * Lo
        flop += (model["blocks_per_stage"] - 1) * 2 * (2 * 3 * f * f * Lo)
        L, ch = Lo, f
    T = L // model["avg_pool"]
    flop += lstm(ch, model["lstm_units"], T)
    return float(flop + 2 * 2 * model["lstm_units"] * model["head_units"])
