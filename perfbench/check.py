"""The comparison that decides ``correct``.

For each sampled stream the reference replays the stream's windows from
its first, in order: the chain (``reference/chain.py``, each stream's
detector state carried in its own row), then the model's input and logits
(``reference/<kind>.py``).  It replays the detector twice a stream: on its
own denoised windows, and on the program's.  The windows compared are the
first ``check_windows`` that the program served of each sampled stream
once the measured window opened; what the program produced for them (the
denoised window, the trimmed window its featurizer was given, the model
input, the logits) was kept by the tap (``system.Tap``), and the label by
the stream's log.  Each stage is held on the program's own input to it,
so that a one-step rounding difference in one stage cannot carry into the
next as a difference of the program's.

Numbers, each held to the configuration's ``limits``:

* ``missing``: windows due in the measured window never labelled, even a
  minute after it closed (one labelled late is late: the result's
  ``failed`` counts those not labelled within the grace).
* ``denoise_mismatch``: the share of compared windows whose denoised
  samples (the detector's input) lie more than one int16 step from the
  reference's float64 denoise of the same raw window anywhere: the
  denoise (D1, D2, the gate and the PCM16 round trip) alone.  One step is
  the PCM16 rounding of float32 against float64; a spectral bin that lies
  on the gate's threshold to float32's precision can flip the gate and
  move a rare window by more (up to 16 steps in 6,144 sound windows), so
  this is a share of windows, and the largest gap (``denoise_gap``) is
  printed, not held.
* ``trim_mismatch``: compared windows in which the reference's detector,
  collector and trim, run over the program's own denoised windows from
  the stream's first with the reference's own carried state, do not give
  exactly the program's: its silent status, and the trimmed samples (and
  count) its featurizer was given.  The detector is integer arithmetic,
  so on the same input the two agree bit for bit: an exact count.
* ``input_mismatch`` (printed, not held): the share of compared windows
  whose model input is not that of the reference's own chain from the raw
  window, end to end.  Inputs agree when both sides call the window
  silent, or neither does and the input is the reference's up to rounding
  (the kind's ``inputs_agree``: the image, no pixel a level off by more
  than one and at most ``pixel_share`` of them off; MFCC rows, within
  ``feature_rtol`` of the largest).  A one-step int16 difference left by
  the denoise can flip a detector frame, and the carried detector state
  then differs for windows after it: on a sound program it read up to
  0.125 of a stream's 32 windows, against 0.19 with the detector's state
  never carried, so it cannot separate the two.
* ``feature_mismatch``: the share of windows the program did not call
  silent whose model input is not the reference's input of the same
  trimmed window the program's featurizer was given: the featurizer alone,
  on every window, where no trim can differ.
* ``logit_gap``: the median of each window's largest logit difference from
  the reference, as a share of the median window's largest reference
  logit, over the windows that neither side calls silent.  With
  ``model_on: program_input`` the reference's logits are of the program's
  own model input, every such window; otherwise of the reference's, on the
  windows whose inputs agree.  The overlap image is truncated to whole
  levels, float32 against float64 moves ~10 pixels of an image by one
  level, and the model turns one level into a logit difference larger
  than its own rounding: so the overlap model is judged on the program's
  image, which ``feature_mismatch`` holds.  The largest difference
  (``logit_gap_max``) is printed, not held.
* ``rounding_ratio`` (with a ``yardstick`` precision in the limits): that
  median difference over the median difference of the reference itself
  computed at the yardstick precision, the precision the configuration
  states for each part of the model.  How far rounding carries through the
  model changes with the seed's weights, ten-fold between seeds; the ratio
  divides it out: a sound program reads about 1 or less.
* ``b3_gap``: for the fused residual blocks (kernel B3) of the first
  ``BLOCK_WINDOWS`` compared windows, the largest difference of the
  block's output from the reference block's in fp32 on the same input,
  over the reference's largest: the precision the configuration states
  for B3 (3xTF32, fp32 to rounding) held where it runs, which the logits
  cannot separate from one TF32 pass.
* ``label_mismatch``: windows the model is judged on whose logged label is
  not the reference's where the reference's top two logits lie more than
  twice the window's logit difference apart, so that the program's logits
  cannot order them otherwise: the label then follows from the logits.

``control`` computes the same numbers for the reference itself put in the
program's place at the precision below the configuration's (its denoise
too, each stage rounded to that precision).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference import chain

__all__ = ["Ref", "replay", "compare", "numbers_line"]

REFERENCE = "reference"   # a featurizer input that is the reference's own


class Ref(NamedTuple):
    """The reference's readings of one compared window."""
    x: torch.Tensor          # model input of its own chain from the raw
    kept: int                # kept samples of its own chain
    trimmed: np.ndarray      # its detector and trim of the program's
    stage_kept: int          # denoised window, and the kept samples
    den_gap: float           # the program's denoise against its own, in
    #                          int16 steps (inf: the tap never saw it)


def _raws(run, rows, j: int, n_win: int) -> np.ndarray:
    """Raw window ``j`` of each stream in ``rows``."""
    return np.stack([run.pool.samples(run.audio[s][0],
                                      run.audio[s][1] + j * n_win, n_win)
                     for s in rows])


def _thresholds(system, run, rows) -> torch.Tensor:
    """The reference's gate threshold of each stream in ``rows``."""
    dev = system.device
    by_profile = {p: chain.noise_threshold(run.pool.noise[p], dev)
                  for p in set(run.noise[s] for s in rows)}
    return torch.stack([by_profile[run.noise[s]] for s in rows])


def replay(system, run, n_win: int) -> dict:
    """The reference's readings of every compared window:
    ``{(stream, index): Ref}``."""
    tap = run.tap
    want = {}
    for s in run.sampled:
        first = tap.first.get(s)
        if first is None:
            continue
        for j in range(first, min(first + tap.K, tap.count[s])):
            want.setdefault(s, set()).add(j)
    if not want:
        return {}
    rows = sorted(want)
    R = len(rows)
    steps = max(max(js) for js in want.values()) + 1
    thresh = _thresholds(system, run, rows)
    # two detector rows a stream: r runs the reference's own chain, R + r
    # the reference's detector on the program's denoised windows
    det = chain.WebRtcRows(2 * R, system.cfg.vad.aggressiveness)
    own, stage, gaps, keys = [], [], [], []
    for j in range(steps):
        live = [i for i, s in enumerate(rows) if j <= max(want[s])]
        den = chain.denoise(_raws(run, [rows[i] for i in live], j, n_win),
                            thresh[live], system.device)
        prog = den.copy()
        seen = []
        for r, i in enumerate(live):
            d = tap.denoised.get((rows[i], j))
            seen.append(d is not None)
            if d is not None:
                prog[r] = d.numpy()
        pick = live + [R + i for i in live]
        sub = det.take(pick)
        tr, kp = chain.detect_trim(np.concatenate([den, prog]), sub)
        det.put(pick, sub)
        L = len(live)
        for r, i in enumerate(live):
            if j in want[rows[i]]:
                keys.append((rows[i], j))
                own.append((tr[r], int(kp[r])))
                stage.append((tr[L + r], int(kp[L + r])))
                gaps.append(float(np.abs(prog[r].astype(np.int32)
                                         - den[r]).max())
                            if seen[r] else math.inf)
    trimmed = np.stack([t for t, _ in own])
    kept = np.asarray([k for _, k in own])
    xs = []
    for a in range(0, len(keys), 64):
        xs.append(system.ref_inputs(trimmed[a: a + 64], kept[a: a + 64]))
    x = torch.cat(xs)
    return {k: Ref(x[i], own[i][1], stage[i][0], stage[i][1], gaps[i])
            for i, k in enumerate(keys)}


def _trim_agrees(system, r: Ref, silent_p: bool, fin) -> bool:
    """The program's silent status and its featurizer's input are what the
    reference's detector and trim make of the program's denoised window."""
    if fin is REFERENCE:
        return True
    if silent_p != (r.stage_kept < system.silent_samples):
        return False
    if fin is None:                    # the tap never saw its featurizer
        return silent_p
    samples, kept = system.program_trimmed(fin)
    return bool((kept is None or kept == r.stage_kept)
                and np.array_equal(samples, r.trimmed[: len(samples)]))


def compare(system, run, ref: dict, limits: dict, produced=None,
            block_precision=None, den_gaps=None) -> list:
    """``[(name, value, limit)]``; ``produced`` maps each compared window to
    ``(x, logits, label, featurizer input)`` (default: what the program
    produced);
    ``block_precision``: the reference's fused blocks at that precision in
    the program's place; ``den_gaps``: each window's denoise gap of what
    stands in the program's place (default: the program's)."""
    tap = run.tap
    keys = sorted(ref)
    if produced is None:
        produced = {}
        for (s, j) in keys:
            x, lg, fin = tap.kept[(s, j)]
            labels = run.labels.get(s, [])
            produced[(s, j)] = (x, lg, labels[j] if j < len(labels)
                                else None, fin)
    dev = system.device
    xr = torch.stack([ref[k].x for k in keys])
    silent_e = [ref[k].kept < system.silent_samples for k in keys]
    silent_r = [ref[k].stage_kept < system.silent_samples for k in keys]
    silent_p = [produced[k][2] == "silent" for k in keys]
    # the denoise alone, on the raw window
    gaps_d = [ref[k].den_gap for k in keys] if den_gaps is None \
        else [den_gaps[k] for k in keys]
    # the detector, collector and trim alone, on the program's denoised
    # windows
    trim_bad = sum(not _trim_agrees(system, ref[k], silent_p[i],
                                    produced[k][3])
                   for i, k in enumerate(keys))
    # the whole chain and the featurizer (printed): the program's model
    # input against the reference's from the reference's own chain
    agree = [se == sp and (se or system.inputs_agree(
        produced[k][0].float().cpu(), xr[i].cpu(), limits))
        for i, (k, se, sp) in enumerate(zip(keys, silent_e, silent_p))]
    # the featurizer alone, on every window the program did not call
    # silent: its model input against the reference's of the same trimmed
    # window the program's featurizer was given (a window whose featurizer
    # input the tap never saw does not agree; ``REFERENCE``: the control's
    # own featurizer, which agrees)
    fk = [i for i, k in enumerate(keys) if not silent_p[i]
          and produced[k][3] is not None and produced[k][3] is not REFERENCE]
    feat_bad = sum(1 for i, k in enumerate(keys)
                   if not silent_p[i] and produced[k][3] is None)
    n_feat = feat_bad + len(fk) + sum(
        1 for i, k in enumerate(keys)
        if not silent_p[i] and produced[k][3] is REFERENCE)
    for a in range(0, len(fk), 64):
        part = fk[a: a + 64]
        xf = system.ref_inputs_of_program(
            [produced[keys[i]][3] for i in part]).float().cpu()
        feat_bad += sum(not system.inputs_agree(
            produced[keys[i]][0].float().cpu(), xf[r], limits)
            for r, i in enumerate(part))
    # the model: on the reference's inputs where they agree, or, with
    # ``model_on: program_input``, on the program's own input of every
    # window that neither side calls silent
    on_program = limits.get("model_on") == "program_input"
    mk = [i for i in range(len(keys)) if not silent_r[i] and not silent_p[i]
          and (on_program or agree[i])]
    gaps, scales, wrong, ygaps = [], [], [], []
    if mk:
        xm = torch.stack([produced[keys[i]][0].float().cpu()
                          if on_program else xr[i].cpu() for i in mk])
        lr = system.ref_logits(xm.to(dev), "fp32").float().cpu()
        yard = limits.get("yardstick")
        ly = system.ref_logits(xm.to(dev), yard).float().cpu() \
            if yard else None
        for r, i in enumerate(mk):
            _, lp, label, _ = produced[keys[i]]
            gap = float((lp.float().cpu() - lr[r]).abs().max())
            gaps.append(gap)
            if ly is not None:
                ygaps.append(float((ly[r] - lr[r]).abs().max()))
            scales.append(float(lr[r].abs().max()))
            # logits within ``gap`` of the reference's keep its argmax
            # where its top two lie more than twice that apart
            top = torch.topk(lr[r], 2).values if lr.shape[1] > 1 else None
            clear = top is None or float(top[0] - top[1]) > 2.0 * gap
            name = system.label_name(int(torch.argmax(lr[r])))
            wrong.append(clear and label != name)
    n = len(keys)
    nan = float("nan")
    gap = gap_max = ratio = nan
    if gaps and np.median(scales) > 0:
        gap = float(np.median(gaps) / np.median(scales))
        gap_max = float(max(gaps) / np.median(scales))
    if ygaps and np.median(ygaps) > 0:
        ratio = float(np.median(gaps) / np.median(ygaps))
    # the fused block (B3) on the inputs the program gave it; on the CPU
    # the model runs no fused block, and there is nothing to compare
    bg = system.block_gaps(tap.blocks, block_precision)
    b3 = max(bg) if bg else nan
    if not bg and system.device.type != "cuda":
        b3 = None
    numbers = [("missing", run.missing),
               ("denoise_mismatch",
                sum(g > 1 for g in gaps_d) / n if n else nan),
               ("trim_mismatch", int(trim_bad) if n else nan),
               ("denoise_gap", max(gaps_d) if gaps_d else nan),
               ("input_mismatch", 1.0 - sum(agree) / n if n else 1.0),
               ("feature_mismatch", feat_bad / n_feat if n_feat else nan),
               ("logit_gap", gap), ("rounding_ratio", ratio),
               ("label_mismatch", int(sum(wrong))),
               ("b3_gap", b3),
               ("compared", len(gaps)), ("logit_gap_max", gap_max)]
    # held where the configuration gives a limit; the rest are printed
    return [(name, v, limits.get(name)) for name, v in numbers
            if v is not None and (name in limits or v == v)]


def passed(numbers) -> bool:
    """Every number within its limit (``compared`` is a floor)."""
    for name, value, limit in numbers:
        if limit is None:                      # printed, not held
            continue
        if value is None or value != value:    # nothing to compare
            return False
        if name == "compared":
            if value < limit:
                return False
        elif value > limit:
            return False
    return True


def control(system, run, ref: dict, limits: dict, precision: str) -> list:
    """The numbers of the reference put in the program's place at
    ``precision``: its denoise and logits at that precision, its own
    detector, trim and inputs, its labels; no window missing."""
    keys = sorted(ref)
    xr = torch.stack([ref[k].x for k in keys]).to(system.device)
    lc = system.ref_logits(xr, precision).float().cpu()
    produced = {}
    for i, k in enumerate(keys):
        silent = ref[k].kept < system.silent_samples
        produced[k] = (xr[i].cpu(), lc[i], "silent" if silent else
                       system.label_name(int(torch.argmax(lc[i]))),
                       REFERENCE)
    n_win = system.cfg.audio.window_samples
    den_gaps = {}
    for a in range(0, len(keys), 64):
        part = keys[a: a + 64]
        raws = np.stack([_raws(run, [s], j, n_win)[0] for s, j in part])
        thresh = _thresholds(system, run, [s for s, _ in part])
        exact = chain.denoise(raws, thresh, system.device)
        low = chain.denoise(raws, thresh, system.device,
                            rnd=chain.ROUND[precision])
        for r, k in enumerate(part):
            den_gaps[k] = float(np.abs(low[r].astype(np.int32)
                                       - exact[r]).max())
    saved, run.missing = run.missing, 0
    try:
        return compare(system, run, ref, limits, produced, precision,
                       den_gaps)
    finally:
        run.missing = saved


def numbers_line(numbers) -> str:
    return ", ".join((f"{n} {v:.6g}" if isinstance(v, float)
                      else f"{n} {v}")
                     + ("" if lim is None else f" (limit {lim})")
                     for n, v, lim in numbers)
