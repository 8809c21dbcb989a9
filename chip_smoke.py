"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mmla_audio_torch/csrc`` (one nvcc
per source, all at once), then:

0. the denoise kernels (``csrc/denoise.cu``): D1, the STFT and ISTFT as
   a 1024-point real FFT a frame, and D2, the banded mask smoothing,
   against their plain versions (``torch.matmul``, TF32 off, within 2e-5
   of max |ref|; the dense matrix pair within 1e-6; D1 also within 1e-7
   of max |ref| of the same products in float64) at live windows (T =
   183 frames) of B = 1, 8, 64 and 512 and on the 12-minute file (T =
   45,023), each timed (CUDA events) beside its plain version and the
   library calls (cuFFT ``torch.fft.rfft`` and ``irfft`` of the same
   frames and spectra, and cuBLAS ``torch.matmul`` of the dense products
   as written; cuDNN ``conv2d`` with the outer-product kernel), and at
   B <= 512 each on the card alone (``queued_ms``), D2 and ``conv2d``
   also on the 12-minute file, beside an empty kernel queued the same way
   (the launch floor) and cuFFT's float64 pair, D1's working precision
   (D2 must beat the dense pair and ``conv2d`` at every shape);
   ``reduce_noise`` at each batch equal to every
   window denoised alone (0 differing float samples) and, after int16
   quantization, within 1 step on < 0.5 % of samples of the plain chain
   in float64 (and on < 0.5 % of the fp32 plain chain);
   then a 60-minute file at ``passes_post`` through the kernels alone:
   time, peak allocated memory (under 10 GB; its dense time matrix alone
   would be 202.5 GB), a finite output (its windows are not labeled);
1. featurizer: kernel vs its plain PyTorch version on the card at B=1 (a
   live window), 64, 200 and 480 (the post-time conversations) seeded
   windows (|diff| <= 1 quantization step on < 2 % of pixels), with
   CUDA-event timings of both and, as a yardstick for the FFT stage alone,
   of ``torch.fft.rfft`` of the same windowed frames at B=480 (the port
   never calls it);
   the three windows whose half has a prime factor without a written-out
   butterfly (14 kHz and 22 kHz at 25 ms, ``win_ms=25.5`` at 16 kHz: the
   generic radix stage) at B=64, within the same budget, timed;
   grouped: ``group=4`` on B=6 (a partial group) and ``group=2`` on
   ``time_dim=151`` (152 frames), each bit-equal to ``group=1``; at B=200,
   480, 1024 and 2400 every group bit-equal to ``group=1``, within the
   budget of the plain version, and CUDA-event timings of each group and
   the plain version beside the wrapper's pick (G=1 at every batch);
2. fused residual block: the tensor-core kernel (every width with C % 8 ==
   0) vs ``fused_resblock_plain`` at the three non-pooling shapes of the
   full-width model, B=1, 64, 200 and 480 (the last two are the post-time
   batches), and the FFMA kernel (C % 8 != 0) at C=12, TF32 off, max |diff|
   <= 1e-4 * max |ref|; CUDA-event timings of the kernel, the plain version
   and the unfused ``ResBlock2D`` (cuDNN, the yardstick);
3. predictor: the full-width default ``OverlapModelConfig()`` with weights
   from a seeded numpy tree through ``params.py``; B=8 on the card vs the
   same predictor on the CPU, TF32 off;
4. session: ``OverlapSession`` on the card over 4 windows (one all zeros),
   in its default arrangement (``host_preprocess="auto"``, which keeps the
   chain on the card: D1 2 and D2 1 a window and pass, D1 once for the
   noise profile), a main path whose kernel launches are counted; the same
   session on the CPU must give the same labels; window-to-decision p50 and
   p90 of that arrangement and of the host split (``host_preprocess=True``:
   denoise, decisions and trim on the CPU) over the same windows, in turns;
5. post-time: ``overlap_post_analyze`` over a 5-minute ``audio*`` recording
   (3 denoise passes, 200 windows) and a 12-minute ``zoom*`` one (480
   windows), the other main path whose launches are counted (the
   featurizer at G=1, one launch a conversation, and the fused block on
   the tensor cores), on the card and on the CPU; labels equal where the CPU's top-2
   margin is above 1e-3; windows per second on the host clock; then the
   CLI's ``overlap-post --weights``;
6. CLI: ``python -m mmla_audio_torch.cli overlap-run -f <wav>``;
7. speaker identification at the full width of ``SpeakerModelConfig()``
   (weights from a seeded numpy tree through ``params.py``), a main path
   that must launch none of the kernels above but the denoise's:
   ``SpeakerPredictor`` at B=1
   and B=64 on the card vs the CPU (labels equal where the CPU's top-2
   logit margin is above 1e-3, logits within 1e-3 of their largest
   magnitude), the model's forward time at B=1 and B=282 with TF32 off
   (the policy) and allowed (for information); ``SpeakerSession`` over 10
   windows on the card and the CPU (the same margin rule) and its
   window-to-decision p50 and p90 beside the host split's; ``speaker_post_analyze`` over the two
   recordings of phase 5 with a 3-speaker corpus (118 and 282 windows),
   card twice (cold, warm) then CPU, rows equal under the margin rule,
   windows per second and the whole-file MFCC's CUDA-event time; then the
   CLI's ``speaker-post --weights`` in a fresh process;
8. speaker training at the same width from phase 7's seeded base tree
   (630-way head), a path that must launch none of the kernels but the
   denoise's: three
   seeded synthetic voices of 60 s enrolled through
   ``SpeakerSession.register_speaker`` in the session's default
   arrangement; ``TransferLearner.fit_once`` at the default
   ``TransferConfig`` (500 + 20 epochs, b16 / b8) on the card (cold, then
   warm) and on the CPU, the same split, head init and permutations
   (labels equal where the CPU's top-2 logit margin is above 1e-3, logits
   within ``TRANSFER_DRIFT`` of their largest magnitude; val accuracy is
   printed, not compared: a row under the margin may flip it), and at
   500 + 1 epochs on both (logits within 1e-3); phase
   wall times on the host clock and the phase-2 step time from CUDA
   events; ``train_on_registered`` on the card and 5 identified windows;
   pretrain: 3 ``Trainer`` steps at b32 on 256 synthetic clips card vs CPU
   with dropout 0 (losses within 1e-4 relative, parameters within 1e-3 of
   each leaf's largest magnitude, trunk conv biases, whose exact gradient
   is zero, within RMSprop's noise bound), then two epochs timed on the
   card with dropout on; the CLI's ``speaker-pretrain`` -> ``speaker-live
   --fake --register a b`` -> ``speaker-post --weights
   experiment/model/variables.npz``, each in a fresh process;
9. overlap training at the full width of ``OverlapModelConfig()`` on the
   reference's corpus composition, the other main path whose launches are
   counted: 630 seeded voices cut into 6,300 single 1.5 s clips and 6,300
   ``synthesize_corpus`` mixtures of them, the featurizer kernel over all
   12,600 windows in one call (held against the plain version on 256 of
   them), ``OverlapTrainer.train`` for two epochs at b32 with the fused
   block launched only by each epoch's validation (6 blocks x 5 chunks),
   none by a train step; CUDA-event featurize and step times, epoch and
   validation times, peak memory and a ``torch.profiler`` window of 10
   steps (device busy, idle share, launches); 3 train steps card vs CPU
   with dropout 0 on the card's features (losses within 1e-4 relative,
   parameters within 1e-3 of each leaf's largest magnitude, the conv0
   biases, whose exact gradient is zero, within Adadelta's noise bound),
   an evaluation of 512 windows, fused on the card vs unfused on the CPU
   (labels equal under the margin rule), ``augment_to_balance`` of a 2:1
   subset card vs CPU; the CLI's ``synth-corpus`` (512 mixtures of 1,024
   corpus clips) -> ``overlap-train --epochs 3 --augmented --out D`` ->
   ``overlap-post --weights D/variables.npz`` of phase 5's 5-minute
   recording, its labels equal to the CPU's of the same checkpoint under
   the margin rule;
10. the multiplexer (``streaming/multiplex.py``) at full width, on seeded
   weights and synthetic speech with silences, ``decision="webrtc"``,
   buckets (8, 64): W1 (``webrtc_vad_rows``) against the host engine on the
   same denoised int16 windows and starting rows (64 rows carrying 3
   windows of state, one fresh row, 3 padding rows), 4 windows in a row at
   B=8 and 64, decisions and every state row bit for bit; W1 timed at B=1,
   8, 64 and 512 (CUDA events) beside the host engine over the same rows
   (host clock); W2 (``vad_collect_rows``) against ``collect_mask`` per row
   on W1's and energy decisions, then at B=1, 8, 64 and 512 checked and
   timed (CUDA events and on the card alone, beside the launch floor);
   8 overlap streams x 4
   windows against ``OverlapSession`` and 4 speaker streams (3-speaker
   sigmoid head) against ``SpeakerSession`` (each with its chain on the
   card): labels equal where the session's top-2 margin is above 1e-3, the
   batched denoise equal to the single-window one in every int16 sample,
   each detector row equal to the host engine over those windows and to
   the session's own engine; 64 threaded ``CaptureThread`` streams x
   8 windows, then 512 ``PrefilledCapture`` streams x 4 windows: windows/s,
   ms a window, realtime-stream equivalents, the phase times a window, the
   kernels' launches, every window logged once and in order; one warm tick
   at bucket 64 traced by the port's ``utils.timers.device_trace`` (device
   busy, idle share, launches, D1's and D2's kernels by name; the Chrome
   trace it writes must name W1's kernel), then D1's two kernels and D2
   at the tick's shape timed by CUDA events, on the card alone and by the
   profiler over the same calls; the log appends (``resolve_log`` a
   window) with the handle LRU and with a copy of the earlier
   open-per-write log, in turns, at 64 prefilled streams x 8 windows and
   512 x 4, the descriptors an LRU run leaves open within the cap of 128;
   churn: 16 streams, 8 retired with ``archive=False`` (their log handles
   closed, the open descriptors within the baseline + 128) and 8 added on
   recycled rows that start fresh and end equal to a fresh multiplexer's.
   The multiplexer's runs are the fourth main path whose launches are
   counted (W1, W2, the featurizer, the fused block, D1, D2);
10b. the mesh (``Multiplexer(mesh=)``): 64 prefilled streams x 4 windows
   at bucket 64 and full width through ``mesh=None``, ``make_mesh()`` (one
   card) and a mesh listing the card twice (each batch split in two), in
   turns: labels and the stacked webrtcvad rows equal across all three,
   the one-card mesh the same launches as ``mesh=None``, the split mesh
   exactly twice each kernel's, windows/s of each (its launches join the
   counted main path's);
10c. distributed: ``parallel.distributed.initialize`` with NCCL at world
   size 1 (``process_info() == (0, 1)``), ``Trainer.fit(mesh=
   global_mesh())`` for one epoch at the full width of
   ``SpeakerModelConfig()`` (3-way head, batch 8, SGD) against
   ``mesh=None`` from the same weights, history and every parameter and
   statistic within rtol 1e-4 / atol 1e-5 (the CPU test's), each step
   timed by CUDA events with and without the mesh; the group destroyed
   after;
11. edge, export and weights: ``EdgeOverlapSession.run`` over 8 windows
   (3 noise-only, where the SSIM gate fires) on the card and the CPU,
   labels equal where the CPU's top-2 margin is above 1e-3 and its SSIM
   more than 1e-4 from the threshold, B1 launched once and B3 six times a
   window, D1 and D2 at 4 passes a window, window-to-decision p50;
   ``EdgeSpeakerSession`` at full width enrolling three voices behind a
   gate that starts released (the capture created suspended), a 5 + 1
   epoch fine-tune, then 6 windows identified through the captured CUDA
   graph, labels equal to an eager ``SpeakerSession``'s under the margin
   rule; ``aot_compile(OverlapPredictor.predict)`` at B=8 (argmax equal to
   eager, B=4 refused, eager and replay timed, the captured launches
   counted: replays run them unseen by the counters); a full-width
   synthetic SavedModel of each model kind (``tests/golden/
   tfbundle_writer.py``) loaded with ``convert.load_checkpoint_state_dict``
   bit for bit equal to ``params.py``'s state dict, predictions equal; the
   CLI's ``overlap-live --fake --edge``, ``speaker-live --fake --edge``,
   ``overlap-live --fake --host-preprocess``, ``overlap-run --parity`` and
   ``overlap-post --ckpt D`` (``D`` from ``export_serving``) in fresh
   processes started together.  The edge sessions' runs are the fifth main
   path whose launches are counted.

The line before the last is a JSON object describing each kernel, with its
bound: the larger of its bytes (each input read once, each output written
once) over 3.35 TB/s and its fp32 FLOPs as 3xTF32 on the tensor cores (three
TF32 products for each fp32 one at 495 TFLOP/s, 165 TFLOP/s of fp32 work,
faster than the CUDA cores' 67 TFLOP/s), H100 SXM peaks.  D1's entry
sums the STFT and the ISTFT of one pass at B=64, the multiplexer's
bucket, as does D2's; its library call is cuFFT's pair.  The featurizer's
FLOPs are the least its function needs too (a real FFT per frame, the
banded mel product), not the dense GEMMs of the TPU kernel, whose bound
the featurizer's log lines print beside it.  W1 and W2 are integer state
machines: their bound is their bytes, far below the serial dependency
chain that bounds them in fact (W1's log lines print that floor beside
it, ``w1_chain_ms``).  The last line is
``{"ok": true, "device": {...}}``.  Any failure raises, so nothing after it
is printed and the exit code is not 0.  Without a CUDA device the script
stops before doing anything.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BUDGET_STEP, BUDGET_SHARE = 1.0, 0.02      # featurizer pixel budget
TOP2_MARGIN, PROB_ATOL = 1e-3, 1e-4        # predictor card vs CPU
LOGIT_RTOL = 1e-3                          # speaker logits: of max |ref|
BLOCK_RTOL = 1e-4                          # fused block: of max |ref|
# windows whose half has a prime factor of 7, 17 or 11: the generic stage
GENERIC_GEOMETRIES = (dict(sample_rate=14000), dict(win_ms=25.5),
                      dict(sample_rate=22000))
SPEAKERS = ("alice", "bob", "carol")       # the post phase's corpus
# non-pooling ResBlock2D shapes of the full-width model: (C, H, W)
BLOCK_SHAPES = ((32, 64, 76), (64, 32, 38), (128, 16, 19))
# post-time recordings: name -> (seconds, windows); each is one batch
RECORDINGS = {"audio_conv0": (300, 200), "zoom_conv1": (720, 480)}
POST_BATCHES = tuple(n for _, n in RECORDINGS.values())
# phase 8: registration (voices of SPEAKERS, then identify windows of these
# voices) and pretrain (b32 steps card vs CPU)
ENROLL_SECONDS = 60.0
IDENTIFY_VOICES = (0, 1, 2, 0, 1)
PRETRAIN_CLIPS, PRETRAIN_SPEAKERS, PRETRAIN_STEPS = 256, 64, 3
# registration card vs CPU after the default 500 + 20 epochs, of max
# |logit|: phase 2's RMSprop steps amplify rounding differences (on the CPU
# alone a 1e-7 input perturbation grows to ~3e-4: scripts/
# transfer_sensitivity.py); after 500 + 1 epochs LOGIT_RTOL holds
TRANSFER_DRIFT = 5e-2
TRAIN_LOSS_RTOL = 1e-4                     # pretrain losses card vs CPU
PARAM_RTOL = 1e-3                          # of each leaf's max |value|
# phase 9: overlap training on the reference's corpus composition (630
# voices x 10 clips = 6,300 singles, and 6,300 mixtures of them), its
# card-vs-CPU checks and its CLI
OVERLAP_SPEAKERS, OVERLAP_CLIPS, OVERLAP_EPOCHS = 630, 10, 2
OVERLAP_STEPS, EVAL_WINDOWS, FEATURE_CHECK, PROFILE_STEPS = 3, 512, 256, 10
CLI_SINGLES, CLI_MIXTURES, CLI_EPOCHS = 1024, 512, 3
# phase 10: the multiplexer.  W1/W2 checks: rows carrying VAD_WARMUP windows
# of state, VAD_WINDOWS windows in a row; W1 timed at W1_BATCHES; labels of
# MUX_LABEL_STREAMS (overlap) and MUX_SPEAKER_STREAMS (speaker) streams
# against single-stream sessions; serving MUX_THREADED threaded captures and
# MUX_PREFILLED prefilled ones; churn of MUX_CHURN streams
VAD_FRAME, VAD_T = 480, 85
VAD_ROWS, VAD_WARMUP, VAD_WINDOWS = 64, 3, 4
W1_BATCHES = (1, 8, 64, 512)
W1_STEP_OPS, INT_LATENCY = 6, 4            # W1's chain bound (w1_chain_ms)
MUX_LABEL_STREAMS, MUX_SPEAKER_STREAMS, MUX_LABEL_WINDOWS = 8, 4, 4
MUX_THREADED, MUX_THREADED_WINDOWS = 64, 8
MUX_PREFILLED, MUX_PREFILLED_WINDOWS = 512, 4
MUX_CHURN = 16
# phase 10's log appends: resolve_log a window at 64 streams (which fit in
# the handle LRU) and 512 (which cycle through it), the handle LRU against
# a log that opens its file on every write, in turns; open descriptors at
# most the LRU's cap over the baseline, plus FD_SLACK
LOG_CASES = ((64, 8), (512, 4))
LOG_TURNS = ("lru", "open per write", "open per write", "lru")
MAX_OPEN_HANDLES, FD_SLACK = 128, 16
# phase 10b, the mesh: MESH_STREAMS x MESH_WINDOWS through mesh=None, a
# one-card mesh and a mesh listing the card twice, at bucket MESH_BUCKET,
# in turns
MESH_STREAMS, MESH_WINDOWS, MESH_BUCKET = 64, 4, 64
MESH_TURNS = ("mesh=None", "make_mesh()", "card twice", "card twice",
              "make_mesh()", "mesh=None")
# phase 10c, distributed: Trainer.fit at world size 1 (NCCL) against
# mesh=None, one epoch of DIST_ROWS seeded rows at the registration's
# phase-2 batch with a DIST_SPEAKERS-way head, SGD at DIST_LR (no
# preconditioner to amplify rounding), held at the CPU test's rtol/atol
DIST_ROWS, DIST_BATCH, DIST_SPEAKERS, DIST_LR = 64, 8, 3, 1e-3
DIST_RTOL, DIST_ATOL = 1e-4, 1e-5
# phase 10d, tensor parallelism: two gloo processes on the one card, a (1,
# 2) mesh, TP_EPOCHS epochs of phase 10c's fit with SGD's momentum (so that
# the optimizer has a state to split) against mesh=None (cuDNN in its
# deterministic algorithms in both, so that the runs differ only by the
# split), held at TP_RTOL / TP_ATOL
TP_EPOCHS, TP_RTOL, TP_ATOL, TP_TIMEOUT = 3, 1e-5, 1e-6, 600
TP_MOMENTUM = 0.9                          # SGD's state: a buffer a value
# phase 12, the GMM VAD: G1 against the plain frame loop at GMM_BATCHES rows
# of VAD_T frames (decisions equal where the plain run's margins exceed
# GMM_MARGIN, final states within GMM_STATE_ATOL on rows whose decisions
# all agree); preprocess_window(gmm_state=) over GMM_WINDOWS windows at
# B=1 in turns with the webrtc and energy decisions; GMM_CHECK of them
# through gmm_vad on the card against the plain loop on the CPU.  G1's
# chain bound: VAD_T frames x G1_FRAME_OPS dependent operations (read from
# csrc/gmm_vad.cu, g1_chain_ms) of FP32_LATENCY cycles; its operations
# bound at the CUDA cores' fp32 rate (no tensor-core form), G1_BAND_OPS a
# band a frame
GMM_BATCHES, GMM_WINDOWS, GMM_CHECK = (1, 8, 64), 60, 8
GMM_MARGIN, GMM_STATE_ATOL = 1e-3, 1e-5
G1_FRAME_OPS, FP32_LATENCY, G1_BAND_OPS = 37, 4, 100
FP32_CORE_FLOP_S = 67e12
# phase 0: the denoise kernels at live windows (T = 183 frames) of these
# batches and on the 12-minute file; D1 of max |ref| (fp32 sums of 1,024 or
# 1,026 terms in two orders), D2 absolute (mask values in [0, 1], sums of
# 33 + 7 taps); D1 against the same products in float64 (it computes in
# float64 and rounds each output once to fp32, at most 2^-24 of max |ref|);
# reduce_noise after int16 quantization vs the plain chain in float64 (the
# exact chain); a 60-minute file through the kernels, its peak allocated
# memory bounded
DENOISE_BATCHES = (1, 8, 64, 512)
ARRANGEMENT_ROUNDS = 20                    # x the windows, each arrangement
D1_RTOL, D2_ATOL = 2e-5, 1e-6
D1_EXACT = 1e-7
# the library yardstick of D2 (cuDNN may pick an FFT or Winograd algorithm)
# is held only to show that it computes the same function
D2_LIB_ATOL = 1e-5
DN_STEP, DN_SHARE = 1.0, 0.005
# queued_ms's sleep kernel: ~10 ms at the H100's 1,980 MHz
QUEUE_SLEEP_CYCLES = 20_000_000
HOUR_SECONDS, HOUR_PEAK_BYTES = 3600, 10e9
# phase 11: the edge sessions (windows, of them noise-only; labels compared
# where the CPU's SSIM is further than SSIM_MARGIN from the threshold: the
# cumulative-sum box filter sums in another order on the card), the
# enrollment, the compiled predictor's batch, the post recording's length
EDGE_WINDOWS, EDGE_NOISE_ONLY, SSIM_MARGIN = 8, 3, 1e-4
EDGE_ENROLL_SECONDS, EDGE_IDENTIFY = 12.0, 6
AOT_BATCH, EDGE_POST_SECONDS = 8, 60
# H100 SXM peaks: device memory, TF32 on the tensor cores; an fp32 product
# at fp32 accuracy is three TF32 ones (3xTF32)
HBM_BYTES_S, TF32_FLOP_S, TF32_PER_FP32 = 3.35e12, 495e12, 3


def bound(flop: float, nbytes: float) -> dict:
    """The least time the card could take: bytes at its memory rate, or fp32
    FLOPs as 3xTF32 at its tensor-core rate."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flop * TF32_PER_FP32 / TF32_FLOP_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def featurizer_bound(batch: int) -> dict:
    """The least work of the featurizer's function.  Per frame: the window
    (win multiplies), a real FFT of win points as a win/2-point complex FFT
    (5 n log2 n FLOPs, n = win/2) and its split into the win/2 + 1 bins
    (16 FLOPs a bin), the power (3 a bin) and the banded mel product (2 per
    nonzero weight, 394 at the default geometry): ~1.9 MFLOP a window.
    Bytes: the windows in, the images out, the kernel's tables read once."""
    from mmla_audio_torch.core.config import OverlapFeatureConfig
    from mmla_audio_torch.ops.cuda_features import feature_tables

    cfg = OverlapFeatureConfig()
    tab = feature_tables(cfg)
    win, T, M = cfg.win_length, cfg.n_frames, cfg.n_mels
    n2 = win // 2
    nnz = int((tab.mel_weight != 0).sum())
    frame = win + 5 * n2 * np.log2(n2) + 19 * (n2 + 1) + 2 * nnz
    nbytes = 4 * (batch * (cfg.n_samples + 3 * M * T) + 3 * win
                  + tab.mel_weight.size + len(tab.radices) + 2 * M)
    return bound(batch * T * frame, nbytes)


def featurizer_dense_bound(batch: int) -> float:
    """bound_ms of the TPU kernel's formulation (dense DFT and mel GEMMs,
    the DFT bases read once), which the port's earlier tables used."""
    from mmla_audio_torch.core.config import OverlapFeatureConfig

    cfg = OverlapFeatureConfig()
    win, T, M = cfg.win_length, cfg.n_frames, cfg.n_mels
    bins = win // 2 + 1
    flop = batch * T * (4 * win * bins + 2 * bins * M)
    nbytes = 4 * (batch * (cfg.n_samples + 3 * M * T)
                  + 2 * win * bins + bins * M)
    return bound(flop, nbytes)["bound_ms"]


def block_work(batch: int, C: int, H: int, W: int) -> tuple:
    """(FLOPs, bytes) of a block: both convolutions (2 * 13 C^2 FLOPs a
    pixel); x in, out out, the weights and vectors read once."""
    return (2 * 13 * C * C * H * W * batch,
            4 * (2 * batch * C * H * W + 13 * C * C + 6 * C))


def log(msg: str) -> None:
    print(msg, flush=True)


def seeded_tree(shapes, rng):
    """Random numpy tree in the JAX model's layout, every leaf perturbed."""
    out = {}
    for key, val in shapes.items():
        if isinstance(val, dict):
            out[key] = seeded_tree(val, rng)
        elif key in ("var", "scale"):
            out[key] = rng.uniform(0.5, 2.0, val).astype(np.float32)
        elif key in ("kernel", "recurrent_kernel"):
            fan = np.prod(val[:-1]) + val[-1]
            out[key] = (rng.randn(*val) * np.sqrt(2.0 / fan)).astype(np.float32)
        else:
            out[key] = (rng.randn(*val) * 0.1).astype(np.float32)
    return out


def time_ms(fn, *args, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event mean over ``reps`` calls."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


@contextlib.contextmanager
def timed_steps():
    """Within the block every ``Trainer.train_step`` is timed by CUDA
    events; yields a list that receives each step's ms when the block
    ends (synchronized)."""
    from mmla_audio_torch.train.trainer import Trainer

    events, ms, train_step = [], [], Trainer.train_step

    def timed_step(self, *args):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        out = train_step(self, *args)
        pair[1].record()
        events.append(pair)
        return out

    Trainer.train_step = timed_step
    try:
        yield ms
    finally:
        Trainer.train_step = train_step
    torch.cuda.synchronize()
    ms.extend(a.elapsed_time(b) for a, b in events)


def queued_ms(fn, *args, reps: int = 20, rounds: int = 3) -> float:
    """The card's time of one call without the host's: the CUDA-event mean
    over ``reps`` calls queued behind a ``QUEUE_SLEEP_CYCLES`` sleep kernel,
    so that every launch is enqueued before the card reaches the first;
    median over ``rounds``.  Raises if the host took longer to enqueue them
    than the card slept (the host would then pace the card)."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms >= slept.elapsed_time(start):
            raise AssertionError(f"queued_ms: the host took {host_ms:.3f} ms "
                                 f"to enqueue, longer than the card's "
                                 f"{slept.elapsed_time(start):.3f} ms sleep")
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def speech_windows(n_windows: int, n: int, seed: int) -> np.ndarray:
    from mmla_audio_torch.streaming.capture import FakePCMSource

    src = FakePCMSource(seed=seed, speech_ratio=0.9)
    return np.stack([src.read(n) for _ in range(n_windows)])


def feature_windows(batch: int, n: int, device) -> torch.Tensor:
    """``batch`` float32 speech windows of ``n`` samples on ``device``,
    seeded by ``batch``."""
    return torch.from_numpy(speech_windows(batch, n, seed=batch)
                            .astype(np.float32) / 32768.0).to(device)


def phase_featurizer(device):
    from mmla_audio_torch.core.config import OverlapFeatureConfig
    from mmla_audio_torch.ops.cuda_features import (feature_tables,
                                                    overlap_model_input_cuda)
    from mmla_audio_torch.ops.features import overlap_model_input

    result = {}
    for batch in (1, 64) + POST_BATCHES:
        y = feature_windows(batch, 24000, device)
        got = overlap_model_input_cuda(y)
        torch.cuda.synchronize()
        err, share = check_budget(f"featurizer B={batch}", got,
                                  overlap_model_input(y))
        # plain, kernel, kernel, plain
        plain_a = time_ms(overlap_model_input, y)
        kern_a = time_ms(overlap_model_input_cuda, y)
        kern_b = time_ms(overlap_model_input_cuda, y)
        plain_b = time_ms(overlap_model_input, y)
        bnd = featurizer_bound(batch)
        result[batch] = dict(max_abs_err=err, share=share,
                             ms=min(kern_a, kern_b),
                             plain_ms=min(plain_a, plain_b),
                             **bnd, library_ms=None)
        log(f"[featurizer] B={batch}: max |diff| {err} on {share:.4%} of "
            f"pixels (budget {BUDGET_STEP} on < {BUDGET_SHARE:.0%}); kernel "
            f"{kern_a:.4f}/{kern_b:.4f} ms, plain {plain_a:.4f}/"
            f"{plain_b:.4f} ms; bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}), dense-GEMM bound "
            f"{featurizer_dense_bound(batch):.4f} ms")
        if batch == max(POST_BATCHES):
            log(f"[featurizer] yardstick, FFT stage alone: torch.fft.rfft of "
                f"the B={batch} windowed frames {rfft_ms(y):.4f} ms")
    for kw in GENERIC_GEOMETRIES:
        cfg = OverlapFeatureConfig(**kw)
        y = feature_windows(64, cfg.n_samples, device)
        got = overlap_model_input_cuda(y, cfg)
        torch.cuda.synchronize()
        err, share = check_budget(f"featurizer {kw}", got,
                                  overlap_model_input(y, cfg))
        kern = time_ms(overlap_model_input_cuda, y, cfg)
        plain = time_ms(overlap_model_input, y, cfg)
        log(f"[featurizer] {kw}: win {cfg.win_length}, FFT plan "
            f"{feature_tables(cfg).radices}, B=64: max |diff| {err} on "
            f"{share:.4%} of pixels; kernel {kern:.4f} ms, plain "
            f"{plain:.4f} ms")
    return result


def rfft_ms(y) -> float:
    """CUDA-event time of ``torch.fft.rfft`` of ``y``'s reflect-padded,
    Hann-windowed frames, with their power: the FFT stage of the featurizer
    alone, as a library computes it."""
    from mmla_audio_torch.core.config import OverlapFeatureConfig
    from mmla_audio_torch.ops.spectral import frame_signal, hann_periodic, pad_last

    cfg = OverlapFeatureConfig()
    win = cfg.win_length
    frames = frame_signal(pad_last(y, win // 2, win // 2, "reflect"), win,
                          cfg.hop_length, cfg.n_frames)
    frames = (frames * torch.from_numpy(hann_periodic(win)).to(y.device)
              ).contiguous()

    def power(x):
        return torch.fft.rfft(x).abs().square()

    return time_ms(power, frames, reps=5)


def check_budget(name, got, ref):
    diff = (got - ref).abs()
    err, share = float(diff.max()), float((diff > 0).float().mean())
    if not (err <= BUDGET_STEP and share < BUDGET_SHARE
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{name}: max |diff| {err}, {share:.4%} of "
                             f"pixels differ")
    return err, share


def phase_grouped(device):
    from mmla_audio_torch.core.config import OverlapFeatureConfig
    from mmla_audio_torch.ops.cuda_features import (GROUPS,
                                                    overlap_model_input_cuda)
    from mmla_audio_torch.ops.features import overlap_model_input

    for batch, time_dim, group in ((6, 150, 4), (4, 151, 2)):
        cfg = OverlapFeatureConfig(time_dim=time_dim)
        y = feature_windows(batch, cfg.n_samples, device)
        got = overlap_model_input_cuda(y, cfg, group=group)
        if not torch.equal(got, overlap_model_input_cuda(y, cfg, group=1)):
            raise AssertionError(f"grouped featurizer B={batch} G={group}: "
                                 f"differs from group=1")
        err, share = check_budget(f"grouped featurizer B={batch} G={group}",
                                  got, overlap_model_input(y, cfg))
        log(f"[grouped] B={batch} T={cfg.n_frames} G={group}: bit-equal to "
            f"G=1; max |diff| {err} on {share:.4%} of pixels")
    cfg = OverlapFeatureConfig()
    result = None
    grouped = [g for g in GROUPS if g > 1]
    for batch in POST_BATCHES + (1024, 2400):
        y = feature_windows(batch, cfg.n_samples, device)
        outs = {g: overlap_model_input_cuda(y, cfg, group=g) for g in GROUPS}
        if not all(torch.equal(outs[1], outs[g]) for g in GROUPS):
            raise AssertionError(f"grouped featurizer B={batch}: the groups "
                                 f"differ")
        err, share = check_budget(f"grouped featurizer B={batch}", outs[1],
                                  overlap_model_input(y, cfg))
        del outs
        # plain, then each G up and down, then plain
        times = {g: [] for g in ("plain",) + GROUPS}
        for g in ("plain",) + GROUPS + GROUPS[::-1] + ("plain",):
            if g == "plain":
                times[g].append(time_ms(overlap_model_input, y, cfg, reps=5))
            else:
                times[g].append(time_ms(overlap_model_input_cuda, y, cfg, g,
                                        reps=5))
        log(f"[grouped] B={batch}: every G bit-equal to G=1; max |diff| {err}"
            f" on {share:.4%} of pixels; the wrapper takes G=1; " +
            ", ".join(f"{'plain' if g == 'plain' else f'G={g}'} "
                      f"{t[0]:.4f}/{t[1]:.4f} ms" for g, t in times.items()))
        if batch == max(POST_BATCHES):
            best = min(grouped, key=lambda g: min(times[g]))
            result = dict(max_abs_err=err, group=best, ms=min(times[best]),
                          plain_ms=min(times["plain"]),
                          **featurizer_bound(batch), library_ms=None)
    return result


def seeded_block(C: int, device, rng):
    """An eval-mode ``ResBlock2D(C, C)`` on ``device``, every weight and
    BatchNorm statistic drawn from ``rng``."""
    from mmla_audio_torch.models.overlap import ResBlock2D

    block = ResBlock2D(C, C).to(device).eval()
    with torch.no_grad():
        for t in block.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
                    if t.ndim == 1 else rng.randn(*t.shape).astype(
                        np.float32) / np.sqrt(t[0].numel())))
    return block


def block_error(got, ref) -> tuple:
    """(max |got - ref|, its limit BLOCK_RTOL * max |ref|, whether got is
    finite and within it); synchronizes first."""
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    limit = BLOCK_RTOL * float(ref.abs().max())
    return err, limit, err <= limit and bool(torch.isfinite(got).all())


def phase_block(device):
    from mmla_audio_torch.core.config import OverlapTrainConfig
    from mmla_audio_torch.ops.cuda_resblock import (block_route,
                                                    fused_resblock_cuda,
                                                    fused_resblock_plain)
    from mmla_audio_torch.precision import fp32_policy

    # overlap training's validation runs the block at eval_batch_size rows
    batches = (1, 64) + POST_BATCHES + (OverlapTrainConfig().eval_batch_size,)
    rng = np.random.RandomState(5)
    worst = worst_rel = 0.0
    sums = dict(ms=0.0, plain_ms=0.0, unfused_ms=0.0, flop=0, bytes=0)
    for C, H, W in BLOCK_SHAPES + ((12, 8, 9),):
        block = seeded_block(C, device, rng)
        ops = block.fused_operands()
        route = block_route(C)
        for batch in (8,) if route == "ffma" else batches:
            x = torch.from_numpy(rng.randn(batch, C, H, W).astype(np.float32)
                                 ).to(device)
            reps = 20 if batch <= 64 else 5
            with torch.no_grad(), fp32_policy(False):
                before = fused_resblock_cuda.launches_mma
                got = fused_resblock_cuda(x, *ops)
                ref = fused_resblock_plain(x, *ops)
                err, limit, ok = block_error(got, ref)
                if not ok:
                    raise AssertionError(f"fused block C={C} B={batch}: "
                                         f"max |diff| {err} > {limit}")
                if fused_resblock_cuda.launches_mma - before != (
                        route == "mma"):
                    raise AssertionError(f"fused block C={C}: not the "
                                         f"{route} kernel")
                # plain, kernel, unfused, unfused, kernel, plain
                plain_a = time_ms(fused_resblock_plain, x, *ops, reps=reps)
                kern_a = time_ms(fused_resblock_cuda, x, *ops, reps=reps)
                mod_a = time_ms(block.forward_unfused, x, reps=reps)
                mod_b = time_ms(block.forward_unfused, x, reps=reps)
                kern_b = time_ms(fused_resblock_cuda, x, *ops, reps=reps)
                plain_b = time_ms(fused_resblock_plain, x, *ops, reps=reps)
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / float(ref.abs().max()))
            work = block_work(batch, C, H, W)
            bnd = bound(*work)
            if batch in POST_BATCHES and route == "mma":
                sums["ms"] += min(kern_a, kern_b)
                sums["plain_ms"] += min(plain_a, plain_b)
                sums["unfused_ms"] += min(mod_a, mod_b)
                sums["flop"] += work[0]
                sums["bytes"] += work[1]
            log(f"[block] C={C} {H}x{W} B={batch} ({route}): max |diff| "
                f"{err:.3g} (limit {limit:.3g}); kernel {kern_a:.4f}/"
                f"{kern_b:.4f} ms, plain {plain_a:.4f}/{plain_b:.4f} ms, "
                f"unfused ResBlock2D {mod_a:.4f}/{mod_b:.4f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    total = bound(sums["flop"], sums["bytes"])
    log(f"[block] the three shapes at B={' and B='.join(map(str, POST_BATCHES))}"
        f" (one block of each shape per post-time conversation), summed: "
        f"kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, "
        f"unfused ResBlock2D {sums['unfused_ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({total['bound_by']}); worst max |diff| "
        f"{worst:.3g}, / max |ref| {worst_rel:.3g}")
    return dict(max_abs_err=worst, max_rel_err=worst_rel, ms=sums["ms"],
                plain_ms=sums["plain_ms"], **total,
                library_ms=sums["unfused_ms"])


# -- phase 0: the denoise kernels D1 and D2 --------------------------------

def d1_bound(groups: int, n: int, rows: int, n_fft: int) -> tuple:
    """The bounds of D1's two functions, ``(stft, istft, both)``: a real
    FFT of n_fft points a frame, as an n_fft/2-point complex FFT (5 n log2 n
    FLOPs) and its split into the n_fft/2 + 1 bins (19 FLOPs a bin), plus
    the window (n_fft multiplies) forward, counted as the function's fp32
    work (the kernel's float64 arithmetic is a choice of the kernel).
    Bytes: the STFT reads the ``n`` samples of each of the ``groups`` rows
    once (the centered STFT's reflect padding is folded into its loads, not
    read) and writes re and im; the ISTFT reads re and im and writes the
    frames."""
    n2, k = n_fft // 2, n_fft // 2 + 1
    fft = 5 * n2 * np.log2(n2) + 19 * k
    spec = 4.0 * rows * 2 * k
    fwd = (rows * (fft + n_fft), 4.0 * groups * n + spec)
    inv = (rows * fft, spec + 4.0 * rows * n_fft)
    return bound(*fwd), bound(*inv), bound(fwd[0] + inv[0], fwd[1] + inv[1])


def dense_dft_bases(n_fft: int, device) -> tuple:
    """The dense products' operands for cuBLAS, the yardstick of the
    products as the JAX package writes them: the forward ``[fwd_cos |
    fwd_sin]`` ``(n_fft, 2K)`` and the inverse ``[inv_cos.T; -inv_sin.T]``
    ``(2K, n_fft)``."""
    from mmla_audio_torch.ops import denoise as dn

    fc, fs, ic_t, is_t, _ = dn._bases(n_fft, device)
    return torch.cat([fc, fs], dim=1), torch.cat([ic_t, -is_t], dim=0)


def d2_bound(elements: int, taps: int) -> dict:
    """D2: the mask read and the result written once; a multiply-add for
    every tap of both bands."""
    return bound(2.0 * elements * taps, 8.0 * elements)


def max_rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def denoise_windows(batch: int, seed: int, n: int = 40960) -> np.ndarray:
    """``batch`` live windows of speech over ambient noise, int16."""
    rng = np.random.RandomState(seed)
    speech = speech_windows(batch, n, seed=seed).astype(np.float64)
    return np.clip(speech * rng.uniform(0.05, 1.0, (batch, 1))
                   + rng.randn(batch, n) * 30, -32768, 32767).astype(np.int16)


def check_denoise_kernels(device, y, nt, cfg, what: str) -> dict:
    """One denoise pass of ``y (B, n)`` on the card, each kernel held
    against its plain version on the same inputs (TF32 off) and timed
    beside it and beside the library calls of the same function, in turns:
    D1's STFT and ISTFT (cuFFT's ``torch.fft.rfft`` of the materialized
    windowed frames and ``torch.fft.irfft`` of the complex spectrum, the
    library call of the kernels line; and cuBLAS's ``torch.matmul`` of
    the frames or spectra against the concatenated dense basis, the
    products as written), D2 (``F.conv2d`` with the outer-product kernel,
    cuDNN).  Returns the kernels-line numbers of D1 (STFT + ISTFT summed)
    and D2."""
    import torch.nn.functional as F

    from mmla_audio_torch.ops import denoise as dn
    from mmla_audio_torch.ops.spectral import frame_signal, pad_last
    from mmla_audio_torch.precision import fp32_policy

    sr = 16000
    n_fft, hop = cfg.n_fft, cfg.hop_length
    K = n_fft // 2 + 1
    pad = dn._chunk_pad(cfg, sr)
    yp = F.pad(y, (pad, pad))
    B, L = yp.shape
    T = 1 + L // hop
    fwd, inv = dense_dft_bases(n_fft, y.device)
    window = dn._window(n_fft, y.device)
    v_f, v_t = dn._smoothing_taps(cfg, sr, y.device)
    outer = (v_t.flip(0)[:, None] * v_f.flip(0)[None, :])[None, None]
    big = B * T > 20_000
    reps, rounds = (3, 3) if big else (20, 5)

    def timed(fn, *args):
        return time_ms(fn, *args, reps=reps, rounds=rounds)

    with torch.no_grad(), fp32_policy(False):
        re, im = dn.stft_ri(yp, n_fft, hop)
        pre, pim = dn.stft_ri_plain(yp, n_fft, hop)
        e_stft = max(max_rel(re, pre), max_rel(im, pim))
        mask = dn.gate_mask(pre, pim, nt, cfg.prop_decrease)
        sm = dn.smooth_mask(mask, cfg, sr)
        psm = dn.smooth_mask_plain(mask, cfg, sr)
        e_d2 = float((sm - psm).abs().max())
        lib_sm = F.conv2d(mask.reshape(-1, 1, T, K), outer,
                          padding=(len(v_t) // 2, len(v_f) // 2))
        e_lib = float((lib_sm.reshape(mask.shape) - psm).abs().max())
        mre, mim = pre * psm, pim * psm
        fr = dn.istft_frames(mre, mim, n_fft)
        pfr = dn.istft_frames_plain(mre, mim, n_fft)
        e_istft = max_rel(fr, pfr)
        xre, xim = dn.stft_ri_plain(yp.double(), n_fft, hop)
        xfr = dn.istft_frames_plain(mre.double(), mim.double(), n_fft)
        e_exact = max(max_rel(re.double(), xre), max_rel(im.double(), xim),
                      max_rel(fr.double(), xfr))
        torch.cuda.synchronize()
        if not (e_stft <= D1_RTOL and e_istft <= D1_RTOL and e_d2 <= D2_ATOL
                and e_lib <= D2_LIB_ATOL and e_exact <= D1_EXACT):
            raise AssertionError(f"denoise kernels {what}: D1 STFT {e_stft},"
                                 f" ISTFT {e_istft} (of max |ref|, limit "
                                 f"{D1_RTOL}), vs float64 {e_exact} (limit "
                                 f"{D1_EXACT}); D2 {e_d2} (limit {D2_ATOL}), "
                                 f"conv2d {e_lib} (limit {D2_LIB_ATOL})")
        frames = frame_signal(pad_last(yp, n_fft // 2, n_fft // 2,
                                       "reflect"), n_fft, hop, T)
        frames = frames.reshape(-1, n_fft).contiguous()
        wframes = frames * window
        spec = torch.cat([mre, mim], -1).reshape(-1, 2 * K)
        cspec = torch.complex(mre, mim).reshape(-1, K)
        # cuFFT computes the same functions (its C2R ignores the imaginary
        # parts at DC and Nyquist, as the inverse bases do)
        e_fft = max(max_rel(torch.view_as_real(torch.fft.rfft(wframes)),
                            torch.stack([pre, pim], -1).reshape(-1, K, 2)),
                    max_rel(torch.fft.irfft(cspec, n=n_fft),
                            pfr.reshape(-1, n_fft)))
        # the same function in float64, D1's working precision: cuFFT's
        # double pair against the float64 products
        wframes64, cspec64 = wframes.double(), cspec.to(torch.complex128)
        e_fft64 = max(max_rel(torch.view_as_real(torch.fft.rfft(wframes64)),
                              torch.stack([xre, xim], -1).reshape(-1, K, 2)),
                      max_rel(torch.fft.irfft(cspec64, n=n_fft),
                              xfr.reshape(-1, n_fft)))
        del xre, xim, xfr
        m4 = mask.reshape(-1, 1, T, K)
        turns = (
            ("stft_plain", dn.stft_ri_plain, (yp, n_fft, hop)),
            ("stft", dn.stft_ri, (yp, n_fft, hop)),
            ("stft_fft", torch.fft.rfft, (wframes,)),
            ("stft_fft64", torch.fft.rfft, (wframes64,)),
            ("stft_lib", torch.matmul, (frames, fwd)),
            ("istft_plain", dn.istft_frames_plain, (mre, mim, n_fft)),
            ("istft", dn.istft_frames, (mre, mim, n_fft)),
            ("istft_fft", lambda x: torch.fft.irfft(x, n=n_fft), (cspec,)),
            ("istft_fft64", lambda x: torch.fft.irfft(x, n=n_fft),
             (cspec64,)),
            ("istft_lib", torch.matmul, (spec, inv)),
            ("d2_plain", dn.smooth_mask_plain, (mask, cfg, sr)),
            ("d2", dn.smooth_mask, (mask, cfg, sr)),
            ("d2_lib", F.conv2d, (m4, outer, None, 1,
                                  (len(v_t) // 2, len(v_f) // 2))))
        # plain, kernel, libraries, then the same backwards
        t = {}
        for name, fn, args in turns + turns[::-1]:
            t.setdefault(name, []).append(timed(fn, *args))
        # the kernels and the library calls on the card alone (at small B
        # the calls above are paced by the host's launches); on the long
        # file D2 and cuDNN's (the dense pair there is the card's work
        # anyway); an empty kernel queued the same way is the launch floor
        alone = ("d2", "d2_lib") if big else (
            "stft", "stft_fft", "stft_fft64", "stft_lib", "istft",
            "istft_fft", "istft_fft64", "istft_lib", "d2", "d2_plain",
            "d2_lib")
        queued = {}
        q_turns = [turn for turn in turns if turn[0] in alone]
        for name, fn, args in q_turns + q_turns[::-1]:
            queued.setdefault(name, []).append(queued_ms(fn, *args))
        floor = queued_ms(torch.cuda._sleep, 0)
    t = {k: min(v) for k, v in t.items()}
    queued = {k: min(v) for k, v in queued.items()}
    rows = B * T
    b_stft, b_istft, b_fft = d1_bound(B, L, rows, n_fft)
    b_d2 = d2_bound(rows * K, len(v_f) + len(v_t))
    pair = {k: t[k] + t["i" + k]
            for k in ("stft", "stft_fft", "stft_fft64", "stft_lib")}
    qpair = {k: queued[k] + queued["i" + k] for k in pair} if not big else {}
    log(f"[denoise] {what} (B={B}, T={T}): D1 STFT max |diff| / max |ref| "
        f"{e_stft:.3g}, ISTFT {e_istft:.3g} (limit {D1_RTOL}), both vs the "
        f"float64 products {e_exact:.3g} (limit {D1_EXACT}); cuFFT vs "
        f"plain {e_fft:.3g}, cuFFT float64 vs the float64 products "
        f"{e_fft64:.3g}; D2 max |diff| {e_d2:.3g} (limit {D2_ATOL}), "
        f"conv2d vs dense {e_lib:.3g}; ms: STFT kernel {t['stft']:.4f}, "
        f"plain {t['stft_plain']:.4f}, cuFFT rfft {t['stft_fft']:.4f}, "
        f"cuBLAS {t['stft_lib']:.4f}, bound {b_stft['bound_ms']:.4f}; ISTFT "
        f"kernel {t['istft']:.4f}, plain {t['istft_plain']:.4f}, cuFFT irfft "
        f"{t['istft_fft']:.4f}, cuBLAS {t['istft_lib']:.4f}, bound "
        f"{b_istft['bound_ms']:.4f}; D1 pair {pair['stft']:.4f} vs cuFFT "
        f"{pair['stft_fft']:.4f} (float64 {pair['stft_fft64']:.4f}) vs "
        f"cuBLAS {pair['stft_lib']:.4f} ("
        f"{'faster' if pair['stft'] < pair['stft_lib'] else 'NOT faster'} "
        f"than cuBLAS), bound {b_fft['bound_ms']:.4f} ({b_fft['bound_by']}, "
        f"{b_fft['bound_ms'] / pair['stft']:.1%} of it reached); D2 kernel "
        f"{t['d2']:.4f}, dense plain {t['d2_plain']:.4f}, cuDNN conv2d "
        f"{t['d2_lib']:.4f}, bound {b_d2['bound_ms']:.4f} "
        f"({b_d2['bound_by']})")
    if qpair:
        log(f"[denoise] {what}: on the card alone (queued behind a sleep): "
            f"D1 pair {qpair['stft']:.4f} (STFT {queued['stft']:.4f}, ISTFT "
            f"{queued['istft']:.4f}) vs cuFFT {qpair['stft_fft']:.4f} "
            f"(float64 {qpair['stft_fft64']:.4f}) vs cuBLAS "
            f"{qpair['stft_lib']:.4f} ("
            f"{'faster' if qpair['stft'] < qpair['stft_lib'] else 'NOT faster'}"
            f" than cuBLAS)")
    # D2 alone where it was queued, else (the long file's dense pair) the
    # calls' time, which the card sets there
    d2_ms = {k: queued.get(k, t[k]) for k in ("d2", "d2_plain", "d2_lib")}
    plain_alone = "" if big else f" (alone {queued['d2_plain']:.4f})"
    log(f"[denoise] {what}: D2 time_ms {t['d2']:.4f}, queued_ms "
        f"{queued['d2']:.4f} (the launch floor, an empty kernel queued the "
        f"same way, {floor:.4f}); dense plain {t['d2_plain']:.4f}"
        f"{plain_alone}, cuDNN conv2d {t['d2_lib']:.4f} (alone "
        f"{queued['d2_lib']:.4f}); "
        f"bound {b_d2['bound_ms']:.4f} ({b_d2['bound_by']}, "
        f"{b_d2['bound_ms'] / queued['d2']:.1%} of it reached alone)")
    if not (d2_ms["d2"] < d2_ms["d2_plain"] and d2_ms["d2"] < d2_ms["d2_lib"]):
        raise AssertionError(f"denoise kernels {what}: D2 {d2_ms['d2']:.4f} "
                             f"ms is not faster than the dense pair "
                             f"{d2_ms['d2_plain']:.4f} and cuDNN's conv2d "
                             f"{d2_ms['d2_lib']:.4f}")
    # D1 must beat the dense pair on the card: its time alone where the
    # host paces the calls (small B), else the calls' time
    d1, dense = (qpair or pair)["stft"], (qpair or pair)["stft_lib"]
    if not d1 < dense:
        raise AssertionError(f"denoise kernels {what}: D1's pair {d1:.4f} ms "
                             f"is not faster than cuBLAS's {dense:.4f} ms")
    return dict(
        d1=dict(max_abs_err=max(float((re - pre).abs().max()),
                                float((im - pim).abs().max()),
                                float((fr - pfr).abs().max())),
                ms=pair["stft"],
                plain_ms=t["stft_plain"] + t["istft_plain"], **b_fft,
                library_ms=pair["stft_fft"]),
        d2=dict(max_abs_err=e_d2, ms=t["d2"], plain_ms=t["d2_plain"], **b_d2,
                library_ms=t["d2_lib"]))


def check_denoise_batches(device, raw: np.ndarray, nt, cfg) -> tuple:
    """``reduce_noise`` of each window alone equals its row of the batch
    bit for bit (the count of differing float samples must be 0), and the
    batch after int16 quantization is within ``DN_STEP`` on <
    ``DN_SHARE`` of samples of the plain chain run in float64, the exact
    chain (D1 computes in float64, so the card decides each gate bin as
    the exact spectrum does).  The fp32 plain chain is compared too: the
    card within ``DN_STEP``'s share, and both chains' largest step against
    the exact one logged (an fp32 dense product errs by ~1e-5 of a quiet
    bin and so gates some near-ties the other way, each moving up to 16
    steps around it).  Returns the counts, the errors and the times of the
    card's chain and the fp32 plain chain."""
    from mmla_audio_torch.ops.denoise import (quantize_i16, reduce_noise,
                                              reduce_noise_plain)

    passes = cfg.passes_live
    y = torch.from_numpy(raw.astype(np.float32) / 32768.0).to(device)
    with torch.no_grad():
        batched = reduce_noise(y, nt, cfg, passes=passes)
        differing = sum(int((reduce_noise(y[b], nt, cfg, passes=passes)
                             != batched[b]).sum())
                        for b in range(len(raw)))
        plain = quantize_i16(reduce_noise_plain(y, nt, cfg, passes=passes))
        exact = quantize_i16(reduce_noise_plain(y.double(), nt.double(), cfg,
                                                passes=passes))
        card = quantize_i16(batched).double()
        diff = (card - exact).abs()
        err, share = float(diff.max()), float((diff > 0).float().mean())
        vs_plain = (card - plain.double()).abs()
        plain_err = float(vs_plain.max())
        plain_share = float((vs_plain > 0).float().mean())
        fp32_err = float((plain.double() - exact).abs().max())
        del exact, diff, vs_plain
        if differing or err > DN_STEP or share >= DN_SHARE \
                or plain_share >= DN_SHARE:
            raise AssertionError(f"reduce_noise B={len(raw)}: {differing} "
                                 f"samples differ from the single-window "
                                 f"run; vs the float64 chain {err} on "
                                 f"{share:.4%}; vs the fp32 chain "
                                 f"{plain_err} on {plain_share:.4%}")
        reps = 3 if len(raw) >= 64 else 10
        ms = time_ms(reduce_noise, y, nt, cfg, 16000, passes, reps=reps)
        plain_ms = time_ms(reduce_noise_plain, y, nt, cfg, 16000, passes,
                           reps=reps)
    return (differing, err, share, (plain_err, plain_share, fp32_err), ms,
            plain_ms)


def phase_denoise(device, noise) -> dict:
    """Phase 0: D1 and D2 against their plain versions and the library
    calls at the live window (T = 183) at ``DENOISE_BATCHES`` and on the
    12-minute whole file (T = 45,023); ``reduce_noise`` batched vs single
    at each batch.  Returns the kernels-line entries (at B=64, the
    multiplexer's bucket)."""
    from mmla_audio_torch.core.config import DenoiseConfig
    from mmla_audio_torch.ops import denoise as dn

    cfg = DenoiseConfig()
    nt = dn.noise_threshold(torch.from_numpy(noise.astype(np.float32)
                                             / 32768.0).to(device), cfg)
    out = None
    for batch in DENOISE_BATCHES:
        raw = denoise_windows(batch, seed=40 + batch)
        y = torch.from_numpy(raw.astype(np.float32) / 32768.0).to(device)
        got = check_denoise_kernels(device, y, nt, cfg, f"live B={batch}")
        if batch == 64:
            out = got
        (differing, err, share, (plain_err, plain_share, fp32_err), ms,
         plain_ms) = check_denoise_batches(device, raw, nt, cfg)
        log(f"[denoise] reduce_noise B={batch} ({cfg.passes_live} pass): "
            f"{differing} float samples differ between the batch and each "
            f"window alone; int16 vs the float64 plain chain max |diff| "
            f"{err} on {share:.4%} (budget {DN_STEP} on < {DN_SHARE:.1%}); "
            f"vs the fp32 plain chain max |diff| {plain_err} on "
            f"{plain_share:.4%} (share budget {DN_SHARE:.1%}); the fp32 "
            f"plain chain vs the float64 one max |diff| {fp32_err}; "
            f"{ms:.4f} ms (plain chain {plain_ms:.4f} ms)")
    seconds = RECORDINGS["zoom_conv1"][0]
    y = torch.from_numpy(denoise_windows(1, seed=45, n=seconds * 16000)
                         .astype(np.float32) / 32768.0).to(device)
    check_denoise_kernels(device, y, nt, cfg, f"{seconds // 60}-minute file")
    dn._smoothing_matrices.cache_clear()        # the 8 GB time matrix
    torch.cuda.empty_cache()
    return out


def phase_denoise_hour(device, noise) -> None:
    """A 60-minute recording denoised at ``passes_post`` on the card
    through D1 and D2 alone (its dense time matrix would be 202.5 GB):
    host-clock time, peak allocated memory (under ``HOUR_PEAK_BYTES``),
    launches, a finite output of the input's length."""
    from mmla_audio_torch.core.config import DenoiseConfig
    from mmla_audio_torch.ops import denoise as dn
    from mmla_audio_torch.streaming.capture import FakePCMSource

    cfg = DenoiseConfig()
    n = HOUR_SECONDS * 16000
    rng = np.random.RandomState(46)
    audio = (FakePCMSource(seed=46, speech_ratio=0.6).read(n).astype(np.float32)
             + rng.randn(n).astype(np.float32) * 30) / 32768.0
    y = torch.from_numpy(audio).to(device)
    nt = dn.noise_threshold(torch.from_numpy(noise.astype(np.float32)
                                             / 32768.0).to(device), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    before = (dn.stft_ri.launches, dn.istft_frames.launches,
              dn.smooth_mask.launches)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = dn.reduce_noise(y, nt, cfg, passes=cfg.passes_post)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    launched = (dn.stft_ri.launches - before[0],
                dn.istft_frames.launches - before[1],
                dn.smooth_mask.launches - before[2])
    T = 1 + (n + 2 * dn._chunk_pad(cfg, 16000)) // cfg.hop_length
    if out.shape != y.shape or not bool(torch.isfinite(out).all()) \
            or peak >= HOUR_PEAK_BYTES \
            or launched != (cfg.passes_post,) * 3:
        raise AssertionError(f"60-minute denoise: shape {tuple(out.shape)}, "
                             f"peak {peak / 1e9:.2f} GB, launches "
                             f"{launched}")
    log(f"[denoise] 60-minute file ({n} samples, T={T} frames, "
        f"{cfg.passes_post} passes): {seconds:.3f} s on the host clock, peak "
        f"allocated {peak / 1e9:.3f} GB ({base / 1e9:.3f} GB before; limit "
        f"{HOUR_PEAK_BYTES / 1e9:.0f} GB; the dense time matrix alone would "
        f"be {4.0 * T * T / 1e9:.1f} GB); launches (STFT, ISTFT, D2) "
        f"{launched}; output finite, {out.shape[-1]} samples; the overlap "
        f"windows of this file are not labeled here (denoise only)")
    del y, out
    torch.cuda.empty_cache()


def phase_predictor(device, state_dict, cfg):
    from mmla_audio_torch.inference import OverlapPredictor

    buf = speech_windows(8, 40960, seed=11)
    n = np.array([40960, 40000, 36000, 30000, 24000, 12000, 6000, 3000],
                 np.int32)
    outs = []
    for dev in (device, "cpu"):
        pred = OverlapPredictor(state_dict, cfg, device=dev,
                                matmul_precision="highest")
        labels, probs = pred.predict(buf, n)
        outs.append((labels.cpu().numpy(), probs.float().cpu().numpy()))
    (lc, pc), (l0, p0) = outs
    if pc.shape != (8, cfg.num_classes) or not np.isfinite(pc).all():
        raise AssertionError(f"predictor output bad: {pc.shape}")
    perr = float(np.abs(pc - p0).max())
    top2 = np.sort(p0, axis=1)
    decided = (top2[:, -1] - top2[:, -2]) > TOP2_MARGIN
    if perr > PROB_ATOL or not (lc[decided] == l0[decided]).all():
        raise AssertionError(f"predictor card vs CPU: labels {lc} vs {l0}, "
                             f"max |dprob| {perr}")
    log(f"[predictor] B=8 full width: card labels {lc.tolist()} == CPU "
        f"labels {l0.tolist()} where top-2 margin > {TOP2_MARGIN} "
        f"({int(decided.sum())}/8); max |dprob| {perr:.3g} "
        f"(atol {PROB_ATOL})")


def run_session(device, state_dict, cfg, samples, noise, root):
    from mmla_audio_torch.inference import OverlapPredictor
    from mmla_audio_torch.streaming.capture import ArraySource, CaptureThread
    from mmla_audio_torch.streaming.session import OverlapSession

    pred = OverlapPredictor(state_dict, cfg.overlap_model, device=device,
                            matmul_precision="highest")
    cap = CaptureThread(ArraySource(samples), cfg.audio).start()
    try:
        sess = OverlapSession(pred, cap, root, cfg=cfg)
        sess.set_noise_profile(noise)
        rows = sess.run(max_windows=4)
    finally:
        cap.stop()
    return sess, rows


def arrangement_times(card, host, windows, rounds: int = ARRANGEMENT_ROUNDS
                      ) -> dict:
    """Window-to-decision times (host clock, ms) of two sessions on the
    card over the same windows: ``card`` with its chain on the card
    (``host_preprocess=False``), ``host`` with the host split.  Each round
    runs every window through both, the order alternating by window."""
    times = {"card chain": [], "host split": []}
    for r in range(rounds):
        for i, w in enumerate(windows):
            pair = (("card chain", card), ("host split", host))
            for name, sess in pair[:: 1 if (r + i) % 2 == 0 else -1]:
                t0 = time.perf_counter()
                sess.process_window(w)
                times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def arrangement_line(times: dict) -> str:
    return "window-to-decision " + "; ".join(
        f"{name} p50 {np.percentile(t, 50):.2f} ms, p90 "
        f"{np.percentile(t, 90):.2f} ms" for name, t in times.items()) + (
        f" ({len(next(iter(times.values())))} windows each, alternating, "
        f"host clock)")


class ProbsTap:
    """An OverlapPredictor whose ``predict`` also keeps the probabilities,
    so the post-time labels can be compared where the margin is clear."""

    def __init__(self, pred):
        self.pred, self.device, self.probs = pred, pred.device, []

    def predict(self, buf, n):
        labels, probs = self.pred.predict(buf, n)
        self.probs.append(probs.cpu().numpy())
        return labels, probs


def post_clips(cfg) -> dict:
    """The post-time recordings of ``RECORDINGS``: synthetic speech."""
    from mmla_audio_torch.streaming.capture import FakePCMSource

    src = FakePCMSource(seed=31, speech_ratio=0.8)
    return {name: src.read(sec * cfg.audio.sample_rate)
            for name, (sec, _) in RECORDINGS.items()}


def write_experiment(root: Path, clips: dict, noise, sr: int, corpus=()):
    """An experiment tree with the recordings, the ambient noise clip and
    one short enrollment clip per name in ``corpus``."""
    from mmla_audio_torch.data.wavio import write_wav
    from mmla_audio_torch.utils.experiment import bootstrap

    dirs = bootstrap(root)
    for name, clip in clips.items():
        write_wav(dirs.post_whole / f"{name}.wav", clip, sr)
    write_wav(dirs.noise_path, noise, sr)
    for i, name in enumerate(corpus):
        write_wav(dirs.corpus / f"{name}.wav",
                  speech_windows(1, sr, seed=60 + i)[0], sr)
    return dirs


def phase_post(device, tree, state_dict, cfg, noise, tmp: Path, clips):
    from mmla_audio_torch.analyze.logs import parse_log
    from mmla_audio_torch.analyze.post_time import overlap_post_analyze
    from mmla_audio_torch.inference import OverlapPredictor
    from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_cuda
    from mmla_audio_torch.params import save_npz

    sr = cfg.audio.sample_rate
    recordings = RECORDINGS
    start = datetime(2026, 1, 1)
    runs = {}
    for dev in (device, device, "cpu"):
        key = "card" if dev != "cpu" else "cpu"
        dirs = write_experiment(tmp / f"post_{key}", clips, noise, sr)
        pred = ProbsTap(OverlapPredictor(state_dict, cfg.overlap_model,
                                         device=dev,
                                         matmul_precision="highest"))
        zero_launch_counters()
        t0 = time.perf_counter()
        logs = overlap_post_analyze(dirs, pred, cfg=cfg, noise=noise,
                                    start_time=start)
        if dev != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = (overlap_model_input_cuda.launches,
                    overlap_model_input_cuda.launches_grouped,
                    fused_resblock_cuda.launches_mma,
                    *denoise_launches().values())
        rows = {name: parse_log(path) for name, path in logs.items()}
        for name, (_, n_rows) in recordings.items():
            if len(rows[name]) != n_rows or \
                    not (dirs.charts / f"{name}.html").exists():
                raise AssertionError(f"post-time {key}: {name} has "
                                     f"{len(rows[name])} rows, want {n_rows}, "
                                     f"or no chart")
        n_windows = sum(n for _, n in recordings.values())
        log(f"[post] {key}: {n_windows} windows in {seconds:.3f} s = "
            f"{n_windows / seconds:.1f} windows/s (host clock, standardize "
            f"+ denoise + predict + logs + charts); launches: featurizer "
            f"{launches[0]} one-window, {launches[1]} grouped; fused block "
            f"on the tensor cores {launches[2]}; denoise D1 {launches[3]}, "
            f"D2 {launches[4]}")
        if key not in runs:                  # the card's first run counts
            runs[key] = dict(rows=rows, probs=pred.probs, launches=launches,
                             wps=n_windows / seconds)
        else:
            runs[key]["wps_warm"] = n_windows / seconds
    card, cpu = runs["card"], runs["cpu"]
    # the featurizer at G=1, one launch a conversation
    want = (len(recordings), 0)
    # D1 and D2: the audio* recordings are denoised (zoom* are not), each
    # at passes_post (STFT, ISTFT, D2 a pass) after its profile's STFT
    denoised = sum(name.startswith("audio") for name in recordings)
    passes = cfg.denoise.passes_post * denoised
    if tuple(card["launches"][:2]) != want or card["launches"][2] <= 0 \
            or card["launches"][4] != passes \
            or card["launches"][3] != 2 * passes + denoised:
        raise AssertionError(f"post-time on the card launched the featurizer"
                             f" (one-window, grouped) {card['launches'][:2]}"
                             f" times, want {want}; the tensor-core fused "
                             f"block {card['launches'][2]} times; D1, D2 "
                             f"{card['launches'][3:]}")
    decided = agree = 0
    for i, name in enumerate(sorted(recordings)):
        top2 = np.sort(cpu["probs"][i], axis=1)
        clear = (top2[:, -1] - top2[:, -2]) > TOP2_MARGIN
        got = np.array([r[1] for r in card["rows"][name]])
        ref = np.array([r[1] for r in cpu["rows"][name]])
        decided += int(clear.sum())
        agree += int((got[clear] == ref[clear]).sum())
    if agree != decided:
        raise AssertionError(f"post-time card vs CPU: {decided - agree} of "
                             f"{decided} clear labels differ")
    log(f"[post] card labels == CPU labels where the top-2 margin > "
        f"{TOP2_MARGIN} ({decided}/{sum(n for _, n in recordings.values())} "
        f"windows)")

    npz = tmp / "weights.npz"
    save_npz(tree, npz)
    cli_root = tmp / "post_cli"
    write_experiment(cli_root, clips, noise, sr)
    proc = subprocess.run(
        [sys.executable, "-m", "mmla_audio_torch.cli", "overlap-post",
         "--root", str(cli_root), "--weights", str(npz)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    made = [(cli_root / d / f"{name}.{ext}").exists() for name in recordings
            for d, ext in (("logs", "txt"), ("charts", "html"))]
    if proc.returncode != 0 or not all(made):
        raise AssertionError(f"CLI overlap-post failed ({proc.returncode}):"
                             f"\n{proc.stdout}\n{proc.stderr}")
    log("[post] cli: " + " | ".join(ln for ln in proc.stdout.splitlines()
                                     if ln.startswith(("[INFO]", "[TIME]"))))
    return card


class LogitsTap:
    """A SpeakerPredictor whose ``score`` and ``logits_from_features`` also
    keep the logits, so card and CPU labels can be compared where the
    CPU's top-2 margin is clear."""

    def __init__(self, pred):
        self.pred, self.device, self.logits = pred, pred.device, []

    def score(self, buf, n):
        logits, probs = self.pred.score(buf, n)
        self.logits.append(logits.cpu().numpy())
        return logits, probs

    def logits_from_features(self, feats):
        logits = self.pred.logits_from_features(feats)
        self.logits.append(logits.cpu().numpy())
        return logits


def speaker_windows(seconds: int, sr: int = 16000) -> int:
    """Windows of the speaker post path for a recording: ceil(T / 256) of
    its T = 1 + ceil((n - 400) / 160) MFCC frames."""
    frames = 1 + -(-(seconds * sr - 400) // 160)
    return -(-frames // 256)


def clear_rows(logits) -> np.ndarray:
    """Rows whose top-2 logit margin is above ``TOP2_MARGIN``."""
    top2 = np.sort(logits, axis=1)
    return (top2[:, -1] - top2[:, -2]) > TOP2_MARGIN


def compare_labels(name, got, ref, ref_logits) -> tuple:
    """Card labels ``got`` vs CPU labels ``ref`` (names or indices, silent
    included): equal wherever the CPU's margin is clear; raises otherwise.
    Returns (clear rows, rows)."""
    got, ref = np.asarray(got), np.asarray(ref)
    clear = clear_rows(ref_logits)
    if got.shape != ref.shape or not (got[clear] == ref[clear]).all():
        raise AssertionError(f"{name}: card {got.tolist()} vs CPU "
                             f"{ref.tolist()} where the margin is clear")
    return int(clear.sum()), len(ref)


def phase_speaker_predictor(device, state_dict, mcfg):
    from mmla_audio_torch.inference import SILENT, SpeakerPredictor
    from mmla_audio_torch.ops.features import speaker_feature_batch

    buf = speech_windows(64, 40960, seed=41)
    n = np.full(64, 40960, np.int32)
    n[1::8], n[2::8], n[3::8] = 30001, 12000, 3999
    preds = {dev: SpeakerPredictor(state_dict, mcfg, device=dev)
             for dev in (device, "cpu")}
    for batch in (1, 64):
        outs = {}
        for dev, pred in preds.items():
            logits, _ = pred.score(buf[:batch], n[:batch])
            labels, _ = pred.predict(buf[:batch], n[:batch])
            outs[dev] = labels.cpu().numpy(), logits.cpu().numpy()
        (lc, zc), (l0, z0) = outs[device], outs["cpu"]
        err = float(np.abs(zc - z0).max())
        limit = LOGIT_RTOL * float(np.abs(z0).max())
        if zc.shape != (batch, mcfg.num_speakers) or not np.isfinite(zc).all() \
                or err > limit or not (l0[n[:batch] < 4000] == SILENT).all():
            raise AssertionError(f"speaker predictor B={batch}: logits "
                                 f"{zc.shape}, max |dlogit| {err} > {limit}")
        clear, rows = compare_labels(f"speaker predictor B={batch}", lc, l0,
                                     z0)
        log(f"[speaker] predictor B={batch} full width: card labels == CPU "
            f"labels where the top-2 logit margin > {TOP2_MARGIN} "
            f"({clear}/{rows}); max |dlogit| {err:.3g} (limit {limit:.3g}, "
            f"{LOGIT_RTOL} of max |logit|); {int((l0 == SILENT).sum())} "
            f"silent")
    # the model's forward on MFCC rows: TF32 off (the policy) and allowed
    tf32 = SpeakerPredictor(state_dict, mcfg, device=device,
                            matmul_precision=None)
    for batch in (1, speaker_windows(RECORDINGS["zoom_conv1"][0])):
        rows = np.resize(buf, (batch, buf.shape[1]))
        feats, _ = speaker_feature_batch(
            torch.from_numpy(rows).to(device).float(),
            torch.full((batch,), 40960, device=device))
        reps = 20 if batch == 1 else 5
        with torch.no_grad():
            times = [time_ms(p.apply_model, feats, reps=reps)
                     for p in (preds[device], tf32, tf32, preds[device])]
        log(f"[speaker] model forward B={batch}: TF32 off (the policy) "
            f"{times[0]:.4f}/{times[3]:.4f} ms, TF32 allowed (information) "
            f"{times[1]:.4f}/{times[2]:.4f} ms")


def phase_speaker_session(device, state_dict, cfg, noise, tmp: Path):
    from mmla_audio_torch.analyze.logs import parse_log
    from mmla_audio_torch.inference import SpeakerPredictor
    from mmla_audio_torch.streaming.capture import ArraySource, CaptureThread
    from mmla_audio_torch.streaming.session import SpeakerSession

    n_win = cfg.audio.window_samples
    speech = speech_windows(9, n_win, seed=51)
    windows = [speech[0], np.zeros(n_win, np.int16)] + list(speech[1:])
    runs = {}
    for dev in (device, torch.device("cpu")):
        pred = LogitsTap(SpeakerPredictor(state_dict, cfg.speaker_model,
                                          device=dev))
        cap = CaptureThread(ArraySource(np.concatenate(windows)),
                            cfg.audio).start()
        try:
            sess = SpeakerSession(pred, cap, tmp / f"speaker_{dev.type}",
                                  cfg=cfg)
            sess.set_noise_profile(noise)
            rows = sess.run(max_windows=len(windows))
        finally:
            cap.stop()
        labels = [r[1] for r in rows]
        if len(rows) != 10 or len(parse_log(sess.log.path)) != 10 or \
                labels[1] != "silent":
            raise AssertionError(f"speaker session on {dev}: rows {rows}")
        runs[dev] = sess, labels, np.concatenate(pred.logits)
    sess, labels, _ = runs[device]
    _, cpu_labels, cpu_logits = runs[torch.device("cpu")]
    clear, n = compare_labels("speaker session", labels, cpu_labels,
                              cpu_logits)
    if sess.preprocess_device != device:
        raise AssertionError(f"speaker session: chain on "
                             f"{sess.preprocess_device}")
    host = SpeakerSession(sess.predictor, None, tmp / "speaker_host", cfg=cfg,
                          host_preprocess=True)
    host.set_noise_profile(noise)
    times = arrangement_times(sess, host, windows, rounds=6)
    log(f"[speaker] session: card labels == CPU labels where the top-2 "
        f"logit margin > {TOP2_MARGIN} ({clear}/{n}); 10 TSV rows; "
        + arrangement_line(times))


def phase_speaker_post(device, tree, cfg, noise, tmp: Path, clips):
    from mmla_audio_torch.analyze.logs import parse_log
    from mmla_audio_torch.analyze.post_time import (speaker_post_analyze,
                                                    whole_file_mfcc39)
    from mmla_audio_torch.inference import SpeakerPredictor
    from mmla_audio_torch.params import save_npz, speaker_state_dict_from_jax

    sr, mcfg = cfg.audio.sample_rate, cfg.speaker_model
    state_dict = speaker_state_dict_from_jax(tree, mcfg, len(SPEAKERS))
    start = datetime(2026, 1, 1)
    want = {name: speaker_windows(sec) for name, (sec, _) in RECORDINGS.items()}
    runs = {}
    for dev in (device, device, "cpu"):
        key = "card" if dev != "cpu" else "cpu"
        dirs = write_experiment(tmp / f"speaker_post_{key}", clips, noise,
                                sr, SPEAKERS)
        pred = LogitsTap(SpeakerPredictor(
            state_dict, mcfg, head_units=len(SPEAKERS), sigmoid_head=True,
            device=dev))
        t0 = time.perf_counter()
        logs = speaker_post_analyze(dirs, pred, cfg=cfg, noise=noise,
                                    start_time=start)
        if dev != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rows = {name: [r[1] for r in parse_log(path)]
                for name, path in logs.items()}
        for name, n_rows in want.items():
            if len(rows[name]) != n_rows or \
                    not (dirs.charts / f"{name}.html").exists():
                raise AssertionError(f"speaker post {key}: {name} has "
                                     f"{len(rows[name])} rows, want "
                                     f"{n_rows}, or no chart")
        n_windows = sum(want.values())
        log(f"[speaker] post {key}: {n_windows} windows in {seconds:.3f} s "
            f"= {n_windows / seconds:.1f} windows/s (host clock, "
            f"standardize + denoise + VAD + whole-file MFCC + predict + logs "
            f"+ charts); silent rows "
            f"{sum(r.count('silent') for r in rows.values())}")
        if key not in runs:
            runs[key] = dict(rows=rows, logits=pred.logits)
    card, cpu = runs["card"], runs["cpu"]
    clear = total = 0
    for i, name in enumerate(sorted(want)):
        c, t = compare_labels(f"speaker post {name}", card["rows"][name],
                              cpu["rows"][name], cpu["logits"][i])
        clear, total = clear + c, total + t
    log(f"[speaker] post: card rows == CPU rows where the top-2 logit margin "
        f"> {TOP2_MARGIN} ({clear}/{total} windows)")
    sig = torch.from_numpy(clips["zoom_conv1"]).to(device)
    ms = time_ms(whole_file_mfcc39, sig, cfg, device, reps=3)
    log(f"[speaker] whole-file MFCC-39 of the {len(sig) / sr / 60:.0f}-minute "
        f"recording ({len(sig)} samples, on the card): {ms:.3f} ms (CUDA "
        f"events)")

    npz = tmp / "speaker_weights.npz"
    save_npz(tree, npz)
    cli_root = tmp / "speaker_post_cli"
    write_experiment(cli_root, clips, noise, sr, SPEAKERS)
    proc = subprocess.run(
        [sys.executable, "-m", "mmla_audio_torch.cli", "speaker-post",
         "--root", str(cli_root), "--weights", str(npz)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    made = [(cli_root / d / f"{name}.{ext}").exists() for name in want
            for d, ext in (("logs", "txt"), ("charts", "html"))]
    if proc.returncode != 0 or not all(made):
        raise AssertionError(f"CLI speaker-post failed ({proc.returncode}):"
                             f"\n{proc.stdout}\n{proc.stderr}")
    log("[speaker] cli: " + " | ".join(
        ln for ln in proc.stdout.splitlines()
        if ln.startswith(("[INFO]", "[TIME]"))))


def phase_speaker(device, cfg, noise, tmp: Path, clips) -> None:
    """The speaker path at full width; it must launch none of the port's
    kernels but the denoise's (its convolutions, LSTM and GEMMs are cuDNN
    and cuBLAS, as the JAX package leaves them to XLA)."""
    from mmla_audio_torch.params import (speaker_state_dict_from_jax,
                                         speaker_tree_shapes)

    mcfg = cfg.speaker_model
    zero_launch_counters()
    rng = np.random.RandomState(7)
    tree = seeded_tree(speaker_tree_shapes(mcfg), rng)
    state_dict = speaker_state_dict_from_jax(tree, mcfg)
    phase_speaker_predictor(device, state_dict, mcfg)
    phase_speaker_session(device, state_dict, cfg, noise, tmp)
    phase_speaker_post(device, seeded_tree(
        speaker_tree_shapes(mcfg, len(SPEAKERS)), rng), cfg, noise, tmp,
        clips)
    log(f"[speaker] kernel launches on the speaker path: "
        f"{no_launches('the speaker path')}")


def launch_counters():
    """(wrapper, counter attribute) of every kernel of the port."""
    from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_cuda
    from mmla_audio_torch.vad.collector import vad_collect_rows
    from mmla_audio_torch.vad.gmm import gmm_vad_rows
    from mmla_audio_torch.vad.webrtc import webrtc_vad_rows

    return ((overlap_model_input_cuda, "launches"),
            (overlap_model_input_cuda, "launches_grouped"),
            (fused_resblock_cuda, "launches"),
            (fused_resblock_cuda, "launches_mma"),
            (webrtc_vad_rows, "launches"),
            (vad_collect_rows, "launches"),
            (gmm_vad_rows, "launches")) + denoise_counters()


def denoise_counters():
    """(wrapper, counter attribute) of D1 (STFT and ISTFT) and D2: every
    denoise on the card launches them."""
    from mmla_audio_torch.ops.denoise import (istft_frames, smooth_mask,
                                              stft_ri)

    return ((stft_ri, "launches"), (istft_frames, "launches"),
            (smooth_mask, "launches"))


def denoise_launches() -> dict:
    """D1's launches (STFT + ISTFT) and D2's since the last zeroing."""
    (stft, _), (istft, _), (smooth, _) = denoise_counters()
    return dict(d1=stft.launches + istft.launches, d2=smooth.launches)


def zero_launch_counters() -> None:
    for fn, attr in launch_counters():
        setattr(fn, attr, 0)


def no_launches(path: str) -> dict:
    """The counters since ``zero_launch_counters``; raises unless all but
    the denoise kernels' are 0."""
    denoise = {id(fn) for fn, _ in denoise_counters()}
    launched = {f"{fn.__name__}.{attr}": getattr(fn, attr)
                for fn, attr in launch_counters()}
    others = [getattr(fn, attr) for fn, attr in launch_counters()
              if id(fn) not in denoise]
    if any(others):
        raise AssertionError(f"{path} launched a kernel: {launched}")
    return launched


def voice(seconds: float, speaker: int, seed: int,
          sr: int = 16000) -> np.ndarray:
    """Seeded synthetic speech of one voice: syllables of six harmonics of a
    gliding pitch between short pauses.  The pitch and the harmonics'
    weights are the speaker's (drawn from ``speaker``), the syllables and
    the noise from ``seed``."""
    spk = np.random.RandomState(1000 + speaker)
    f0, amps = spk.uniform(90.0, 300.0), spk.uniform(0.1, 1.0, 6)
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    out = np.zeros(n)
    i = 0
    while i < n:
        k = int(rng.uniform(0.15, 0.45) * sr)
        pitch = f0 * rng.uniform(0.9, 1.1) * (1 + 0.08 * np.linspace(-1, 1, k))
        phase = 2 * np.pi * np.cumsum(pitch) / sr
        syllable = np.hanning(k) * sum(a * np.sin((h + 1) * phase)
                                       for h, a in enumerate(amps))
        out[i:i + k] = syllable[: n - i]
        i += k + int(rng.uniform(0.05, 0.25) * sr)
    out += 0.01 * rng.randn(n)
    return (out / np.abs(out).max() * 12000).astype(np.int16)


def run_cli(argv, what: str) -> str:
    """``python -m mmla_audio_torch.cli *argv`` in a fresh process; its
    stdout, or a raise."""
    proc = subprocess.run(
        [sys.executable, "-m", "mmla_audio_torch.cli", *map(str, argv)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"CLI {what} failed ({proc.returncode}):\n"
                             f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def phase_registration(device, base_sd, cfg, noise, tmp: Path) -> None:
    """Enroll the speakers of ``SPEAKERS`` through ``SpeakerSession`` in its
    default arrangement;
    ``fit_once`` at the default ``TransferConfig`` on the card (cold, then
    warm) and on the CPU, and with one phase-2 epoch on both (the same split,
    head init and permutations: all come from CPU generators); then
    ``train_on_registered`` on the card and identify windows with the new
    head."""
    from mmla_audio_torch.data.corpus import featurize_corpus
    from mmla_audio_torch.data.wavio import read_wav
    from mmla_audio_torch.inference import SpeakerPredictor
    from mmla_audio_torch.params import load_speaker_npz
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.session import SpeakerSession
    from mmla_audio_torch.train.transfer import TransferLearner

    sr, mcfg, n_win = (cfg.audio.sample_rate, cfg.speaker_model,
                       cfg.audio.window_samples)
    enroll = [voice(ENROLL_SECONDS, k, seed=70 + k)
              for k in range(len(SPEAKERS))]
    ident = [voice(n_win / sr, k, seed=80 + i)
             for i, k in enumerate(IDENTIFY_VOICES)]
    # the session's default arrangement (on the card: D1, D2)
    sess = SpeakerSession(SpeakerPredictor(base_sd, mcfg, device=device),
                          PrefilledCapture(np.concatenate(enroll + ident)),
                          tmp / "register", cfg=cfg)
    sess.set_noise_profile(noise)
    t0 = time.perf_counter()
    kept = [len(read_wav(sess.register_speaker(name, ENROLL_SECONDS))[0])
            for name in SPEAKERS]
    t1 = time.perf_counter()
    x, y, sid = featurize_corpus(sess.dirs.corpus, cfg.speaker_feature,
                                 device=device)
    log(f"[train] enrolled {len(SPEAKERS)} voices of {ENROLL_SECONDS:.0f} s "
        f"in {t1 - t0:.3f} s (host clock; denoise, webrtc VAD, trim, WAV): "
        f"kept {[round(k / sr, 2) for k in kept]} s; corpus featurized in "
        f"{time.perf_counter() - t1:.3f} s: {len(x)} windows, {sid}")
    runs = {}
    full = (cfg.transfer.phase1_epochs, cfg.transfer.phase2_epochs)
    short = (cfg.transfer.phase1_epochs, 1)
    for key, dev, epochs in (("card, cold", device, full),
                             ("card", device, full),
                             ("cpu", torch.device("cpu"), full),
                             ("card", device, short),
                             ("cpu", torch.device("cpu"), short)):
        learner = TransferLearner(base_sd, len(SPEAKERS), mcfg, cfg.transfer,
                                  device=dev)
        _, acc, losses = learner.fit_once(x, y, seed=0,
                                          epochs_override=epochs)
        r = learner.report
        if not np.isfinite(losses).all():
            raise AssertionError(f"registration on {key}: losses {losses}")
        step = (f", {r['phase2_step_ms']:.3f} ms a phase-2 step (CUDA "
                f"events)" if r["phase2_step_ms"] is not None else "")
        log(f"[train] registration fit_once {epochs[0]}+{epochs[1]} epochs "
            f"on {key}: {r['n_train']} train / {r['n_val']} val windows "
            f"(train padded to {r['n_padded']}); phase 1 "
            f"{r['phase1_steps']} steps in {r['phase1_s']:.3f} s, phase 2 "
            f"{r['phase2_steps']} steps in {r['phase2_s']:.3f} s (host clock, "
            f"synchronized){step}; val acc {acc:.4f}, val loss "
            f"{r['val_loss']:.5f}; epoch loss {losses[0]:.5f} first, "
            f"{losses[-1]:.5f} last")
        runs[key, epochs] = acc, r["val_logits"]
    for epochs, drift in ((short, LOGIT_RTOL), (full, TRANSFER_DRIFT)):
        (acc_c, zc), (acc_0, z0) = runs["card", epochs], runs["cpu", epochs]
        err = float(np.abs(zc - z0).max())
        limit = drift * float(np.abs(z0).max())
        if err > limit or not np.isfinite(zc).all():
            raise AssertionError(
                f"registration {epochs} card vs CPU: max |dlogit| {err} > "
                f"{limit}")
        clear, rows = compare_labels("registration val", zc.argmax(1),
                                     z0.argmax(1), z0)
        log(f"[train] registration {epochs[0]}+{epochs[1]} epochs, warm card "
            f"vs CPU: val acc {acc_c:.4f} vs {acc_0:.4f}; val labels equal "
            f"where the "
            f"top-2 logit margin > {TOP2_MARGIN} ({clear}/{rows}); max "
            f"|dlogit| {err:.3g} = {err / float(np.abs(z0).max()):.3g} of max "
            f"|logit| (limit {drift})")

    t0 = time.perf_counter()
    acc = sess.train_on_registered(base_sd)
    seconds = time.perf_counter() - t0
    labels = [r[1] for r in sess.run(max_windows=len(IDENTIFY_VOICES))]
    _, head = load_speaker_npz(sess.dirs.model / "variables.npz", mcfg)
    if len(labels) != len(IDENTIFY_VOICES) or head != len(SPEAKERS) or \
            not set(labels) <= set(SPEAKERS) | {"silent"}:
        raise AssertionError(f"train_on_registered: head {head}, labels "
                             f"{labels}")
    log(f"[train] train_on_registered on the card (featurize, fit until the "
        f"gate, save, new predictor): val acc {acc:.4f} in {seconds:.3f} s "
        f"(host clock); identified {labels} for the voices of "
        f"{[SPEAKERS[k] for k in IDENTIFY_VOICES]}")


def dead_bias(key: str) -> bool:
    """A trunk convolution's bias: it feeds a train-mode BatchNorm
    (directly, or through the residual stream and a linear shortcut), so
    its exact gradient is zero and RMSprop scales rounding noise to a step
    of up to lr * sqrt(1 / (1 - rho)); two runs of n steps may differ by
    2 n lr sqrt(10) there (tests/test_torch_train.py holds the same rule
    against JAX)."""
    return key.startswith("trunk.") and key.endswith(
        ("stem.bias", "conv_a.bias", "conv_b.bias", "shortcut.bias"))


def phase_pretrain(device, base_sd, cfg) -> None:
    """``Trainer`` at b32 with the 630-way head on ``PRETRAIN_CLIPS``
    synthetic clips: ``PRETRAIN_STEPS`` steps card vs CPU with dropout 0,
    then two epochs timed on the card at the default config."""
    import dataclasses

    from mmla_audio_torch.data.corpus import featurize_clips
    from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
    from mmla_audio_torch.train.losses import keras_categorical_crossentropy
    from mmla_audio_torch.train.optimizers import rmsprop
    from mmla_audio_torch.train.trainer import Trainer

    mcfg, tcfg = cfg.speaker_model, cfg.speaker_train
    clips = [voice(2.6, i % PRETRAIN_SPEAKERS, seed=100 + i)
             for i in range(PRETRAIN_CLIPS)]
    labels = [f"spk{i % PRETRAIN_SPEAKERS}" for i in range(PRETRAIN_CLIPS)]
    t0 = time.perf_counter()
    x, y, _ = featurize_clips(clips, labels, dim=mcfg.num_speakers,
                              cfg=cfg.speaker_feature, device=device)
    log(f"[train] pretrain: {len(clips)} clips of {PRETRAIN_SPEAKERS} voices "
        f"featurized on the card in {time.perf_counter() - t0:.3f} s")

    def trainer(model_cfg, dev):
        model = SpeakerResBLSTM(model_cfg)
        model.load_state_dict(base_sd)
        return Trainer(model, rmsprop(tcfg.lr), keras_categorical_crossentropy,
                       extra_penalty_fn=lambda m: l2_penalty(m, model_cfg),
                       device=dev)

    no_drop = dataclasses.replace(mcfg, dropout_trunk=0.0, dropout_head=0.0)
    b = tcfg.batch_size
    runs = []
    for dev in (device, torch.device("cpu")):
        tr = trainer(no_drop, dev)
        losses = [float(tr.train_step(*(torch.from_numpy(a[i * b:(i + 1) * b])
                                        .to(dev) for a in (x, y)),
                                      torch.ones(b, device=dev))[0])
                  for i in range(PRETRAIN_STEPS)]
        runs.append((losses, tr.variables_of()))
    (lc, sc), (l0, s0) = runs
    rel = max(abs(a - c) / abs(c) for a, c in zip(lc, l0))
    worst, worst_key, noise = 0.0, None, 0.0
    noise_limit = 2 * PRETRAIN_STEPS * tcfg.lr * np.sqrt(10.0)
    for k, ref in s0.items():
        if not ref.is_floating_point():
            continue
        diff = float((sc[k] - ref).abs().max())
        if dead_bias(k):
            noise = max(noise, diff)
            continue
        scale = float(ref.abs().max())
        # a running mean takes 1 % a step of its batch mean, dead bias
        # included
        extra = 0.01 * PRETRAIN_STEPS * noise_limit \
            if k.endswith("running_mean") else 0.0
        if diff > PARAM_RTOL * scale + extra:
            raise AssertionError(f"pretrain card vs CPU: {k} max |diff| "
                                 f"{diff} > {PARAM_RTOL} x {scale} + {extra}")
        if scale and diff / scale > worst:
            worst, worst_key = diff / scale, k
    if rel > TRAIN_LOSS_RTOL or noise > noise_limit:
        raise AssertionError(f"pretrain card vs CPU: losses {lc} vs {l0}, "
                             f"dead-bias |diff| {noise} > {noise_limit}")
    log(f"[train] pretrain {PRETRAIN_STEPS} steps b{b} card vs CPU (dropout "
        f"0): losses {[round(v, 6) for v in lc]}, worst relative difference "
        f"{rel:.3g} (limit {TRAIN_LOSS_RTOL}); parameters and batch "
        f"statistics within {worst:.3g} of each leaf's max |value| (limit "
        f"{PARAM_RTOL}; worst {worst_key}), trunk conv biases within "
        f"{noise:.3g} (limit {noise_limit:.3g}: their exact gradient is "
        f"zero)")

    tr = trainer(mcfg, device)
    xt, yt = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    for epoch in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        hist = tr.fit(xt, yt, epochs=1, batch_size=b)
        end.record()
        torch.cuda.synchronize()
        steps = -(-len(x) // b)
        log(f"[train] pretrain epoch {epoch + 1} at the default config "
            f"(dropout on): {steps} steps b{b} in "
            f"{time.perf_counter() - t0:.3f} s (host clock), "
            f"{start.elapsed_time(end) / steps:.3f} ms a step (CUDA events); "
            f"loss {hist['loss'][0]:.4f}")


def phase_train_cli(tmp: Path, cfg) -> None:
    """``speaker-pretrain`` -> ``speaker-live --register`` ->
    ``speaker-post --weights``, each in a fresh process."""
    from mmla_audio_torch.analyze.logs import parse_log
    from mmla_audio_torch.data.wavio import write_wav

    sr = cfg.audio.sample_rate
    wavs, base = tmp / "pretrain_wavs", tmp / "pretrain_out"
    for i in range(12):
        write_wav(wavs / f"spk{i % 4}_{i // 4}.wav",
                  voice(2.6, i % 4, seed=200 + i), sr)
    out = run_cli(["speaker-pretrain", "--wav-dir", wavs, "--out", base,
                   "--epochs", "1"], "speaker-pretrain")
    if not (base / "variables.npz").exists():
        raise AssertionError(f"speaker-pretrain wrote nothing:\n{out}")
    log("[train] cli: " + " | ".join(ln for ln in out.splitlines()
                                     if ln.startswith(("[INFO]", "[TIME]"))))
    root = tmp / "register_cli"
    out = run_cli(["speaker-live", "--fake", "--register", "a", "b",
                   "--enroll-seconds", "10", "--phase1-epochs", "5",
                   "--phase2-epochs", "1", "--weights",
                   base / "variables.npz", "--root", root, "--windows", "2"],
                  "speaker-live --register")
    weights = root / "model" / "variables.npz"
    made = [(root / rel).exists() for rel in (
        "corpus/a.wav", "corpus/b.wav", "experiment_feature.npz",
        "speaker_id_dict.json", "model/variables.npz")]
    if not all(made) or out.count("[INFO] window ") != 2:
        raise AssertionError(f"speaker-live --register: files {made}\n{out}")
    log("[train] cli: " + " | ".join(
        ln for ln in out.splitlines()
        if ln.startswith(("[TIME]", "[INFO] registration", "[INFO] window"))))
    write_wav(root / "recordings" / "post-time" / "whole" / "zoom_reg.wav",
              np.concatenate([voice(15, k, seed=300 + k) for k in range(2)]),
              sr)
    out = run_cli(["speaker-post", "--root", root, "--weights", weights],
                  "speaker-post")
    rows = parse_log(root / "logs" / "zoom_reg.txt")
    if len(rows) != speaker_windows(30) or \
            not {r[1] for r in rows} <= {"a", "b", "silent"}:
        raise AssertionError(f"speaker-post of the registered model: {rows}")
    log("[train] cli: " + " | ".join(ln for ln in out.splitlines()
                                     if ln.startswith(("[INFO]", "[TIME]"))))


def phase_training(device, cfg, noise, tmp: Path) -> None:
    """Registration and pretrain at the full width of
    ``SpeakerModelConfig()``, from phase 7's seeded base tree (630-way
    head); like phase 7, it must launch none of the port's kernels but
    the denoise's."""
    from mmla_audio_torch.params import (speaker_state_dict_from_jax,
                                         speaker_tree_shapes)

    zero_launch_counters()
    mcfg = cfg.speaker_model
    base_sd = speaker_state_dict_from_jax(seeded_tree(
        speaker_tree_shapes(mcfg), np.random.RandomState(7)), mcfg)
    phase_registration(device, base_sd, cfg, noise, tmp)
    phase_pretrain(device, base_sd, cfg)
    phase_train_cli(tmp, cfg)
    log(f"[train] kernel launches on the training path: "
        f"{no_launches('the training path')}")


def profile_steps(run, steps: int, trace_dir=None) -> dict:
    """Warm ``run`` (which does ``steps`` steps) up, time it on the host
    clock (synchronized), then trace it with ``torch.profiler``: the
    device's busy time a step (the union of its kernels' and copies'
    intervals, user annotations left out), the idle share (1 - busy /
    host time), the launches a step and the five kernels of most device
    time.  ``busy_ms`` is None when the trace holds no device events.
    With ``trace_dir`` the traced run goes through the port's
    ``utils.timers.device_trace``, which also writes the Chrome trace
    there."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    if trace_dir is None:
        tracer = profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
    else:
        from mmla_audio_torch.utils.timers import device_trace

        tracer = device_trace(trace_dir)
    with tracer as prof:
        run()
        torch.cuda.synchronize()
    spans, names, kinds, denoise = [], Counter(), Counter(), Counter()
    for evt in prof.events():
        # record_function ranges (Optimizer.step, ...) also appear on the
        # device timeline; they are not work of the device
        if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            spans.append((evt.time_range.start, evt.time_range.end))
            names[evt.name] += evt.time_range.elapsed_us()
            kinds[kernel_kind(evt.name)] += evt.time_range.elapsed_us()
            for key in DENOISE_KERNELS:
                if key in evt.name:
                    denoise[key] += evt.time_range.elapsed_us() / 1e3 / steps
    out = dict(host_ms=host_ms, busy_ms=None, idle=None,
               launches=len(spans) / steps, top=[], kinds=[],
               denoise=dict(denoise))
    if spans:
        busy, end = 0, -1
        for a, b in sorted(spans):
            busy += max(0, b - max(a, end))
            end = max(end, b)
        out["busy_ms"] = busy / 1e3 / steps
        out["idle"] = 1 - out["busy_ms"] / host_ms
        out["top"] = [(n, us / 1e3 / steps) for n, us in names.most_common(5)]
        out["kinds"] = [(k, us / 1e3 / steps) for k, us in kinds.most_common()]
    return out


# D1's two kernels and D2's, by a substring of their device-event names
DENOISE_KERNELS = ("stft_rfft_kernel", "istft_irfft_kernel", "smooth_mask")
# substrings of device-event names -> a kind of work, first match wins
# cuBLAS's fp32 GEMMs on the H100 are named sm90_xmma_gemm_*, cuDNN's
# convolutions *_xmma_fprop_implicit_gemm_* (and dgrad, wgrad): "xmma" alone
# names neither
KERNEL_KINDS = (("denoise D1/D2", ("stft_rfft", "istft_irfft",
                                   "smooth_mask")),
                ("NCCL", ("nccl",)),
                ("convolution", ("conv", "fprop", "dgrad", "wgrad",
                                 "implicit")),
                ("LSTM", ("lstm", "rnn", "LSTM", "RNN")),
                ("GEMM", ("gemm", "cutlass", "cublas", "xmma")),
                ("reduction", ("reduce",)),
                ("elementwise", ("elementwise", "unrolled", "vectorized")),
                ("copy", ("Memcpy", "Memset", "copy", "Copy")))


def kernel_kind(name: str) -> str:
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def adadelta_noise_bound(lrs, rho: float = 0.95, eps: float = 1e-7) -> float:
    """The most two runs of Keras Adadelta steps at the rates ``lrs`` can
    move a parameter apart, whatever its gradients: a step is lr * g *
    sqrt(acc_delta + eps) / sqrt(acc + eps) with acc >= (1 - rho) g^2, so
    at most lr * sqrt((acc_delta + eps) / (1 - rho)), acc_delta growing
    with the steps it bounds (tests/test_torch_overlap_trainer.py holds
    JAX's training against the port by it)."""
    acc_delta, total = 0.0, 0.0
    for lr in lrs:
        step = np.sqrt((acc_delta + eps) / (1.0 - rho))
        total += lr * step
        acc_delta = rho * acc_delta + (1.0 - rho) * step * step
    return 2.0 * total


def speaker_clips(speaker: int, n_clips: int) -> np.ndarray:
    """``n_clips`` single-speaker 1.5 s clips of one seeded voice, a
    ``voice`` cut in pieces: ``(n_clips, 24000)`` int16."""
    return voice(1.5 * n_clips, speaker, seed=5000 + speaker).reshape(
        n_clips, -1)


def overlap_corpus(cfg) -> tuple:
    """The reference's corpus composition from seeded voices: 6,300 single
    clips (630 voices x 10 clips; made in a pool of processes, the host's
    numpy being the slow part) and 6,300 ``synthesize_corpus`` mixtures of
    them through the ``sink``.  -> ``(clips (630, 10, n) int16, mixtures
    (6300, n) int16, plan)``."""
    import concurrent.futures
    import multiprocessing
    import os

    from mmla_audio_torch.data.synth import synthesize_corpus

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1), mp_context=ctx) as pool:
        clips = np.stack(list(pool.map(
            speaker_clips, range(OVERLAP_SPEAKERS),
            [OVERLAP_CLIPS] * OVERLAP_SPEAKERS, chunksize=16)))
    n = cfg.overlap_feature.n_samples
    mixtures = np.zeros((OVERLAP_SPEAKERS * OVERLAP_CLIPS, n), np.int16)

    def sink(i, mix):
        mixtures[i, :len(mix)] = mix

    plan = synthesize_corpus(lambda sp, sm: (clips[sp, sm], f"spk{sp}"),
                             n_mixtures=len(mixtures),
                             n_speakers=OVERLAP_SPEAKERS,
                             clips_per_speaker=OVERLAP_CLIPS, seed=0,
                             sink=sink)
    return clips, mixtures, plan


def overlap_dead_bias(key: str) -> bool:
    """A residual block's ``conv0`` bias: it feeds only the train-mode
    ``bn1``, so its exact gradient is zero."""
    return key.startswith("blocks.") and key.endswith("conv0.bias")


def phase_overlap_steps(device, cfg, feats, y, trained) -> None:
    """Card against CPU: ``OVERLAP_STEPS`` train steps at b32, full width,
    dropout 0, the same Keras init and rows, the card's features copied to
    the CPU; then one evaluation of ``EVAL_WINDOWS`` windows of the trained
    model's variables ``trained``, the fused block on the card against the
    CPU's unfused path."""
    import dataclasses

    from mmla_audio_torch.models.overlap import OverlapResBLSTM, keras_init_
    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_cuda
    from mmla_audio_torch.precision import fp32_policy
    from mmla_audio_torch.train.losses import (
        cal_weighted_penalty, weighted_categorical_crossentropy)
    from mmla_audio_torch.train.optimizers import adadelta
    from mmla_audio_torch.train.schedules import cosine_annealing
    from mmla_audio_torch.train.trainer import Trainer

    tcfg, b = cfg.overlap_train, cfg.overlap_train.batch_size
    no_drop = dataclasses.replace(cfg.overlap_model, dropout=0.0)
    lr = cosine_annealing(tcfg.cosine_t_max, tcfg.cosine_eta_max,
                          tcfg.cosine_eta_min)(0)
    rows = np.random.RandomState(5).permutation(len(y))
    idx = torch.from_numpy(rows[:OVERLAP_STEPS * b]).to(device)
    x_card = feats[idx]
    y_rows = y[rows[:OVERLAP_STEPS * b]]
    weights = cal_weighted_penalty(y)
    runs = []
    for dev, x in ((device, x_card), (torch.device("cpu"), x_card.cpu())):
        model = keras_init_(OverlapResBLSTM(no_drop),
                            torch.Generator().manual_seed(0))
        tr = Trainer(model, adadelta(lr), lambda lg, t:
                     weighted_categorical_crossentropy(lg, t, weights),
                     device=dev)
        yt = torch.from_numpy(y_rows).to(dev)
        losses = [float(tr.train_step(x[i * b:(i + 1) * b],
                                      yt[i * b:(i + 1) * b],
                                      torch.ones(b, device=dev))[0])
                  for i in range(OVERLAP_STEPS)]
        runs.append((losses, tr.variables_of()))
    (lc, sc), (l0, s0) = runs
    rel = max(abs(a - c) / abs(c) for a, c in zip(lc, l0))
    noise_limit = adadelta_noise_bound([lr] * OVERLAP_STEPS)
    worst, worst_key, noise = 0.0, None, 0.0
    for k, ref in s0.items():
        if not ref.is_floating_point():
            continue
        diff = float((sc[k] - ref).abs().max())
        if overlap_dead_bias(k):
            noise = max(noise, diff)
            continue
        scale = float(ref.abs().max())
        # bn1's running mean takes 1 % a step of its batch mean, the dead
        # conv0 bias included
        extra = 0.01 * OVERLAP_STEPS * noise_limit \
            if k.endswith("bn1.running_mean") else 0.0
        if diff > PARAM_RTOL * scale + extra:
            raise AssertionError(f"overlap train card vs CPU: {k} max |diff| "
                                 f"{diff} > {PARAM_RTOL} x {scale} + {extra}")
        if scale and diff / scale > worst:
            worst, worst_key = diff / scale, k
    if rel > TRAIN_LOSS_RTOL or noise > noise_limit:
        raise AssertionError(f"overlap train card vs CPU: losses {lc} vs "
                             f"{l0}, dead-bias |diff| {noise} > "
                             f"{noise_limit}")
    log(f"[overlap] {OVERLAP_STEPS} train steps b{b} card vs CPU (full "
        f"width, dropout 0, lr {lr}): losses {[round(v, 6) for v in lc]}, "
        f"worst relative difference {rel:.3g} (limit {TRAIN_LOSS_RTOL}); "
        f"parameters and batch statistics within {worst:.3g} of each leaf's "
        f"max |value| (limit {PARAM_RTOL}; worst {worst_key}), conv0 biases "
        f"within {noise:.3g} (limit {noise_limit:.3g}: their exact gradient "
        f"is zero)")

    ev = torch.from_numpy(rows[-EVAL_WINDOWS:]).to(device)
    x_eval = feats[ev]
    probs, fused = [], []
    for dev, x in ((device, x_eval), (torch.device("cpu"), x_eval.cpu())):
        model = OverlapResBLSTM(cfg.overlap_model)
        model.load_state_dict(trained)
        model = model.to(dev).eval()
        before = fused_resblock_cuda.launches_mma
        with torch.no_grad(), fp32_policy(False):
            probs.append(torch.softmax(model(x), -1).cpu().numpy())
        fused.append(fused_resblock_cuda.launches_mma - before)
    blocks = len(cfg.overlap_model.stage_filters) * (
        cfg.overlap_model.blocks_per_stage - 1)
    if fused != [blocks, 0]:
        raise AssertionError(f"evaluation launched the fused block {fused} "
                             f"times (card, CPU), want {[blocks, 0]}")
    pc, p0 = probs
    clear, n = compare_labels("overlap evaluation", pc.argmax(1),
                              p0.argmax(1), p0)
    perr = float(np.abs(pc - p0).max())
    if not perr <= PROB_ATOL:
        raise AssertionError(f"overlap evaluation card vs CPU: max |dprob| "
                             f"{perr} > {PROB_ATOL}")
    log(f"[overlap] evaluation of {EVAL_WINDOWS} windows by the trained "
        f"model, fused block on the card vs unfused on the CPU: labels equal "
        f"where the CPU's top-2 probability margin > {TOP2_MARGIN} "
        f"({clear}/{n}); max |dprob| {perr:.3g} (atol {PROB_ATOL})")


def phase_overlap_rebalance(device, feats, y) -> None:
    """``augment_to_balance`` of a 2:1 subset on the card against the
    CPU."""
    from mmla_audio_torch.train.overlap_trainer import augment_to_balance

    single = np.where(y[:, 0] == 1)[0][:128]
    over = np.where(y[:, 1] == 1)[0][:64]
    rows = np.concatenate([single, over])
    x = feats[torch.from_numpy(rows).to(device)]
    (xc, yc), (x0, y0) = (augment_to_balance(x, y[rows]),
                          augment_to_balance(x.cpu(), y[rows]))
    err = float((xc.cpu() - x0).abs().max())
    if not (np.array_equal(yc, y0) and yc.sum(0).tolist() == [128, 128]
            and xc.is_cuda and err <= 1e-4):
        raise AssertionError(f"rebalancing card vs CPU: counts "
                             f"{yc.sum(0)}, max |diff| {err}")
    log(f"[overlap] rebalancing 128 + 64 windows on the card: 64 blurred "
        f"copies, 128 + 128 rows; max |diff| vs the CPU {err:.3g} (limit "
        f"1e-4)")


def phase_overlap_cli(tmp: Path, cfg, clips: np.ndarray, noise,
                      recording: np.ndarray) -> None:
    """``synth-corpus`` over a flat WAV directory of ``CLI_SINGLES``
    corpus clips, ``overlap-train --augmented --out D`` on them and the
    mixtures, and ``overlap-post --weights D/variables.npz`` on a
    recording: its labels equal the CPU's of the same checkpoint where the
    CPU's top-2 margin is clear."""
    from mmla_audio_torch.analyze.logs import parse_log
    from mmla_audio_torch.analyze.post_time import overlap_post_analyze
    from mmla_audio_torch.data.wavio import write_wav
    from mmla_audio_torch.inference import OverlapPredictor
    from mmla_audio_torch.params import (load_overlap_npz,
                                         overlap_state_dict_from_jax)

    sr = cfg.audio.sample_rate
    singles, mixes, model = (tmp / d for d in ("overlap_singles",
                                               "overlap_mixes",
                                               "overlap_model"))
    flat = clips.reshape(-1, clips.shape[-1])
    for k in range(CLI_SINGLES):
        write_wav(singles / f"spk{k // OVERLAP_CLIPS:03d}_"
                  f"{k % OVERLAP_CLIPS}.wav", flat[k], sr)
    t0 = time.perf_counter()
    out = run_cli(["synth-corpus", "--wav-dir", singles, "--out-dir", mixes,
                   "--n-mixtures", CLI_MIXTURES], "synth-corpus")
    synth_s = time.perf_counter() - t0
    if len(list(mixes.glob("Overlap*.wav"))) != CLI_MIXTURES:
        raise AssertionError(f"synth-corpus wrote too few mixtures:\n{out}")
    t0 = time.perf_counter()
    out = run_cli(["overlap-train", "--single-dir", singles, "--overlap-dir",
                   mixes, "--epochs", CLI_EPOCHS, "--augmented", "--out",
                   model], "overlap-train")
    train_s = time.perf_counter() - t0
    if "[RESULT] test accuracy: " not in out or \
            not (model / "variables.npz").exists():
        raise AssertionError(f"overlap-train: no result or checkpoint:\n"
                             f"{out}")
    log(f"[overlap] cli: synth-corpus of {CLI_MIXTURES} mixtures in "
        f"{synth_s:.1f} s, overlap-train of {CLI_SINGLES} + {CLI_MIXTURES} "
        f"windows, {CLI_EPOCHS} epochs, --augmented in {train_s:.1f} s "
        f"(fresh processes): " + " | ".join(
            ln.replace("\n", " ") for ln in out.splitlines()
            if ln.startswith(("[TIME]", "[RESULT]", "epoch", " [", "[["))))
    weights = model / "variables.npz"
    name = "audio_conv0"
    cli_root, cpu_root = tmp / "overlap_post_cli", tmp / "overlap_post_cpu"
    write_experiment(cli_root, {name: recording}, noise, sr)
    dirs = write_experiment(cpu_root, {name: recording}, noise, sr)
    out = run_cli(["overlap-post", "--root", cli_root, "--weights", weights,
                   "--precision", "highest"], "overlap-post")
    state_dict = overlap_state_dict_from_jax(
        load_overlap_npz(weights, cfg.overlap_model), cfg.overlap_model)
    pred = ProbsTap(OverlapPredictor(state_dict, cfg.overlap_model,
                                     device="cpu",
                                     matmul_precision="highest"))
    overlap_post_analyze(dirs, pred, cfg=cfg, noise=noise)
    got = [r[1] for r in parse_log(cli_root / "logs" / f"{name}.txt")]
    ref = [r[1] for r in parse_log(cpu_root / "logs" / f"{name}.txt")]
    clear = clear_rows(pred.probs[0])
    if len(got) != len(ref) or not all(
            a == b for a, b, c in zip(got, ref, clear) if c):
        raise AssertionError(f"overlap-post of the trained checkpoint: card "
                             f"{got} vs CPU {ref}")
    log(f"[overlap] cli: overlap-post --weights {weights.name} of the "
        f"trained checkpoint: {len(got)} windows, labels == the CPU's where "
        f"the top-2 margin > {TOP2_MARGIN} ({int(clear.sum())}/{len(got)}); "
        + " | ".join(ln for ln in out.splitlines()
                     if ln.startswith("[TIME]")))


def phase_overlap_training(device, cfg, noise, tmp: Path, clips) -> dict:
    """Overlap-detector training at the full width of
    ``OverlapModelConfig()`` on the reference's corpus composition: the
    featurizer kernel builds the 12,600-window corpus in one call,
    ``OverlapTrainer.train`` runs ``OVERLAP_EPOCHS`` epochs at b32, and the
    fused block runs each epoch's validation, never a train step.  Returns
    the launches of that run, counted from 0."""
    import dataclasses

    from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_cuda
    from mmla_audio_torch.ops.features import overlap_model_input
    from mmla_audio_torch.train.overlap_trainer import OverlapTrainer

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    corpus_clips, mixtures, plan = overlap_corpus(cfg)
    singles = corpus_clips.reshape(-1, corpus_clips.shape[-1])
    audio = np.concatenate([singles, mixtures]).astype(np.float32) / 32768.0
    y = np.eye(2, dtype=np.float32)[[0] * len(singles) + [1] * len(mixtures)]
    speakers = [len(e.speaker_ids) for e in plan]
    log(f"[overlap] corpus: {len(singles)} single clips of "
        f"{OVERLAP_SPEAKERS} seeded voices and {len(mixtures)} mixtures "
        f"({speakers.count(2)}/{speakers.count(3)}/{speakers.count(4)}/"
        f"{speakers.count(5)} of 2/3/4/5 speakers) in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    tcfg = dataclasses.replace(cfg.overlap_train, epochs=OVERLAP_EPOCHS)
    trainer = OverlapTrainer(cfg.overlap_model, tcfg, device=device)
    zero_launch_counters()
    y_dev = torch.from_numpy(audio).to(device)
    torch.cuda.reset_peak_memory_stats(device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    feats = overlap_model_input_cuda(y_dev, cfg.overlap_feature)
    events[1].record()
    with timed_steps() as steps:
        _, hist, (x_test, _) = trainer.train(feats, y, weighted=True,
                                             augmented=False, seed=0)
    launches = (overlap_model_input_cuda.launches,
                fused_resblock_cuda.launches_mma)
    trained = trainer.trainer.variables_of()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    featurize_ms = events[0].elapsed_time(events[1])
    # the path's call is the process's first launch at this batch; warm
    featurize_warm = time_ms(overlap_model_input_cuda, y_dev,
                             cfg.overlap_feature, reps=2, rounds=3)
    chunks = -(-len(x_test) // tcfg.eval_batch_size)
    blocks = len(cfg.overlap_model.stage_filters) * (
        cfg.overlap_model.blocks_per_stage - 1)
    want = (1, blocks * chunks * len(hist["loss"]))
    if launches != want or fused_resblock_cuda.launches != want[1] or \
            len(hist["loss"]) != OVERLAP_EPOCHS or \
            not np.isfinite(hist["loss"] + hist["val_loss"]).all():
        raise AssertionError(f"overlap training: launches (featurizer, fused "
                             f"block) {launches}, want {want}; history "
                             f"{hist}")
    per_epoch = len(steps) // OVERLAP_EPOCHS
    step_ms = statistics.median(steps[per_epoch:])
    r = trainer.report
    log(f"[overlap] featurizer kernel over all {len(audio)} windows in one "
        f"call: {featurize_ms:.3f} ms (CUDA events; warm "
        f"{featurize_warm:.3f} ms), bound "
        f"{featurizer_bound(len(audio))['bound_ms']:.4f} ms; "
        f"{OVERLAP_EPOCHS} epochs of {per_epoch} steps b{tcfg.batch_size} "
        f"over {per_epoch * tcfg.batch_size} padded rows: step median "
        f"{step_ms:.3f} ms (CUDA events, epoch 2), epochs "
        f"{[round(v, 3) for v in r['epoch_s']]} s (host clock), validation "
        f"of {len(x_test)} windows {[round(v * 1e3, 1) for v in r['val_s']]} "
        f"ms in {chunks} chunks; launches: featurizer {launches[0]}, fused "
        f"block {launches[1]} (= {blocks} x {chunks} chunks x "
        f"{len(hist['loss'])} validations, none in the "
        f"{len(steps)} train steps); peak memory {peak_gib:.2f} GiB; loss "
        f"{[round(v, 5) for v in hist['loss']]}, val acc "
        f"{[round(v, 4) for v in hist['val_acc']]}")
    sub = torch.from_numpy(np.random.RandomState(3).choice(
        len(audio), FEATURE_CHECK, replace=False)).to(device)
    err, share = check_budget(f"featurizer on {FEATURE_CHECK} corpus windows",
                              feats[sub],
                              overlap_model_input(y_dev[sub],
                                                  cfg.overlap_feature))
    log(f"[overlap] featurizer vs plain on {FEATURE_CHECK} corpus windows: "
        f"max |diff| {err} on {share:.4%} of pixels")
    del y_dev

    b = tcfg.batch_size
    order = torch.from_numpy(np.random.RandomState(4).permutation(
        len(y))[:PROFILE_STEPS * b]).to(device)
    yt, ones = torch.from_numpy(y).to(device), torch.ones(b, device=device)
    tr = trainer.trainer

    def run():
        for i in range(PROFILE_STEPS):
            idx = order[i * b:(i + 1) * b]
            tr.train_step(feats[idx], yt[idx], ones)
    prof = profile_steps(run, PROFILE_STEPS)
    busy = "not measured (no device events in the trace)" \
        if prof["busy_ms"] is None else \
        (f"device busy {prof['busy_ms']:.3f} ms (idle share "
         f"{prof['idle']:.3f}); top kernels (ms a step): " + ", ".join(
             f"{n[:50]} {ms:.3f}" for n, ms in prof["top"]))
    log(f"[overlap] profile of {PROFILE_STEPS} train steps b{b}: host "
        f"{prof['host_ms']:.3f} ms a step; {busy}; by kind (ms a step): "
        + ", ".join(f"{k} {ms:.3f}" for k, ms in prof["kinds"])
        + f"; {prof['launches']:.1f} launches a step")

    phase_overlap_steps(device, cfg, feats, y, trained)
    phase_overlap_rebalance(device, feats, y)
    del feats, x_test, trainer, tr
    torch.cuda.empty_cache()
    phase_overlap_cli(tmp, cfg, corpus_clips, noise, clips["audio_conv0"])
    log(f"[overlap] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return dict(featurizer=launches[0], block=launches[1])


# -- phase 10: the multiplexer ---------------------------------------------

def vad_windows(count: int, seed: int, n: int = 40960) -> np.ndarray:
    """``count`` int16 windows of synthetic speech with silent stretches."""
    from mmla_audio_torch.streaming.capture import FakePCMSource

    src = FakePCMSource(seed=seed, speech_ratio=0.6)
    return np.stack([src.read(n) for _ in range(count)])


def ambient(seed: int) -> np.ndarray:
    """10 s of ambient noise, its level drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    return (rng.randn(160000) * rng.uniform(10, 40)).astype(np.int16)


def denoised_i16(device, cfg, raw: np.ndarray, noise) -> torch.Tensor:
    """The live chain's denoised int16 windows ``(B, T * frame_len)`` on
    ``device``: the input W1 sees in the multiplexer, in chunks of 64."""
    from mmla_audio_torch.ops.denoise import (noise_threshold, quantize_i16,
                                              reduce_noise)

    nt = noise_threshold(torch.from_numpy(noise.astype(np.float32) / 32768.0)
                         .to(device), cfg.denoise)
    fl = VAD_FRAME
    out = []
    for chunk in np.array_split(raw, max(1, -(-len(raw) // 64))):
        y = torch.from_numpy(chunk).to(device).float() / 32768.0
        y = reduce_noise(y, nt, cfg.denoise, passes=cfg.denoise.passes_live)
        out.append(quantize_i16(y)[:, : VAD_T * fl].to(torch.int16))
    return torch.cat(out)


def w1_bound(batch: int, rows: int) -> dict:
    """W1's bytes: the windows' samples read once, each named state row
    read and written, the index, the decisions written."""
    return bound(0, batch * (VAD_T * VAD_FRAME * 2 + 4 + VAD_T)
                 + 2 * rows * 265 * 4)


def sm_clock_mhz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reads it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])


def w1_chain_ms() -> float:
    """W1's serial floor: the decimator's chain, ``VAD_T * VAD_FRAME / 2``
    dependent steps a window (20,400), each ``W1_STEP_OPS`` dependent
    integer operations of ``INT_LATENCY`` cycles (read from the source,
    not from its SASS: shift, add, the int16 truncation, multiply, shift,
    subtract), at the card's highest SM clock as ``nvidia-smi`` reads it."""
    steps = VAD_T * VAD_FRAME // 2
    return steps * W1_STEP_OPS * INT_LATENCY / (sm_clock_mhz() * 1e6) * 1e3


def w2_bound(batch: int) -> dict:
    """W2's bytes: decisions and counts in, keep masks and kept counts out."""
    return bound(0, batch * 2 * (VAD_T + 4))


def host_ms(fn, *args, reps: int = 3) -> float:
    """Median host-clock time of ``fn(*args)`` (host work only)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_w1(device, pool, rows, batch: int, rng, launch=None) -> int:
    """W1 against the host engine on the same windows and starting rows:
    ``batch`` rows naming adapted rows, the fresh last row and 3 padding
    rows, ``VAD_WINDOWS`` windows in a row; decisions and every state row
    bit for bit after each, rows not named unchanged.  ``launch(x, states,
    idx)``: another launch of W1 to hold (default the wrapper).  Returns the
    largest |difference| (0, or a raise)."""
    from mmla_audio_torch.vad.webrtc import (webrtc_vad_rows,
                                             webrtc_vad_rows_plain)

    n_states = len(rows)
    named = np.concatenate([rng.permutation(n_states - 1)[: batch - 4],
                            [n_states - 1]])
    idx = rng.permutation(np.concatenate(
        [named, [n_states, n_states + 1, n_states + 7]])).astype(np.int32)
    plain, card = rows.clone(), rows.to(device)
    picks = rng.choice(len(pool), (VAD_WINDOWS, batch), replace=False)
    for w in range(VAD_WINDOWS):
        x = pool[torch.from_numpy(picks[w]).to(pool.device)]
        got = (launch or webrtc_vad_rows)(x, card, idx)
        ref = webrtc_vad_rows_plain(x.cpu(), plain, idx)
        torch.cuda.synchronize()
        got_rows = card.cpu()
        err = max(int((got.cpu().int() - ref.int()).abs().max()),
                  int((got_rows - plain).abs().max()))
        untouched = torch.from_numpy(~np.isin(np.arange(n_states), named))
        if err or not torch.equal(got_rows[untouched], rows[untouched]):
            raise AssertionError(f"W1 B={batch} window {w}: max |diff| "
                                 f"{err} against the host engine, or a row "
                                 f"not named changed")
    return 0


def check_w2(device, decisions: torch.Tensor, rng) -> int:
    """W2 against ``collect_mask`` per row: keep masks and counts equal."""
    from mmla_audio_torch.vad.collector import (vad_collect_rows,
                                                vad_collect_rows_plain)

    n_valid = torch.from_numpy(rng.randint(0, VAD_T + 1, len(decisions))
                               .astype(np.int32))
    n_valid[::3] = VAD_T
    keep, kept = vad_collect_rows(decisions.to(device), n_valid.to(device))
    ref_keep, ref_kept = vad_collect_rows_plain(decisions.cpu(), n_valid)
    err = max(int((keep.cpu().int() - ref_keep.int()).abs().max()),
              int((kept.cpu() - ref_kept).abs().max()))
    if err:
        raise AssertionError(f"W2 B={len(decisions)}: max |diff| {err}")
    return err


def phase_vad_kernels(device, cfg) -> tuple:
    """W1 and W2 against their plain versions on the card, then timed.
    Returns the kernels-line measurements of (W1, W2)."""
    from mmla_audio_torch.vad.collector import (energy_vad, vad_collect_rows,
                                                vad_collect_rows_plain)
    from mmla_audio_torch.vad.webrtc import (webrtc_init, webrtc_vad_rows,
                                             webrtc_vad_rows_plain)

    rng = np.random.RandomState(10)
    noise = ambient(11)
    raw = vad_windows(VAD_ROWS * (VAD_WARMUP + VAD_WINDOWS), seed=12)
    pool = denoised_i16(device, cfg, raw, noise)
    # VAD_ROWS rows that already carry VAD_WARMUP windows, then a fresh one
    rows = webrtc_init(VAD_ROWS + 1, "cpu")
    warm = pool[: VAD_ROWS * VAD_WARMUP].cpu().reshape(
        VAD_ROWS, VAD_WARMUP, -1)
    for w in range(VAD_WARMUP):
        webrtc_vad_rows_plain(warm[:, w].contiguous(), rows,
                              np.arange(VAD_ROWS))
    pool = pool[VAD_ROWS * VAD_WARMUP:]
    for batch in (8, 64):
        check_w1(device, pool, rows, batch, rng)
    log(f"[vad] W1 (webrtc_vad) == host engine bit for bit at B=8 and 64: "
        f"{VAD_WINDOWS} windows in a row on rows carrying {VAD_WARMUP} "
        f"windows of state, one fresh row and 3 padding rows (untouched)")
    times, chain = {}, w1_chain_ms()
    for batch in W1_BATCHES:
        x = pool[torch.arange(batch, device=device) % len(pool)]
        states = rows[np.arange(batch) % VAD_ROWS].contiguous()
        card, idx = states.to(device), np.arange(batch, dtype=np.int32)
        reps = 20 if batch <= 8 else 5
        ms = time_ms(lambda: webrtc_vad_rows(x, card, idx), reps=reps,
                     rounds=3)
        plain = host_ms(webrtc_vad_rows_plain, x.cpu(), states.clone(), idx)
        times[batch] = ms, plain
        log(f"[vad] W1 B={batch}: kernel {ms:.4f} ms (CUDA events), host "
            f"engine over the same rows {plain:.4f} ms (host clock, one "
            f"core), bounds {w1_bound(batch, batch)['bound_ms'] * 1e3:.3f} "
            f"us (bytes) and {chain:.4f} ms (the decimator's serial chain, "
            f"the floor that binds)")
    # W2 on W1's decisions and on energy decisions of the same windows
    x = pool[:VAD_ROWS]
    dec = torch.cat([
        webrtc_vad_rows(x, rows[:VAD_ROWS].to(device),
                        np.arange(VAD_ROWS, dtype=np.int32)),
        energy_vad(x.reshape(VAD_ROWS, VAD_T, VAD_FRAME), 40.0)])
    check_w2(device, dec.to(torch.uint8), rng)
    # W2 timed on rows of those decisions at every n_valid = T, each batch
    # checked first; beside its bytes and the launch floor (an empty kernel
    # queued behind the same sleep)
    floor, w2_times = queued_ms(torch.cuda._sleep, 0), {}
    for batch in W1_BATCHES:
        rows = dec[torch.arange(batch, device=dec.device) % len(dec)]
        n_valid = torch.full((batch,), VAD_T, dtype=torch.int32)
        check_w2(device, rows.to(torch.uint8), rng)
        nv = n_valid.to(device)
        ms = time_ms(vad_collect_rows, rows, nv, reps=50)
        alone = queued_ms(vad_collect_rows, rows, nv)
        plain = host_ms(vad_collect_rows_plain, rows.cpu(), n_valid)
        w2_times[batch] = ms, plain
        log(f"[vad] W2 B={batch}: time_ms {ms:.4f}, queued_ms {alone:.4f} "
            f"(launch floor {floor:.4f}), collect_mask per row {plain:.4f} "
            f"ms (host clock), bound "
            f"{w2_bound(batch)['bound_ms'] * 1e3:.4f} us (bytes)")
    log(f"[vad] W2 (vad_collect) == collect_mask per row on "
        f"{2 * VAD_ROWS} rows (webrtc and energy decisions) and at every "
        f"timed batch")
    w2_ms, w2_plain = w2_times[VAD_ROWS]
    w1 = dict(max_abs_err=0, ms=times[64][0], plain_ms=times[64][1],
              **w1_bound(64, 64), library_ms=None)
    w2 = dict(max_abs_err=0, ms=w2_ms, plain_ms=w2_plain,
              **w2_bound(VAD_ROWS), library_ms=None)
    return w1, w2


def mux_launches() -> dict:
    """The launches of the multiplexer's kernels since the last zeroing."""
    from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_cuda
    from mmla_audio_torch.vad.collector import vad_collect_rows
    from mmla_audio_torch.vad.webrtc import webrtc_vad_rows

    return dict(w1=webrtc_vad_rows.launches, w2=vad_collect_rows.launches,
                b1=overlap_model_input_cuda.launches,
                b3=fused_resblock_cuda.launches_mma, **denoise_launches())


def add_launches(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def serve(mux, captures) -> tuple:
    """Run ``mux`` over its streams from zeroed counters; (windows, host
    seconds, launches)."""
    zero_launch_counters()
    t0 = time.perf_counter()
    total = mux.run_until_exhausted()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for cap in captures:
        cap.stop()
    return total, seconds, mux_launches()


def check_logs(mux, windows: int, what: str) -> None:
    """Every stream logged each of its windows once, in order."""
    from mmla_audio_torch.analyze.logs import parse_log

    for s in mux.streams:
        rows = parse_log(s.log.path)
        if [r[0] for r in rows] != list(range(1, windows + 1)) \
                or len(s.results) != windows:
            raise AssertionError(f"{what}: stream {s.name} logged "
                                 f"{[r[:2] for r in rows]}")


def mux_vs_sessions(device, pred, session_cls, kind, cfg, tmp: Path,
                    n_streams: int, total: dict) -> None:
    """``n_streams`` streams x ``MUX_LABEL_WINDOWS`` windows through the
    multiplexer and each through a single-stream session of ``session_cls``
    (its chain on the card, ``host_preprocess=False``) on the same audio and
    noise profile: labels equal where the session's top-2 margin exceeds
    ``TOP2_MARGIN``.  The batched denoise (recomputed at the multiplexer's
    bucket) equal to the single-window one in every int16 sample (D1 and
    D2 make each window's bits independent of the batch); each stream's
    detector row equal bit for bit to the host engine run over those
    windows and to the single-stream session's own engine."""
    from mmla_audio_torch.ops.denoise import quantize_i16, reduce_noise
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.multiplex import Multiplexer
    from mmla_audio_torch.vad.webrtc import webrtc_init, webrtc_vad_rows_plain

    convs = [vad_windows(MUX_LABEL_WINDOWS, seed=200 + s)
             for s in range(n_streams)]
    noises = [ambient(300 + s) for s in range(n_streams)]
    mux = Multiplexer(pred, tmp / f"mux_{kind}", kind=kind, cfg=cfg,
                      device=device)
    for s in range(n_streams):
        mux.add_stream(f"s{s}", PrefilledCapture(np.concatenate(convs[s])),
                       noises[s])
    got, _, launches = serve(mux, [])
    add_launches(total, launches)
    if got != n_streams * MUX_LABEL_WINDOWS:
        raise AssertionError(f"multiplexer {kind}: {got} windows resolved")
    check_logs(mux, MUX_LABEL_WINDOWS, f"multiplexer {kind}")
    # every window denoised in a batch of the multiplexer's bucket (zero
    # padding rows, as it pads) and alone, kept as int16
    bucket = next(b for b in mux.buckets if b >= n_streams)
    nts = torch.zeros((bucket, len(mux.streams[0].noise_thresh)))
    nts[:n_streams] = torch.stack([torch.from_numpy(t.noise_thresh)
                                   for t in mux.streams])
    nts = nts.to(device)
    batched, single = [], []
    for w in range(MUX_LABEL_WINDOWS):
        batch = torch.zeros((bucket, len(convs[0][w])))
        batch[:n_streams] = torch.from_numpy(
            np.stack([c[w] for c in convs]).astype(np.float32))
        y = batch.to(device) / 32768.0
        batched.append(quantize_i16(reduce_noise(
            y, nts[:, None, :], cfg.denoise,
            passes=cfg.denoise.passes_live))[:n_streams].cpu())
        single.append(torch.stack([quantize_i16(reduce_noise(
            y[s], nts[s], cfg.denoise, passes=cfg.denoise.passes_live)).cpu()
            for s in range(n_streams)]))
    clear = 0
    differing = []
    n_vad = VAD_T * VAD_FRAME
    for s, stream in enumerate(mux.streams):
        sess = session_cls(pred, None, tmp / f"single_{kind}{s}", cfg=cfg,
                           host_preprocess=False)
        sess.set_noise_profile(noises[s])
        labels, margins = [], []
        for w in convs[s]:
            name, probs = sess.process_window(w)
            top2 = np.sort(probs)[-2:]
            labels.append(name)
            margins.append(top2[1] - top2[0])
        mux_labels = [r[1] for r in stream.results]
        ok = np.array(margins) > TOP2_MARGIN
        if not (np.array(mux_labels)[ok] == np.array(labels)[ok]).all():
            raise AssertionError(f"multiplexer {kind} stream {s}: "
                                 f"{mux_labels} vs session {labels}")
        clear += int(ok.sum())
        diff = sum(int((b[s] != a[s]).sum()) for b, a in zip(batched, single))
        differing.append(diff)
        ref = webrtc_init(1, "cpu")
        for b in batched:
            webrtc_vad_rows_plain(b[s: s + 1, :n_vad].to(torch.int16), ref,
                                  [0])
        row = mux._webrtc_states[stream.index].cpu()
        if diff or not torch.equal(row, ref[0]) or not np.array_equal(
                row.numpy(), sess._vad.state_array):
            raise AssertionError(f"multiplexer {kind} stream {s}: {diff} "
                                 f"int16 samples of the batched denoise "
                                 f"differ from the single-window one, or the "
                                 f"detector row != the host engine's / the "
                                 f"session's")
    log(f"[mux] {kind}: {n_streams} streams x {MUX_LABEL_WINDOWS} windows, "
        f"labels == single-stream session where the top-2 margin > "
        f"{TOP2_MARGIN} ({clear}/{n_streams * MUX_LABEL_WINDOWS}); int16 "
        f"samples of the batched denoise differing from the single-window "
        f"one, per stream (of {MUX_LABEL_WINDOWS * len(convs[0][0])}): "
        f"{differing}; every detector row == the host engine over those "
        f"windows and == the single-stream session's own engine, bit for "
        f"bit")


def phase_mux_serving(device, pred, cfg, tmp: Path, total: dict) -> dict:
    """The overlap multiplexer at a realistic size: ``MUX_THREADED``
    threaded captures, then ``MUX_PREFILLED`` prefilled ones; windows/s,
    phase times, launches; one profiled warm tick at bucket 64."""
    from mmla_audio_torch.streaming.capture import (ArraySource,
                                                    CaptureThread,
                                                    PrefilledCapture)
    from mmla_audio_torch.streaming.multiplex import Multiplexer

    convs = [vad_windows(MUX_THREADED_WINDOWS, seed=400 + s).ravel()
             for s in range(MUX_THREADED)]
    noises = [ambient(500 + k) for k in range(4)]
    n_win = cfg.audio.window_samples
    out = {}
    for name, n_streams, windows in (
            ("threaded", MUX_THREADED, MUX_THREADED_WINDOWS),
            ("prefilled", MUX_PREFILLED, MUX_PREFILLED_WINDOWS)):
        mux = Multiplexer(pred, tmp / f"serve_{name}", cfg=cfg,
                          device=device)
        caps = []
        for s in range(n_streams):
            start = (s // MUX_THREADED) % (MUX_THREADED_WINDOWS - windows + 1)
            audio = convs[s % MUX_THREADED][start * n_win:
                                            (start + windows) * n_win]
            cap = CaptureThread(ArraySource(audio), cfg.audio).start() \
                if name == "threaded" else PrefilledCapture(audio)
            caps.append(cap)
            mux.add_stream(f"{name}{s}", cap, noises[s % len(noises)])
        got, seconds, launches = serve(mux, caps)
        add_launches(total, launches)
        expect = n_streams * windows
        if got != expect or mux.windows_resolved != expect:
            raise AssertionError(f"serving {name}: {got} of {expect}")
        check_logs(mux, windows, f"serving {name}")
        rate = got / seconds
        phases = ", ".join(f"{k} {v / got * 1e3:.4f}"
                           for k, v in mux.phase_seconds.items())
        log(f"[mux] serving {n_streams} {name} streams x {windows} windows "
            f"({got}): {seconds:.3f} s, {rate:.1f} windows/s, "
            f"{seconds / got * 1e3:.4f} ms a window, {rate * 2.56:.0f} "
            f"realtime-stream equivalents; ms a window by phase: {phases} "
            f"(host side {mux.host_side_seconds() / got * 1e3:.4f}); "
            f"launches W1 {launches['w1']}, W2 {launches['w2']}, B1 "
            f"{launches['b1']}, B3 {launches['b3']}; each logged once, in "
            f"order")
        out[name] = rate
    # one warm tick at bucket 64, profiled
    mux = Multiplexer(pred, tmp / "serve_profile", cfg=cfg, device=device)
    for s in range(64):
        mux.add_stream(f"p{s}", PrefilledCapture(
            convs[s][: 3 * n_win]), noises[s % len(noises)])

    def run():
        if mux.tick() != 0 or mux.flush() != 64:
            raise AssertionError("the profiled tick did not resolve 64")
    trace_dir = tmp / "tick_trace"
    prof = profile_steps(run, 1, trace_dir)
    traces = list(trace_dir.glob("trace-*.json"))
    if len(traces) != 1 or "webrtc_vad_kernel" not in traces[0].read_text():
        raise AssertionError(f"device_trace wrote {traces}, without W1's "
                             f"kernel")
    log(f"[mux] device_trace wrote {traces[0].name} "
        f"({traces[0].stat().st_size} bytes), naming webrtc_vad_kernel")
    busy = "not measured (no device events in the trace)" \
        if prof["busy_ms"] is None else \
        (f"device busy {prof['busy_ms']:.3f} ms (idle share "
         f"{prof['idle']:.3f}); top kernels (ms): " + ", ".join(
             f"{n[:50]} {ms:.3f}" for n, ms in prof["top"]))
    log(f"[mux] profile of one tick at bucket 64 (gather, dispatch, label "
        f"fetch): host {prof['host_ms']:.3f} ms; {busy}; by kind (ms): "
        + ", ".join(f"{k} {ms:.3f}" for k, ms in prof["kinds"])
        + f"; {prof['launches']:.0f} launches; the denoise kernels (ms): "
        + ", ".join(f"{k} {ms:.4f}" for k, ms in prof["denoise"].items()))
    denoise_profile_vs_events(device, cfg)
    return out


def denoise_profile_vs_events(device, cfg) -> None:
    """D1's two kernels and D2 at the tick's shape (64 live windows, one
    pass), each timed three ways on the same inputs: ``time_ms`` (CUDA
    events over back-to-back calls), ``queued_ms`` (the card alone) and
    the mean kernel duration in a profiler trace of ``reps`` back-to-back
    calls, beside the count of the calls the trace holds (a trace can
    miss device events, which then also leave a tick's breakdown short)."""
    from torch.profiler import ProfilerActivity, profile

    from mmla_audio_torch.ops import denoise as dn

    dcfg, sr, reps = cfg.denoise, cfg.audio.sample_rate, 20
    y = torch.from_numpy(denoise_windows(64, seed=104).astype(np.float32)
                         / 32768.0).to(device)
    nt = dn.noise_threshold(torch.from_numpy(ambient(105).astype(np.float32)
                                             / 32768.0).to(device), dcfg)
    pad = dn._chunk_pad(dcfg, sr)
    yp = torch.nn.functional.pad(y, (pad, pad))
    with torch.no_grad():
        re, im = dn.stft_ri(yp, dcfg.n_fft, dcfg.hop_length)
        mask = dn.gate_mask(re, im, nt, dcfg.prop_decrease)
        calls = {"stft_rfft_kernel": (dn.stft_ri, (yp, dcfg.n_fft,
                                                   dcfg.hop_length)),
                 "istft_irfft_kernel": (dn.istft_frames, (re * mask,
                                                          im * mask,
                                                          dcfg.n_fft)),
                 "smooth_mask": (dn.smooth_mask, (mask, dcfg, sr))}
        parts = []
        for key, (fn, args) in calls.items():
            events, alone = time_ms(fn, *args), queued_ms(fn, *args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn(*args)
                torch.cuda.synchronize()
            traced = [e.time_range.elapsed_us() for e in prof.events()
                      if key in e.name]
            mean = sum(traced) / 1e3 / max(len(traced), 1)
            parts.append(f"{key} time_ms {events:.4f}, queued_ms "
                         f"{alone:.4f}, profiler {mean:.4f} (a mean over "
                         f"the {len(traced)} of {reps} calls it traced)")
    log(f"[mux] the tick's denoise kernels at its shape (B=64, one pass), "
        f"three clocks on the same calls: " + "; ".join(parts))


def open_fds() -> int:
    """This process's open file descriptors."""
    return len(list(Path("/proc/self/fd").iterdir()))


class OpenPerWriteLog:
    """The port's ``SessionLog`` row write as it was before the handle LRU:
    the file opened and closed on every append (the same bytes).  Kept here
    only to time it beside the LRU in one run."""

    def __init__(self, log):
        self.path, self.index = log.path, log.index
        self.timestamps, self.header = log.timestamps, log.header
        self._wrote_header = self.path.exists() and \
            self.path.stat().st_size > 0

    def append(self, label: str, timestamp=None) -> int:
        ts = timestamp if timestamp is not None else datetime.today()
        with open(self.path, "a") as f:
            if not self._wrote_header:
                f.write(self.header + "\n")
                self._wrote_header = True
            f.write(f"{self.index}\t{label}\t{ts}\n" if self.timestamps
                    else f"{self.index}\t{label}\n")
        self.index += 1
        return self.index - 1

    def close(self) -> None:
        pass


def phase_mux_logs(device, pred, cfg, tmp: Path, total: dict) -> dict:
    """``resolve_log`` a window (the multiplexer's log appends) with the
    handle LRU and with a log that opens its file on every write, in turns
    (``LOG_TURNS``), at 64 prefilled streams x 8 windows (every handle
    stays open) and 512 x 4 (round-robin gather cycles all 512 every 8
    ticks through 128 handles: a miss on every append); the open
    descriptors after an LRU run at most ``MAX_OPEN_HANDLES`` +
    ``FD_SLACK`` over the baseline."""
    from mmla_audio_torch.analyze import logs as logs_mod
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.multiplex import Multiplexer

    if logs_mod._MAX_OPEN_HANDLES != MAX_OPEN_HANDLES:
        raise AssertionError(f"the handle cap is "
                             f"{logs_mod._MAX_OPEN_HANDLES}")
    out = {}
    for n_streams, windows in LOG_CASES:
        convs = [vad_windows(windows, seed=800 + s).ravel()
                 for s in range(64)]
        per = {variant: [] for variant in LOG_TURNS}
        peak = 0
        for turn, variant in enumerate(LOG_TURNS):
            fds = open_fds()
            mux = Multiplexer(pred, tmp / f"logs_{n_streams}_{turn}",
                              cfg=cfg, device=device)
            for s in range(n_streams):
                stream = mux.add_stream(f"l{s}", PrefilledCapture(
                    convs[s % 64]), ambient(900 + s % 4))
                if variant != "lru":
                    stream.log = OpenPerWriteLog(stream.log)
            got, _, launches = serve(mux, [])
            add_launches(total, launches)
            if got != n_streams * windows:
                raise AssertionError(f"logs {n_streams}: {got} windows")
            check_logs(mux, windows, f"logs {n_streams} {variant}")
            per[variant].append(mux.phase_seconds["resolve_log"] / got * 1e3)
            if variant == "lru":
                peak = max(peak, open_fds() - fds)
                if peak > MAX_OPEN_HANDLES + FD_SLACK:
                    raise AssertionError(f"logs {n_streams}: {peak} "
                                         f"descriptors opened")
            for stream in mux.streams:
                stream.log.close()
        out[n_streams] = {k: statistics.mean(v) for k, v in per.items()}
        log(f"[mux] resolve_log at {n_streams} streams x {windows} windows "
            f"(ms a window, mean of {LOG_TURNS.count('lru')} runs each, in "
            f"turns): handle LRU {out[n_streams]['lru']:.4f} "
            f"({', '.join(f'{v:.4f}' for v in per['lru'])}), open per write "
            f"{out[n_streams]['open per write']:.4f} "
            f"({', '.join(f'{v:.4f}' for v in per['open per write'])}); "
            f"descriptors opened by an LRU run at most {peak} (cap "
            f"{MAX_OPEN_HANDLES})")
    return out


def phase_mux_churn(device, pred, cfg, tmp: Path, total: dict) -> None:
    """16 streams, 8 retired with ``archive=False`` and 8 added: the rows
    are recycled (the stacked state stays at 16 rows), a recycled row
    starts as a fresh engine and ends as a fresh multiplexer's row for the
    same audio."""
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.multiplex import Multiplexer
    from mmla_audio_torch.vad.webrtc import webrtc_init

    from mmla_audio_torch.analyze import logs as logs_mod

    fresh = webrtc_init(1, device)[0]
    fds_start = open_fds()
    mux = Multiplexer(pred, tmp / "churn", cfg=cfg, device=device)
    first = vad_windows(MUX_CHURN, seed=600)
    for s in range(MUX_CHURN):
        mux.add_stream(f"c{s}", PrefilledCapture(first[s]), ambient(600))
    add_launches(total, serve(mux, [])[2])
    fds = open_fds()
    retired = list(mux.streams[: MUX_CHURN // 2])
    for s in retired:
        mux.remove_stream(s, archive=False)
    if open_fds() > fds or open_fds() > fds_start + MAX_OPEN_HANDLES \
            + FD_SLACK or any(id(s.log) in logs_mod._OPEN_HANDLES
                              for s in retired):
        raise AssertionError(f"churn: {open_fds()} descriptors open after "
                             f"remove_stream ({fds} before, {fds_start} at "
                             f"the start), or a retired log still open")
    late = vad_windows(MUX_CHURN // 2, seed=700)
    added = [mux.add_stream(f"late{s}", PrefilledCapture(late[s]),
                            ambient(700)) for s in range(MUX_CHURN // 2)]
    if sorted(s.index for s in added) != list(range(MUX_CHURN // 2)) \
            or len(mux.streams) != MUX_CHURN or mux.retired \
            or not all(torch.equal(mux._webrtc_states[s.index], fresh)
                       for s in added):
        raise AssertionError("churn: rows were not recycled fresh")
    add_launches(total, serve(mux, [])[2])
    ref = Multiplexer(pred, tmp / "churn_ref", cfg=cfg, device=device)
    ref_streams = [ref.add_stream(f"r{s}", PrefilledCapture(late[s]),
                                  ambient(700))
                   for s in range(MUX_CHURN // 2)]
    add_launches(total, serve(ref, [])[2])
    if len(mux._webrtc_states) != MUX_CHURN:
        raise AssertionError(f"churn: {len(mux._webrtc_states)} rows")
    equal = sum(torch.equal(mux._webrtc_states[a.index],
                            ref._webrtc_states[b.index])
                for a, b in zip(added, ref_streams))
    labels = [s.results[0][1] for s in added]
    if equal != len(added) or labels != [s.results[0][1]
                                         for s in ref_streams]:
        raise AssertionError(f"churn: recycled rows equal to a fresh "
                             f"multiplexer's on {equal}/{len(added)}; labels "
                             f"{labels}")
    log(f"[mux] churn: {MUX_CHURN} streams, {MUX_CHURN // 2} retired "
        f"(archive=False) and {MUX_CHURN // 2} added on recycled rows "
        f"(stacked state stays {MUX_CHURN} rows, nothing archived); "
        f"recycled rows == a fresh multiplexer's bit for bit, labels "
        f"equal; remove_stream closed the retired logs' handles "
        f"({open_fds() - fds_start} descriptors over the phase's start)")


def phase_multiplexer(device, cfg, state_dict, tmp: Path) -> dict:
    """Phase 10: W1 and W2 against their plain versions, the multiplexer
    against the single-stream sessions (overlap and speaker), serving at a
    realistic size, churn.  Returns the kernels-line entries of W1 and W2
    and the launches of the multiplexer's runs, each counted from 0."""
    from mmla_audio_torch.inference import OverlapPredictor, SpeakerPredictor
    from mmla_audio_torch.params import (speaker_state_dict_from_jax,
                                         speaker_tree_shapes)
    from mmla_audio_torch.streaming.session import (OverlapSession,
                                                    SpeakerSession)

    t_phase = time.perf_counter()
    w1, w2 = phase_vad_kernels(device, cfg)
    total: dict = {}
    pred = OverlapPredictor(state_dict, cfg.overlap_model, device=device,
                            matmul_precision="highest")
    mux_vs_sessions(device, pred, OverlapSession, "overlap", cfg, tmp,
                    MUX_LABEL_STREAMS, total)
    speaker = SpeakerPredictor(
        speaker_state_dict_from_jax(seeded_tree(
            speaker_tree_shapes(cfg.speaker_model, len(SPEAKERS)),
            np.random.RandomState(13)), cfg.speaker_model, len(SPEAKERS)),
        cfg.speaker_model, head_units=len(SPEAKERS), sigmoid_head=True,
        device=device)
    mux_vs_sessions(device, speaker, SpeakerSession, "speaker", cfg, tmp,
                    MUX_SPEAKER_STREAMS, total)
    phase_mux_serving(device, pred, cfg, tmp, total)
    logs = phase_mux_logs(device, pred, cfg, tmp, total)
    phase_mux_churn(device, pred, cfg, tmp, total)
    if min(total.values()) <= 0:
        raise AssertionError(f"the multiplexer launched {total}")
    log(f"[mux] launches over phase 10's multiplexer runs: W1 {total['w1']}, "
        f"W2 {total['w2']}, B1 {total['b1']}, B3 {total['b3']}, D1 "
        f"{total['d1']}, D2 {total['d2']}; phase wall time "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(w1=w1, w2=w2, launches=total, logs=logs, pred=pred)


# -- phase 10b: the mesh multiplexer; 10c: distributed training -------------

def phase_mesh(device, pred, cfg, tmp: Path) -> dict:
    """The overlap multiplexer at full width, ``MESH_STREAMS`` prefilled
    streams x ``MESH_WINDOWS`` windows at bucket ``MESH_BUCKET``, through
    ``mesh=None``, a one-card ``make_mesh()`` and a mesh that lists the
    card twice (each batch split in two blocks), in turns: labels and the
    stacked webrtcvad rows equal across all, the one-card mesh the unsplit
    launches, the two-block mesh exactly twice them.  Returns the launches
    of all the runs."""
    from mmla_audio_torch.parallel import make_mesh
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.multiplex import Multiplexer

    meshes = {"mesh=None": None, "make_mesh()": make_mesh(),
              "card twice": make_mesh(devices=[device, device])}
    convs = [vad_windows(MESH_WINDOWS, seed=1000 + s).ravel()
             for s in range(MESH_STREAMS)]
    total: dict = {}
    runs = {name: [] for name in meshes}
    for turn, name in enumerate(MESH_TURNS):
        mux = Multiplexer(pred, tmp / f"mesh_{turn}", bucket=MESH_BUCKET,
                          cfg=cfg, device=device, mesh=meshes[name])
        streams = [mux.add_stream(f"m{s}", PrefilledCapture(convs[s]),
                                  ambient(1100 + s % 4))
                   for s in range(MESH_STREAMS)]
        got, seconds, launches = serve(mux, [])
        add_launches(total, launches)
        if got != MESH_STREAMS * MESH_WINDOWS:
            raise AssertionError(f"mesh {name}: {got} windows")
        check_logs(mux, MESH_WINDOWS, f"mesh {name}")
        runs[name].append(([[r[1] for r in s.results] for s in streams],
                           mux._webrtc_states.cpu(), launches, got / seconds))
        for s in streams:
            s.log.close()
    labels, rows, base, _ = runs["mesh=None"][0]
    for name, results in runs.items():
        for got_labels, got_rows, launches, _ in results:
            want = {k: 2 * v for k, v in base.items()} \
                if name == "card twice" else base
            if got_labels != labels or not torch.equal(got_rows, rows) \
                    or launches != want:
                raise AssertionError(f"mesh {name}: labels, detector rows "
                                     f"or launches {launches} differ from "
                                     f"mesh=None's ({base})")
    if min(base.values()) <= 0:
        raise AssertionError(f"mesh: launches {base}")
    log(f"[mesh] {MESH_STREAMS} streams x {MESH_WINDOWS} windows at bucket "
        f"{MESH_BUCKET}, full width: labels and webrtcvad rows equal across "
        f"mesh=None, make_mesh() and the card listed twice; windows/s "
        + ", ".join(f"{name} {statistics.mean(r[3] for r in res):.1f} ("
                    + ", ".join(f"{r[3]:.1f}" for r in res) + ")"
                    for name, res in runs.items())
        + "; launches of a run: " + "; ".join(
            f"{name} " + ", ".join(f"{k.upper()} {v}"
                                   for k, v in res[0][2].items())
            for name, res in runs.items()))
    return total


def phase_distributed(device, cfg) -> None:
    """``initialize`` with NCCL at world size 1, then ``Trainer.fit(mesh=
    global_mesh())`` for one epoch at the full width of
    ``SpeakerModelConfig()`` (a ``DIST_SPEAKERS``-way head, batch
    ``DIST_BATCH``, SGD) against ``mesh=None`` from the same initial
    weights: history and every parameter and statistic within DIST_RTOL /
    DIST_ATOL; each step timed by CUDA events with and without the mesh."""
    import socket

    import torch.distributed as tdist

    from mmla_audio_torch.models.layers import keras_init_
    from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
    from mmla_audio_torch.parallel import distributed as dist
    from mmla_audio_torch.train.losses import keras_categorical_crossentropy
    from mmla_audio_torch.train.trainer import Trainer

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        if dist.process_info() != (0, 1) or tdist.get_backend() != "nccl":
            raise AssertionError(f"distributed: {dist.process_info()}, "
                                 f"{tdist.get_backend()}")
        mesh = dist.global_mesh()
        mcfg = cfg.speaker_model
        init = keras_init_(SpeakerResBLSTM(mcfg, DIST_SPEAKERS),
                           torch.Generator().manual_seed(41)).state_dict()
        rng = np.random.RandomState(42)
        labels = np.arange(DIST_ROWS) % DIST_SPEAKERS
        x = rng.randn(DIST_ROWS, 256, 39).astype(np.float32)
        for c in range(DIST_SPEAKERS):
            x[labels == c, :, 10 * c:10 * (c + 1)] += 1.0
        y = np.eye(DIST_SPEAKERS, dtype=np.float32)[labels]
        runs = {}
        for name, m in (("mesh=None", None), ("global_mesh()", mesh)):
            model = SpeakerResBLSTM(mcfg, DIST_SPEAKERS)
            model.load_state_dict(init)
            tr = Trainer(model, lambda p: torch.optim.SGD(p, lr=DIST_LR),
                         keras_categorical_crossentropy,
                         extra_penalty_fn=lambda mm: l2_penalty(mm, mcfg),
                         device=device, seed=3)
            with timed_steps() as ms:
                hist = tr.fit(x, y, epochs=1, batch_size=DIST_BATCH, mesh=m)
            runs[name] = (hist, tr.variables_of(), ms, tr, m)
        (h0, sd0, ms0, *_), (h1, sd1, ms1, *_) = runs.values()
        worst = 0.0
        for key in ("loss", "acc"):
            np.testing.assert_allclose(h1[key], h0[key], rtol=DIST_RTOL,
                                       atol=DIST_ATOL, err_msg=key)
        for k in sd0:
            a, b = sd1[k].double(), sd0[k].double()
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=DIST_RTOL,
                                       atol=DIST_ATOL, err_msg=k)
            worst = max(worst, float((a - b).abs().max()))
        moved = max(float((sd0[k].double() - init[k].double()).abs().max())
                    for k in sd0)
        log(f"[distributed] NCCL world of 1, process_info (0, 1); "
            f"Trainer.fit one epoch of {DIST_ROWS} rows at b{DIST_BATCH}, "
            f"full-width SpeakerModelConfig() with a {DIST_SPEAKERS}-way "
            f"head, SGD {DIST_LR}: global_mesh() == mesh=None (loss "
            f"{h1['loss'][0]:.6f} vs {h0['loss'][0]:.6f}; parameters and "
            f"statistics within rtol {DIST_RTOL} / atol {DIST_ATOL}, largest "
            f"difference {worst:.3g}, largest move from the initial weights "
            f"{moved:.3g}); step ms (CUDA events, median of steps 2-"
            f"{len(ms0)}): mesh=None {statistics.median(ms0[1:]):.3f}, "
            f"global_mesh() {statistics.median(ms1[1:]):.3f}")
        steps = DIST_ROWS // DIST_BATCH
        for name, (_, _, _, tr, m) in runs.items():
            prof = profile_steps(lambda: tr.fit(x, y, epochs=1,
                                                batch_size=DIST_BATCH,
                                                mesh=m), steps)
            busy = "not measured (no device events in the trace)" \
                if prof["busy_ms"] is None else \
                (f"device busy {prof['busy_ms']:.3f} ms (idle share "
                 f"{prof['idle']:.3f}); by kind (ms): " + ", ".join(
                     f"{k} {v:.3f}" for k, v in prof["kinds"]))
            log(f"[distributed] profile of a fit epoch, {name}, a step: "
                f"host {prof['host_ms']:.3f} ms; {busy}; "
                f"{prof['launches']:.0f} launches")
    finally:
        tdist.destroy_process_group()
        dist._initialized = False


# -- phase 10d: tensor parallelism ------------------------------------------

TP_WORKER = r"""
import sys
import time

import torch

coord, pid, inp, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.backends.cudnn.deterministic = True

from chip_smoke import timed_steps
from mmla_audio_torch.core.config import SpeakerModelConfig
from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_torch.parallel import distributed as dist
from mmla_audio_torch.train.losses import keras_categorical_crossentropy
from mmla_audio_torch.train.trainer import Trainer

data = torch.load(inp, weights_only=False)
dist.initialize(coord, 2, pid, device="cpu")            # gloo
mesh = dist.global_mesh(n_model=2)                      # both on cuda:0
assert mesh.devices.shape == (1, 2) and mesh.model_group is not None
cfg = SpeakerModelConfig(**data["cfg"])
model = SpeakerResBLSTM(cfg, data["speakers"])
model.load_state_dict(data["init"])
tr = Trainer(model, lambda p: torch.optim.SGD(p, lr=data["lr"],
                                              momentum=data["momentum"]),
             keras_categorical_crossentropy,
             extra_penalty_fn=lambda m: l2_penalty(m, cfg),
             device=mesh.local_devices[0], seed=3)
t0 = time.perf_counter()
with timed_steps() as ms:
    hist = tr.fit(data["x"], data["y"], epochs=data["epochs"],
                  batch_size=data["batch"], mesh=mesh)
wall = time.perf_counter() - t0
blocks = {id(b) for _, b in tr._blocks.pairs}
state = [(tuple(m.shape), id(m) in blocks,
          [tuple(v.shape) for v in tr.optimizer.state[m].values()
           if isinstance(v, torch.Tensor)])
         for m in tr._blocks.masters]
torch.save({"hist": hist, "sd": tr.variables_of(), "wall": wall,
            "ms": ms, "state": state,
            "split": len(tr._blocks.pairs)}, out)
torch.distributed.destroy_process_group()
"""


def phase_tensor_parallel(device, cfg, tmp: Path) -> None:
    """Two processes on the one card (NCCL refuses two ranks on a card:
    gloo, which takes CUDA tensors) with a (1, 2) mesh, ``global_mesh(
    n_model=2)``: phase 10c's fit (full-width ``SpeakerModelConfig()``,
    ``DIST_SPEAKERS``-way head, SGD, batch ``DIST_BATCH``) for
    ``TP_EPOCHS`` epochs, each rank holding half of every split parameter
    and of its optimizer state; against ``mesh=None`` on the same data
    after it, history and every parameter and statistic within TP_RTOL /
    TP_ATOL, both ranks equal bit for bit; both step times by CUDA
    events.  A failure raises."""
    import dataclasses
    import os
    import socket

    from mmla_audio_torch.models.layers import keras_init_
    from mmla_audio_torch.models.speaker import SpeakerResBLSTM, l2_penalty
    from mmla_audio_torch.parallel import make_mesh, param_shardings
    from mmla_audio_torch.train.losses import keras_categorical_crossentropy
    from mmla_audio_torch.train.trainer import Trainer

    mcfg = cfg.speaker_model
    init = keras_init_(SpeakerResBLSTM(mcfg, DIST_SPEAKERS),
                       torch.Generator().manual_seed(43)).state_dict()
    rng = np.random.RandomState(44)
    labels = np.arange(DIST_ROWS) % DIST_SPEAKERS
    x = rng.randn(DIST_ROWS, 256, 39).astype(np.float32)
    for c in range(DIST_SPEAKERS):
        x[labels == c, :, 10 * c:10 * (c + 1)] += 1.0
    y = np.eye(DIST_SPEAKERS, dtype=np.float32)[labels]
    inp, worker = tmp / "tp_inputs.pt", tmp / "tp_worker.py"
    torch.save(dict(cfg=dataclasses.asdict(mcfg), speakers=DIST_SPEAKERS,
                    init=init, x=x, y=y, lr=DIST_LR, momentum=TP_MOMENTUM,
                    epochs=TP_EPOCHS, batch=DIST_BATCH), inp)
    worker.write_text(TP_WORKER)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), f"127.0.0.1:{port}", str(pid),
         str(inp), str(tmp / f"tp_out{pid}.pt")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for pid in range(2)]
    try:
        errs = [p.communicate(timeout=TP_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise AssertionError("tensor parallel workers failed: " + "\n---\n".join(
            e.decode(errors="replace")[-3000:] for e in errs))
    outs = [torch.load(tmp / f"tp_out{pid}.pt", weights_only=False)
            for pid in range(2)]
    # the reference after the workers, so that the step times are alone
    model = SpeakerResBLSTM(mcfg, DIST_SPEAKERS)
    model.load_state_dict(init)
    tr = Trainer(model, lambda p: torch.optim.SGD(p, lr=DIST_LR,
                                                  momentum=TP_MOMENTUM),
                 keras_categorical_crossentropy,
                 extra_penalty_fn=lambda mm: l2_penalty(mm, mcfg),
                 device=device, seed=3)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        with timed_steps() as ref_ms:
            hist = tr.fit(x, y, epochs=TP_EPOCHS, batch_size=DIST_BATCH)
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ref = tr.variables_of()
    worst = 0.0
    for out in outs:
        for key in ("loss", "acc"):
            np.testing.assert_allclose(out["hist"][key], hist[key],
                                       rtol=TP_RTOL, atol=TP_ATOL,
                                       err_msg=key)
        for k, v in ref.items():
            got = out["sd"][k].double().numpy()
            np.testing.assert_allclose(got, v.double().numpy(), rtol=TP_RTOL,
                                       atol=TP_ATOL, err_msg=k)
            worst = max(worst, float(np.abs(got - v.double().numpy()).max()))
    for k in ref:
        if not torch.equal(outs[0]["sd"][k], outs[1]["sd"][k]):
            raise AssertionError(f"tensor parallel: ranks differ in {k}")
    split = param_shardings(model, make_mesh(1, 2, devices=[device] * 2))
    n_split = sum(d is not None for d in split.values())
    for out in outs:
        blocks = [s for s in out["state"] if s[1]]
        if out["split"] != n_split or len(blocks) != n_split or not all(
                len(shapes) == 1 and shapes[0] == shape
                for shape, _, shapes in out["state"]):
            raise AssertionError(f"tensor parallel: {out['split']} split "
                                 f"parameters of {n_split}, or an optimizer "
                                 f"state not its block's shape")
    held = sum(int(np.prod(s[0])) for s in outs[0]["state"])
    whole = sum(p.numel() for p in model.parameters() if p.requires_grad)
    moved = max(float((ref[k].double() - init[k].double()).abs().max())
                for k in ref)
    tp_ms = [statistics.median(out["ms"][1:]) for out in outs]
    log(f"[tensor parallel] two gloo processes on {device}, a (1, 2) mesh: "
        f"{TP_EPOCHS} epochs of {DIST_ROWS} rows at b{DIST_BATCH}, "
        f"full-width SpeakerModelConfig() with a {DIST_SPEAKERS}-way head, "
        f"SGD {DIST_LR} momentum {TP_MOMENTUM}: == mesh=None (loss "
        f"{outs[0]['hist']['loss'][-1]:.6f}"
        f" vs {hist['loss'][-1]:.6f}; every parameter and statistic within "
        f"rtol {TP_RTOL} / atol {TP_ATOL}, largest difference {worst:.3g}, "
        f"largest move from the start {moved:.3g}; both ranks bit for bit); "
        f"{n_split} of {len(split)} parameters split, each rank's master "
        f"weights and optimizer state {held:,} of {whole:,} values; step ms "
        f"(CUDA events, median of steps 2-{len(ref_ms)}): mesh=None "
        f"{statistics.median(ref_ms[1:]):.3f}, (1, 2) mesh rank 0 "
        f"{tp_ms[0]:.3f}, rank 1 {tp_ms[1]:.3f}; fit wall s: mesh=None "
        f"{wall:.2f}, ranks {outs[0]['wall']:.2f} and {outs[1]['wall']:.2f}")


# -- phase 11: edge, export and weights ------------------------------------

def savedmodel_tensors(flat, cfg, kind: str) -> dict:
    """A Keras ``get_weights()`` list as the checkpoint keys TF writes for
    the reference's models: ``layer_with_weights-N/<attr>`` a layer in
    graph order, the BiLSTM's six arrays as orphan ``variables/N`` (the
    overlap model's) or ``trainable_variables/N`` (the speaker model's) in
    the one gap of the layer numbering (`mmla_audio_tpu/tfbundle.py`)."""
    layers = ["conv"]
    for _ in cfg.stage_filters:
        for block in range(cfg.blocks_per_stage):
            short = ["conv"] if block == 0 else []
            layers += (["bn", "conv", "bn", "conv"] + short
                       if kind == "overlap" else
                       ["bn", "conv", "bn"] + short + ["conv"])
    layers += (["bn"] if kind == "speaker" else []) + ["lstm", "dense"]
    attrs = {"conv": ("kernel", "bias"), "dense": ("kernel", "bias"),
             "bn": ("gamma", "beta", "moving_mean", "moving_variance")}
    family = "variables" if kind == "overlap" else "trainable_variables"
    arrays = iter(flat)
    out = {}
    for index, layer in enumerate(layers):
        if layer == "lstm":
            for n in range(6):
                out[f"{family}/{200 + n}/.ATTRIBUTES/VARIABLE_VALUE"] = \
                    next(arrays)
            continue
        for attr in attrs[layer]:
            out[f"layer_with_weights-{index}/{attr}/.ATTRIBUTES/"
                f"VARIABLE_VALUE"] = next(arrays)
    if next(arrays, None) is not None:
        raise ValueError("savedmodel_tensors: weights left over")
    return out


def edge_windows(n_win: int) -> list:
    """``EDGE_WINDOWS`` live windows: speech over ambient noise, and
    ``EDGE_NOISE_ONLY`` of noise alone at the profile's level, where the
    SSIM gate should fire."""
    rng = np.random.RandomState(81)
    speech = denoise_windows(EDGE_WINDOWS - EDGE_NOISE_ONLY, seed=80,
                             n=n_win)
    noise = [(rng.randn(n_win) * 20).astype(np.int16)
             for _ in range(EDGE_NOISE_ONLY)]
    return [speech[0], noise[0], speech[1], speech[2], noise[1], speech[3],
            noise[2], speech[4]]


def phase_edge_overlap(device, state_dict, cfg, noise, tmp: Path) -> dict:
    """``EdgeOverlapSession.run`` over ``EDGE_WINDOWS`` windows on the card
    (launches counted: B1 once and B3 six times a window, D1 and D2 at
    ``passes_edge`` a window) and on the CPU: labels equal where the CPU's
    top-2 margin is above ``TOP2_MARGIN`` and its SSIM is more than
    ``SSIM_MARGIN`` from the threshold; window-to-decision p50."""
    from mmla_audio_torch.inference import OverlapPredictor
    from mmla_audio_torch.streaming.capture import PrefilledCapture
    from mmla_audio_torch.streaming.edge import EdgeOverlapSession

    windows = edge_windows(cfg.audio.window_samples)
    runs = {}
    for key, dev in (("card", device), ("cpu", torch.device("cpu"))):
        pred = OverlapPredictor(state_dict, cfg.overlap_model, device=dev,
                                matmul_precision="highest")
        sess = EdgeOverlapSession(pred, PrefilledCapture(
            np.concatenate(windows)), tmp / f"edge_{key}", cfg=cfg)
        sess.set_noise_profile(noise)
        out = []
        zero_launch_counters()
        rows = sess.run(on_result=lambda i, label, probs: out.append(
            (label, probs, sess.last_similarity)))
        launched = mux_launches()
        if len(rows) != len(windows):
            raise AssertionError(f"edge overlap on {dev}: rows {rows}")
        runs[key] = sess, out, launched
    sess, card, launched = runs["card"]
    _, cpu, _ = runs["cpu"]
    n = len(windows)
    passes = cfg.denoise.passes_edge
    want = dict(b1=n, b3=6 * n, d1=2 * passes * n, d2=passes * n)
    if any(launched[k] != v for k, v in want.items()):
        raise AssertionError(f"edge overlap launched {launched}, want "
                             f"{want}")
    clear = [(np.sort(p)[-1] - np.sort(p)[-2]) > TOP2_MARGIN
             and abs(s - sess.ssim_threshold) > SSIM_MARGIN
             for _, p, s in cpu]
    labels, cpu_labels = [c[0] for c in card], [c[0] for c in cpu]
    if any(ok and a != b for ok, a, b in zip(clear, labels, cpu_labels)) \
            or "silent" not in cpu_labels:
        raise AssertionError(f"edge overlap card {labels} vs CPU "
                             f"{cpu_labels} (clear {clear})")
    times = []
    for w in windows:
        t0 = time.perf_counter()
        sess.process_window(w)
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"[edge] overlap: {n} windows ({EDGE_NOISE_ONLY} noise-only), card "
        f"labels {labels} == CPU labels where the top-2 margin > "
        f"{TOP2_MARGIN} and |SSIM - {sess.ssim_threshold}| > {SSIM_MARGIN} "
        f"({sum(clear)}/{n}); SSIM card "
        f"{[round(c[2], 4) for c in card]}, CPU "
        f"{[round(c[2], 4) for c in cpu]}; launches {launched} (B1 1, B3 6, "
        f"D1 {2 * passes}, D2 {passes} a window); window-to-decision p50 "
        f"{np.percentile(times, 50):.2f} ms, p90 "
        f"{np.percentile(times, 90):.2f} ms (host clock)")
    return launched


def phase_edge_speaker(device, cfg, noise, tmp: Path) -> dict:
    """``EdgeSpeakerSession`` at full width: three voices enrolled behind a
    gate that starts released (a capture created suspended), a short
    fine-tune, then ``EDGE_IDENTIFY`` windows identified through the
    captured graph; labels equal to an eager ``SpeakerSession``'s (the same
    predictor, chain on the card, the detector state copied) where its
    top-2 logit margin is clear."""
    import dataclasses
    import threading

    from mmla_audio_torch.inference import SpeakerPredictor
    from mmla_audio_torch.params import (speaker_state_dict_from_jax,
                                         speaker_tree_shapes)
    from mmla_audio_torch.streaming.capture import ArraySource, CaptureThread
    from mmla_audio_torch.streaming.edge import (EdgeSpeakerSession,
                                                 GateSource)
    from mmla_audio_torch.streaming.session import SpeakerSession

    cfg = dataclasses.replace(cfg, transfer=dataclasses.replace(
        cfg.transfer, accuracy_gate=0.0, max_retrain_rounds=1))
    base = speaker_state_dict_from_jax(seeded_tree(
        speaker_tree_shapes(cfg.speaker_model), np.random.RandomState(7)),
        cfg.speaker_model)
    pred = SpeakerPredictor(base, cfg.speaker_model, device=device)
    n_win = cfg.audio.window_samples
    enroll = [voice(EDGE_ENROLL_SECONDS, s, seed=90 + s)
              for s in range(len(SPEAKERS))]
    cap = CaptureThread(ArraySource(np.concatenate(enroll)), cfg.audio)
    cap.suspend()                         # the device boots, button up
    cap.start()
    gate = GateSource(pressed=False)
    sess = EdgeSpeakerSession(pred, cap, tmp / "edge_speaker", gate=gate,
                              cfg=cfg)
    sess.set_noise_profile(noise)
    threading.Timer(0.2, gate.set_pressed, args=(True,)).start()
    zero_launch_counters()
    t0 = time.perf_counter()
    for name in SPEAKERS:
        sess.register_speaker(name, seconds=EDGE_ENROLL_SECONDS)
    cap.stop()
    acc = sess.train_on_registered(base, epochs_override=(5, 1))
    t_enroll = time.perf_counter() - t0
    state = sess._vad.state_array
    windows = [voice(n_win / 16000, s % len(SPEAKERS), seed=95 + s)
               for s in range(EDGE_IDENTIFY)]
    cap = CaptureThread(ArraySource(np.concatenate(windows)), cfg.audio)
    cap.suspend()
    cap.start()
    sess.capture = cap
    gate.set_pressed(False)
    threading.Timer(0.2, gate.set_pressed, args=(True,)).start()
    rows = sess.run(max_windows=EDGE_IDENTIFY)
    cap.stop()
    launched = mux_launches()
    eager = SpeakerSession(LogitsTap(sess.predictor), None,
                           tmp / "edge_speaker_eager", cfg=cfg,
                           speaker_id_dict=sess.speaker_id_dict,
                           host_preprocess=False)
    eager.set_noise_profile(noise)
    eager._vad.state_array = state
    ref = [eager.process_window(w)[0] for w in windows]
    labels = [r[1] for r in rows]
    clear, n = compare_labels("edge speaker (graph vs eager)", labels, ref,
                              np.concatenate(eager.predictor.logits))
    lines = sess.log.path.read_text().splitlines()
    if sess._aot is None or lines[0] != "segment\tspeaker" or \
            any(len(ln.split("\t")) != 2 for ln in lines[1:]) or \
            launched["d1"] <= 0 or launched["b1"] or launched["b3"]:
        raise AssertionError(f"edge speaker: log {lines[:3]}, launches "
                             f"{launched}")
    log(f"[edge] speaker: {len(SPEAKERS)} voices of {EDGE_ENROLL_SECONDS:.0f}"
        f" s enrolled behind a released gate, fine-tuned (5 + 1 epochs, "
        f"accuracy {acc:.3f}) in {t_enroll:.1f} s; {n} windows identified "
        f"through the captured graph {labels} == eager session's where the "
        f"top-2 logit margin > {TOP2_MARGIN} ({clear}/{n}); timestamp-free "
        f"log; launches {launched}")
    return launched


def phase_aot(device, state_dict, cfg) -> None:
    """``aot_compile(OverlapPredictor.predict)`` at B=8 on the card: the
    graph's argmax equals eager, another batch raises, eager and replay
    timed; the captured launches counted (a replay runs them without the
    wrappers' counters)."""
    from mmla_audio_torch.export import aot_compile, parity_check
    from mmla_audio_torch.inference import OverlapPredictor

    pred = OverlapPredictor(state_dict, cfg.overlap_model, device=device,
                            matmul_precision="highest")
    bufs = torch.from_numpy(speech_windows(AOT_BATCH, 40960, seed=83)
                            ).to(device)
    counts = torch.tensor([40960, 36000, 30000, 24000, 16000, 9000, 4000,
                           2000], dtype=torch.int32, device=device)
    pred.predict(bufs, counts)
    zero_launch_counters()
    compiled = aot_compile(pred.predict, bufs, counts)
    # one warm-up call and one capture launch the same kernels
    captured = {k: v // 2 for k, v in mux_launches().items()}
    if (captured["b1"], captured["b3"]) != (1, 6):
        raise AssertionError(f"aot: the capture launched {captured}")
    parity_check(lambda b, n: pred.predict(b, n)[1],
                 lambda b, n: compiled(b, n)[1], (bufs, counts))
    labels = pred.predict(bufs, counts)[0]
    if not torch.equal(compiled(bufs, counts)[0], labels):
        raise AssertionError("aot: the graph's labels differ from eager")
    try:
        compiled(bufs[:4], counts[:4])
    except ValueError:
        pass
    else:
        raise AssertionError("aot: the graph took another batch")
    eager_ms = time_ms(pred.predict, bufs, counts)
    replay_ms = time_ms(compiled, bufs, counts)
    replays = 3 + 20 * 5 + 2
    log(f"[aot] OverlapPredictor.predict captured at B={AOT_BATCH}: argmax "
        f"== eager (parity_check), labels equal, B=4 refused; eager "
        f"{eager_ms:.4f} ms, graph replay {replay_ms:.4f} ms (CUDA events); "
        f"launches captured per replay {captured}, so {replays} replays ran "
        f"B1 {replays * captured['b1']} and B3 {replays * captured['b3']} "
        f"times unseen by the counters")


def phase_savedmodel(device, cfg, tmp: Path) -> None:
    """A full-width synthetic SavedModel of each model kind, written from a
    seeded tree with ``tests/golden/tfbundle_writer.py`` and loaded with
    ``convert.load_checkpoint_state_dict``: every tensor bit for bit the
    ``params.py`` conversion of the same tree, and the predictors' outputs
    on the card equal."""
    from mmla_audio_torch import convert
    from mmla_audio_torch.inference import OverlapPredictor, SpeakerPredictor
    from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                         overlap_tree_shapes,
                                         speaker_state_dict_from_jax,
                                         speaker_tree_shapes)
    from tests.golden.tfbundle_writer import write_bundle

    rng = np.random.RandomState(84)
    bufs = speech_windows(8, 40960, seed=85)
    counts = np.full(8, 40960, np.int32)
    for kind, mcfg in (("overlap", cfg.overlap_model),
                       ("speaker", cfg.speaker_model)):
        if kind == "overlap":
            tree = seeded_tree(overlap_tree_shapes(mcfg), rng)
            ref_sd = overlap_state_dict_from_jax(tree, mcfg)
            flat = convert.overlap_variables_to_keras(tree, mcfg)
        else:
            tree = seeded_tree(speaker_tree_shapes(mcfg), rng)
            ref_sd = speaker_state_dict_from_jax(tree, mcfg)
            flat = convert.speaker_variables_to_keras(tree, mcfg)
        root = tmp / f"savedmodel_{kind}"
        (root / "variables").mkdir(parents=True)
        write_bundle(root / "variables" / "variables",
                     savedmodel_tensors(flat, mcfg, kind))
        t0 = time.perf_counter()
        got_kind, sd, head = convert.load_checkpoint_state_dict(root)
        seconds = time.perf_counter() - t0
        if got_kind != kind or sorted(sd) != sorted(ref_sd) or not all(
                torch.equal(sd[k], ref_sd[k]) for k in sd):
            raise AssertionError(f"SavedModel {kind}: the state dict differs"
                                 f" from params.py's")
        outs = []
        for weights in (sd, ref_sd):
            pred = OverlapPredictor(weights, mcfg, device=device,
                                    matmul_precision="highest") \
                if kind == "overlap" else \
                SpeakerPredictor(weights, mcfg, head_units=head,
                                 device=device)
            outs.append(pred.predict(bufs, counts)[1])
        if not torch.equal(*outs):
            raise AssertionError(f"SavedModel {kind}: predictions differ")
        log(f"[weights] {kind} SavedModel at full width: {len(flat)} arrays "
            f"({sum(a.nbytes for a in flat) / 1e6:.1f} MB) loaded in "
            f"{seconds:.3f} s, {len(sd)} tensors == params.py's bit for bit,"
            f" predictions on the card equal")


def phase_edge_cli(state_dict, cfg, noise, tmp: Path, clips) -> None:
    """The new CLI surfaces, each in a fresh process, all started at once:
    ``overlap-live --edge``, ``speaker-live --edge``, ``overlap-live
    --host-preprocess``, ``overlap-run --parity`` and ``overlap-post --ckpt
    D`` with ``D`` from ``export_serving``."""
    from mmla_audio_torch.data.wavio import write_wav
    from mmla_audio_torch.export import export_serving, load_serving

    wav = tmp / "edge_clip.wav"
    write_wav(wav, speech_windows(1, 40960, seed=86)[0])
    ckpt = tmp / "serving"
    export_serving(ckpt, state_dict, input_shape=(1, 40960),
                   model_name="overlap")
    back, meta = load_serving(ckpt)
    if meta["input_shape"] != [1, 40960] or not all(
            torch.equal(back[k], state_dict[k].cpu()) for k in back):
        raise AssertionError("export_serving/load_serving round trip")
    root = tmp / "post_ckpt"
    write_experiment(root, {"audio_ckpt": clips["audio_conv0"][
        : EDGE_POST_SECONDS * cfg.audio.sample_rate]}, noise,
        cfg.audio.sample_rate)
    live = ["--fake", "--windows", "4", "--calibrate-seconds", "2"]
    commands = {
        "overlap-live --edge": ["overlap-live", "--edge", "--root",
                                tmp / "cli_edge_o"] + live,
        "speaker-live --edge": ["speaker-live", "--edge", "--root",
                                tmp / "cli_edge_s"] + live,
        "overlap-live --host-preprocess": [
            "overlap-live", "--host-preprocess", "--root",
            tmp / "cli_host"] + live,
        "overlap-run --parity": ["overlap-run", "-f", wav, "--parity"],
        "overlap-post --ckpt": ["overlap-post", "--root", root, "--ckpt",
                                ckpt]}
    t0 = time.perf_counter()
    procs = {what: subprocess.Popen(
        [sys.executable, "-m", "mmla_audio_torch.cli", *map(str, argv)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for what, argv in commands.items()}
    outs = {}
    for what, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI {what} failed ({proc.returncode}):\n"
                                 f"{out}\n{err}")
        outs[what] = out
    seconds = time.perf_counter() - t0
    checks = {"overlap-live --edge": "[INFO] window 4:",
              "speaker-live --edge": "[INFO] window 4:",
              "overlap-live --host-preprocess": "[INFO] window 4:",
              "overlap-run --parity": "[INFO] AOT parity check passed",
              "overlap-post --ckpt": f"[INFO] weights: {ckpt}"}
    for what, want in checks.items():
        if want not in outs[what]:
            raise AssertionError(f"CLI {what}: no {want!r} in\n{outs[what]}")
    speaker_log = next((tmp / "cli_edge_s" / "logs").glob("*.txt"))
    if speaker_log.read_text().splitlines()[0] != "segment\tspeaker" or \
            not (root / "logs" / "audio_ckpt.txt").exists():
        raise AssertionError("CLI: the edge speaker log or the post log")
    log(f"[edge] cli: {', '.join(commands)} in fresh processes, "
        f"{seconds:.1f} s together; "
        + " | ".join(ln for out in outs.values() for ln in out.splitlines()
                     if ln.startswith(("[RESULT]", "[INFO] AOT"))))


def phase_edge(device, cfg, state_dict, noise, tmp: Path, clips) -> dict:
    """Phase 11: the edge sessions, the compiled predictor, Keras weights
    and the new CLI surfaces.  Returns the launches of the edge sessions'
    runs (the main path of this phase), counted from 0."""
    t_phase = time.perf_counter()
    total: dict = {}
    add_launches(total, phase_edge_overlap(device, state_dict, cfg, noise,
                                           tmp))
    add_launches(total, phase_edge_speaker(device, cfg, noise, tmp))
    phase_aot(device, state_dict, cfg)
    phase_savedmodel(device, cfg, tmp)
    phase_edge_cli(state_dict, cfg, noise, tmp, clips)
    log(f"[edge] launches over phase 11's edge sessions: {total}; phase wall "
        f"time {time.perf_counter() - t_phase:.1f} s")
    return total


# -- phase 12: the GMM VAD ---------------------------------------------------

def g1_bound(batch: int) -> dict:
    """G1's least time: its bytes (band and frame energies and the state
    row read once, the state row and the decisions written once) at the
    memory rate, or its fp32 operations (``G1_BAND_OPS`` a band a frame,
    read from the source, a transcendental counted as one) at the CUDA
    cores' rate (its work has no tensor-core form)."""
    nbytes = batch * (VAD_T * (6 + 1) * 4 + 2 * 54 * 4 + VAD_T)
    ops = batch * VAD_T * 6 * G1_BAND_OPS
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_CORE_FLOP_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def g1_chain_ms() -> float:
    """G1's serial floor: VAD_T frames, each ``G1_FRAME_OPS`` dependent
    operations at ``FP32_LATENCY`` cycles (read from the source, not its
    SASS; shuffles, divisions and transcendentals take longer, so this is
    a floor): the speech log-mixture (subtract, a division as 4, two
    multiplies, two subtracts, an add, the partner's shuffle, a max, a
    subtract, exp as 2, an add, log as 2, an add: 19), the log-LR and its
    weighted sum (a subtract, a multiply, a shuffle, five adds, the
    compare and the decision's select: 10), and the noise mean's update
    into the next frame's speech mean (a multiply, an add, the min_track
    clamp, the partner's shuffle, a max, an add, a max: 8); at the card's
    highest SM clock."""
    return VAD_T * G1_FRAME_OPS * FP32_LATENCY / (sm_clock_mhz() * 1e6) * 1e3


def gmm_rows(device, cfg, batch: int, seed: int) -> tuple:
    """``batch`` denoised live windows' band and frame energies ``(B,
    VAD_T, 6)``, ``(B, VAD_T)`` on the card and their state rows: each
    row's mixtures calibrated on its own ambient noise."""
    from mmla_audio_torch.vad import gmm

    raw = vad_windows(batch, seed)
    rows = []
    for b in range(batch):
        noise = ambient(seed + 1 + b % 8)
        if b < 8:
            rows.append(gmm.state_rows(gmm.gmm_init_from_noise(
                noise, device=device)))
        else:
            rows.append(rows[b % 8])
    i16 = denoised_i16(device, cfg, raw, ambient(seed + 1)).float()
    return (gmm.band_log_energies(i16), gmm.total_db(i16),
            torch.stack(rows).contiguous())


def check_g1(e, tot, rows, mode: int, adapt: bool) -> tuple:
    """G1 against the plain loop on the same card tensors.  Returns (its
    decisions, its states, the largest state difference on rows whose
    decisions all agree, the frames under the margin, the rows left out
    of the state comparison)."""
    from mmla_audio_torch.vad import gmm

    dec, out = gmm.gmm_vad_rows(e, tot, rows, mode, adapt)
    ref_dec, ref_out, margins = gmm.gmm_vad_rows_plain(
        e, tot, rows, mode, adapt, with_margins=True)
    clear = (margins > GMM_MARGIN).all(-1)
    if not torch.equal(dec[clear], ref_dec[clear]):
        raise AssertionError(f"G1 B={len(e)} mode {mode}: decisions differ "
                             f"from the plain loop's where the margins "
                             f"exceed {GMM_MARGIN}")
    same = (dec == ref_dec).all(1)
    err = float((out[same] - ref_out[same]).abs().max()) if same.any() \
        else 0.0
    if not same.any() or err > GMM_STATE_ATOL or not torch.isfinite(out).all():
        raise AssertionError(f"G1 B={len(e)} mode {mode}: state difference "
                             f"{err} on {int(same.sum())} agreeing rows")
    return dec, out, err, int((~clear).sum()), int((~same).sum())


def gmm_latency(device, cfg, noise) -> tuple:
    """``preprocess_window`` at B=1 over ``GMM_WINDOWS`` windows, the GMM,
    webrtc and energy decisions in turns (the order rotates each window);
    host clock to the trimmed window, synchronized.  Returns ({decision:
    times}, the launches over the run, the first ``GMM_CHECK`` windows'
    denoised int16 on the card)."""
    from mmla_audio_torch.ops.denoise import (noise_threshold, quantize_i16,
                                              reduce_noise)
    from mmla_audio_torch.streaming.session import preprocess_window
    from mmla_audio_torch.vad import gmm
    from mmla_audio_torch.vad.collector import calibrate_threshold
    from mmla_audio_torch.vad.native import NativeWebRtcVad

    nt = noise_threshold(torch.from_numpy(noise.astype(np.float32) / 32768.0)
                         .to(device), cfg.denoise)
    arms = {"gmm": dict(gmm_state=gmm.gmm_init_from_noise(noise,
                                                          device=device)),
            "webrtc": dict(vad=NativeWebRtcVad(cfg.vad.aggressiveness)),
            "energy": dict(vad_threshold_db=calibrate_threshold(
                noise, cfg.vad.aggressiveness))}
    windows = vad_windows(GMM_WINDOWS, seed=51, n=cfg.audio.window_samples)
    for kw in arms.values():
        preprocess_window(windows[0], nt, cfg, **kw)
    torch.cuda.synchronize()
    names, times = list(arms), {name: [] for name in arms}
    kept = []
    zero_launch_counters()
    for i, w in enumerate(windows):
        for name in names[i % 3:] + names[: i % 3]:
            t0 = time.perf_counter()
            out, n = preprocess_window(w, nt, cfg, **arms[name])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if name == "gmm":
                if out.shape != (len(w),) or n % VAD_FRAME or \
                        not torch.isfinite(out).all():
                    raise AssertionError(f"gmm window {i}: {out.shape}, {n}")
                kept.append(n)
    from mmla_audio_torch.vad.gmm import gmm_vad_rows

    launches = dict(g1=gmm_vad_rows.launches, **denoise_launches())
    check = []
    for w in windows[:GMM_CHECK]:
        y = torch.from_numpy(w.astype(np.float32) / 32768.0).to(device)
        check.append(quantize_i16(reduce_noise(
            y, nt, cfg.denoise, passes=cfg.denoise.passes_live)))
    return times, launches, torch.stack(check), arms["gmm"]["gmm_state"], \
        kept


def phase_gmm(device, cfg) -> dict:
    """Phase 12: G1 against the plain frame loop on the card at
    ``GMM_BATCHES`` rows of denoised live windows (aggressiveness 3 with
    adaptation, and at B=64 mode 0 without), a row's bits alone and in the
    batch; G1 timed (CUDA events and alone, beside its bounds, the chain
    floor and the launch floor) and the plain loop timed and its launches
    counted; then the GMM path, ``preprocess_window(gmm_state=)``, over
    ``GMM_WINDOWS`` windows beside the webrtc and energy decisions in
    turns (the main path whose launches are counted), and ``gmm_vad`` on
    the card against the plain loop on the CPU over the same denoised
    windows.  Returns the kernels-line measurements and the launches."""
    from mmla_audio_torch.vad import gmm

    e, tot, rows = gmm_rows(device, cfg, max(GMM_BATCHES), seed=40)
    mode = cfg.vad.aggressiveness
    full = check_g1(e, tot, rows, mode, True)
    for batch in GMM_BATCHES[:-1]:
        dec, out, *_ = check_g1(e[:batch], tot[:batch], rows[:batch], mode,
                                True)
        if not (torch.equal(dec, full[0][:batch])
                and torch.equal(out, full[1][:batch])):
            raise AssertionError(f"G1: rows at B={batch} differ from the "
                                 f"same rows at B={len(e)}")
    off = check_g1(e, tot, rows, 0, False)
    if not torch.equal(off[1], rows):
        raise AssertionError("G1 without adaptation changed a state row")
    log(f"[gmm] G1 (gmm_vad) vs the plain frame loop on the card at B="
        f"{', '.join(map(str, GMM_BATCHES))} rows of {VAD_T} frames "
        f"(denoised live windows, mode {mode} adapting): decisions equal "
        f"where the margins exceed {GMM_MARGIN} ({full[3]} frames under "
        f"them), final states within {full[2]:.3g} (limit {GMM_STATE_ATOL}) "
        f"on the {len(e) - full[4]} rows whose decisions all agree; each "
        f"row's bits equal at B=1, 8 and 64; mode 0 without adaptation "
        f"equal too, state rows untouched")
    floor, chain = queued_ms(torch.cuda._sleep, 0), g1_chain_ms()
    plain = lambda b: gmm.gmm_vad_rows_plain(   # noqa: E731
        e[:b], tot[:b], rows[:b], mode, True)
    times = {}
    for batch in GMM_BATCHES:
        args = (e[:batch], tot[:batch], rows[:batch], mode, True)
        ms = time_ms(gmm.gmm_vad_rows, *args, reps=50)
        alone = queued_ms(gmm.gmm_vad_rows, *args)
        plain_ms = time_ms(plain, batch, reps=2, rounds=3)
        times[batch] = ms, alone, plain_ms
        b = g1_bound(batch)
        log(f"[gmm] G1 B={batch}: time_ms {ms:.4f}, queued_ms {alone:.4f} "
            f"(launch floor {floor:.4f}), plain loop {plain_ms:.3f} ms (CUDA "
            f"events), bound {b['bound_ms'] * 1e3:.4f} us ({b['bound_by']}), "
            f"the chain floor {chain:.4f} ms")
    prof = profile_steps(lambda: plain(1), 1)
    log(f"[gmm] the plain loop, one window at B=1: {prof['launches']:.0f} "
        f"launches, host {prof['host_ms']:.3f} ms, device busy "
        + ("not measured" if prof["busy_ms"] is None
           else f"{prof['busy_ms']:.3f} ms (idle share {prof['idle']:.3f})"))
    noise = ambient(52)
    lat, launches, check, state, kept = gmm_latency(device, cfg, noise)
    log(f"[gmm] preprocess_window at B=1, {GMM_WINDOWS} windows, the three "
        f"decisions in turns, window to trimmed window ms (host clock) p50 / "
        f"p90: " + ", ".join(
            f"{name} {np.percentile(t, 50):.3f} / {np.percentile(t, 90):.3f}"
            for name, t in lat.items())
        + f"; GMM kept {sum(kept)} samples over the windows; launches in the "
          f"run: {launches}")
    if launches["g1"] != GMM_WINDOWS:
        raise AssertionError(f"the GMM path launched G1 {launches['g1']} "
                             f"times over {GMM_WINDOWS} windows")
    cpu_state = gmm.GmmVadState(*(t.cpu() for t in state))
    flips = under = 0
    for x in check:
        got, _ = gmm.gmm_vad(x, state, aggressiveness=mode)
        xc = x.cpu()
        ref, _, margins = gmm.gmm_vad_rows_plain(
            gmm.band_log_energies(xc)[None], gmm.total_db(xc)[None],
            gmm.state_rows(cpu_state)[None], mode, True, with_margins=True)
        clear = (margins[0] > GMM_MARGIN).all(-1)
        if not torch.equal(got.cpu()[clear], ref[0][clear]):
            raise AssertionError("gmm_vad on the card differs from the CPU's "
                                 "plain loop where the margins are clear")
        flips += int((got.cpu() != ref[0]).sum())
        under += int((~clear).sum())
    log(f"[gmm] gmm_vad on the card (its band energies and G1) == the plain "
        f"loop on the CPU over {GMM_CHECK} denoised windows where the "
        f"margins exceed {GMM_MARGIN} ({under} frames under them, {flips} "
        f"decisions differ)")
    ms, alone, plain_ms = times[max(GMM_BATCHES)]
    return dict(g1=dict(max_abs_err=full[2], ms=ms, plain_ms=plain_ms,
                        **g1_bound(max(GMM_BATCHES)), library_ms=None),
                launches=launches)


# -- phase 13: the compile cache ---------------------------------------------

CACHE_CHILD = r"""
import json
import time

t0 = time.perf_counter()
import torch

from mmla_audio_torch import _build
from mmla_audio_torch.utils.compile_cache import (compile_cache_dir,
                                                  enable_compile_cache)

enable_compile_cache(compile_cache_dir())
t1 = time.perf_counter()
lib = _build.cuda_library("gmm_vad")
print(json.dumps({"compiles": _build.compiles, "library": lib._name,
                  "dir": str(_build.build_dir()), "import_s": t1 - t0,
                  "load_s": time.perf_counter() - t1}))
"""


def phase_compile_cache(tmp: Path) -> None:
    """Two processes with ``MMLA_COMPILE_CACHE=<tmp>``: the first builds
    G1's library cold into the cache (one nvcc run), the second loads it
    from there and runs no compiler (``_build.compiles``)."""
    import os

    cache = tmp / "kernel_cache"
    env = dict(os.environ, MMLA_COMPILE_CACHE=str(cache),
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CACHE_CHILD], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"compile cache child failed:\n"
                                 f"{proc.stderr[-3000:]}")
        runs.append((json.loads(proc.stdout.splitlines()[-1]), wall))
    (cold, cold_s), (warm, warm_s) = runs
    if cold["compiles"] != 1 or warm["compiles"] != 0 or \
            cold["library"] != warm["library"] or \
            Path(warm["library"]).parent != cache:
        raise AssertionError(f"compile cache: {runs}")
    log(f"[compile cache] MMLA_COMPILE_CACHE={cache.name}: G1's library "
        f"built cold in one nvcc run (the build and load {cold['load_s']:.3f} "
        f"s after importing torch in {cold['import_s']:.2f} s; the process "
        f"{cold_s:.2f} s), then loaded by a second process with no compiler "
        f"run ({warm['load_s']:.3f} s after {warm['import_s']:.2f} s; the "
        f"process {warm_s:.2f} s)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from mmla_audio_torch.core.config import OverlapModelConfig, PipelineConfig
    from mmla_audio_torch import _build
    from mmla_audio_torch.analyze.logs import parse_log
    from mmla_audio_torch.data.wavio import write_wav
    from mmla_audio_torch.ops.cuda_features import overlap_model_input_cuda
    from mmla_audio_torch.ops.cuda_resblock import fused_resblock_cuda
    from mmla_audio_torch.params import (overlap_state_dict_from_jax,
                                         overlap_tree_shapes)
    from mmla_audio_torch.streaming.session import OverlapSession

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.cuda_libraries()
    log(f"[build] {', '.join(libs)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    noise = (np.random.RandomState(3).randn(160000) * 20).astype(np.int16)
    denoise = phase_denoise(device, noise)
    phase_denoise_hour(device, noise)
    feat = phase_featurizer(device)
    grouped = phase_grouped(device)
    block = phase_block(device)

    cfg = PipelineConfig()
    mcfg: OverlapModelConfig = cfg.overlap_model
    tree = seeded_tree(overlap_tree_shapes(mcfg), np.random.RandomState(0))
    state_dict = overlap_state_dict_from_jax(tree, mcfg)
    phase_predictor(device, state_dict, mcfg)

    n_win = cfg.audio.window_samples
    speech = speech_windows(3, n_win, seed=21)
    samples = np.concatenate([speech[0], np.zeros(n_win, np.int16),
                              speech[1], speech[2]])
    with tempfile.TemporaryDirectory() as tmp:
        zero_launch_counters()
        sess, rows = run_session(device, state_dict, cfg, samples, noise,
                                 Path(tmp) / "card")
        launches = overlap_model_input_cuda.launches
        block_launches = fused_resblock_cuda.launches_mma
        session_dn = denoise_launches()
        want_d2 = len(rows) * cfg.denoise.passes_live
        if sess.preprocess_device != device or session_dn != dict(
                d1=2 * want_d2 + 1, d2=want_d2):
            raise AssertionError(f"session: chain on "
                                 f"{sess.preprocess_device}, denoise "
                                 f"launches {session_dn}")
        labels = [r[1] for r in rows]
        logged = parse_log(sess.log.path)
        if len(rows) != 4 or len(logged) != 4 or labels[1] != "silent":
            raise AssertionError(f"session: rows {rows}, log {logged}")
        if launches <= 0 or block_launches <= 0:
            raise AssertionError(f"session launched the featurizer "
                                 f"{launches} and the fused block "
                                 f"{block_launches} times")
        _, cpu_rows = run_session("cpu", state_dict, cfg, samples, noise,
                                  Path(tmp) / "cpu")
        cpu_labels = [r[1] for r in cpu_rows]
        if labels != cpu_labels:
            raise AssertionError(f"session labels card {labels} vs CPU "
                                 f"{cpu_labels}")
        host = OverlapSession(sess.predictor, None, Path(tmp) / "host",
                              cfg=cfg, host_preprocess=True)
        host.set_noise_profile(noise)
        times = arrangement_times(sess, host, speech)
        log(f"[session] card labels {labels} == CPU labels; {len(logged)} "
            f"TSV rows; launches in the run: featurizer {launches}, "
            f"fused block on the tensor cores {block_launches}, D1 "
            f"{session_dn['d1']}, D2 {session_dn['d2']} (the default "
            f"arrangement's chain on {sess.preprocess_device}); "
            + arrangement_line(times))

        wav = Path(tmp) / "clip.wav"
        write_wav(wav, speech[0])
        proc = subprocess.run(
            [sys.executable, "-m", "mmla_audio_torch.cli", "overlap-run",
             "-f", str(wav)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or "[RESULT] clip.wav:" not in proc.stdout:
            raise AssertionError(f"CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        log("[cli] " + " | ".join(ln for ln in proc.stdout.splitlines()
                                  if ln.startswith(("[RESULT]", "[TIME]"))))

        clips = post_clips(cfg)
        post = phase_post(device, tree, state_dict, cfg, noise, Path(tmp),
                          clips)
        phase_speaker(device, cfg, noise, Path(tmp), clips)
        phase_training(device, cfg, noise, Path(tmp))
        overlap = phase_overlap_training(device, cfg, noise, Path(tmp), clips)
        mux = phase_multiplexer(device, cfg, state_dict, Path(tmp))
        mesh = phase_mesh(device, mux["pred"], cfg, Path(tmp))
        phase_distributed(device, cfg)
        phase_tensor_parallel(device, cfg, Path(tmp))
        edge = phase_edge(device, cfg, state_dict, noise, Path(tmp), clips)
        gmm = phase_gmm(device, cfg)
        phase_compile_cache(Path(tmp))

    def entry(name, source, replaces, n, measured):
        return {"name": name, "route": "cuda",
                "source": f"mmla_audio_torch/csrc/{source}",
                "replaces": replaces, "launches": n, **measured}

    # launches: the session's, the post-time pass's, overlap training's,
    # the multiplexer's (with and without a mesh), the edge sessions' and
    # the GMM path's runs, each counted from 0
    log(json.dumps({"kernels": [
        entry("overlap_features", "overlap_features.cu",
              "mmla_audio_tpu/ops/pallas_features.py:44",
              launches + post["launches"][0] + overlap["featurizer"]
              + mux["launches"]["b1"] + mesh["b1"] + edge["b1"], feat[1]),
        entry("overlap_features_grouped", "overlap_features.cu",
              "mmla_audio_tpu/ops/pallas_features.py:90",
              post["launches"][1], grouped),
        entry("fused_resblock", "fused_resblock.cu",
              "benchmarks/fused_block_probe.py:64",
              block_launches + post["launches"][2] + overlap["block"]
              + mux["launches"]["b3"] + mesh["b3"] + edge["b3"], block),
        entry("webrtc_vad", "webrtc_vad.cu",
              "mmla_audio_tpu/vad/webrtc.py:580",
              mux["launches"]["w1"] + mesh["w1"], mux["w1"]),
        entry("vad_collect", "webrtc_vad.cu",
              "mmla_audio_tpu/vad/collector.py:48",
              mux["launches"]["w2"] + mesh["w2"], mux["w2"]),
        entry("stft_rfft+istft_irfft", "denoise.cu",
              "mmla_audio_tpu/ops/denoise.py:139",
              session_dn["d1"] + post["launches"][3] + mux["launches"]["d1"]
              + mesh["d1"] + edge["d1"] + gmm["launches"]["d1"],
              denoise["d1"]),
        entry("smooth_mask", "denoise.cu",
              "mmla_audio_tpu/ops/denoise.py:381",
              session_dn["d2"] + post["launches"][4] + mux["launches"]["d2"]
              + mesh["d2"] + edge["d2"] + gmm["launches"]["d2"],
              denoise["d2"]),
        entry("gmm_vad", "gmm_vad.cu", "mmla_audio_tpu/vad/gmm.py:233",
              gmm["launches"]["g1"], gmm["g1"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
