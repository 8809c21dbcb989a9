"""The whole step's share of the card's dense TF32 peak (495 TFLOP/s, the
precision the configuration states for the Conformer's products): the
model's forward FLOPs a window (``counts.model_flops``) times the windows
served a second before the profiler started, in %."""

from perfbench import counts


def read(ctx):
    run = ctx.run
    seconds = run.phase_span
    if not run.phase_windows or seconds <= 0:
        return None
    s = ctx.system
    flop = counts.model_flops(s.kind, s.model, s.feature)
    return flop * run.phase_windows / seconds / counts.TF32_FLOP_S * 100.0
