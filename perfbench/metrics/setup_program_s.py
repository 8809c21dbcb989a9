"""Seconds of the process in the program's set-up spans (``setup.*``:
kernel libraries built or loaded, predictors, streams, calibrations),
nested spans counted once: the program's part of ``setup_s``, from the
program's own record (``utils.timers.setup_seconds``).  Nothing to read
in a program without that record."""


def read(ctx):
    try:
        from mmla_audio_torch.utils import timers
    except ImportError:
        return None
    seconds = getattr(timers, "setup_seconds", None)
    if seconds is None:
        return None
    return seconds() or None
