"""End to end: seconds from the process's start to the window's opening
(the program's kernels, the weights and audio from the seed, every shape
warmed, the streams)."""


def read(ctx):
    return ctx.run.notes.get("setup_s")
