"""A2's share of its roofline: the least time of the traced batches' A2
launches (``counts.<kind>.a2_work`` at each batch, one launch a layer) over
A2's traced device time, in %.  Bytes at 3.35 TB/s, operations at the
dense TF32 peak where the configuration allows TF32, else at 3xTF32's.
Nothing to read where no A2 kernel ran or the kind has no A2."""

from perfbench import counts

A2 = "conformer_attention_kernel"


def read(ctx):
    t = ctx.device_s(lambda n: A2 in n)
    c = counts.of(ctx.system.kind)
    shape_of = getattr(c, "a2_shape", None)
    if t <= 0 or not ctx.traced_batches or shape_of is None:
        return None
    T, H, d, launches = shape_of(ctx.system.model, ctx.system.feature)
    peak = counts.TF32_FLOP_S \
        if ctx.system.config["matmul_precision"] == "tf32" \
        else counts.FP32_FLOP_S
    least = 0.0
    for b in ctx.traced_batches:
        flop, nbytes = c.a2_work(b, T, H, d)
        least += launches * max(nbytes / counts.HBM_BYTES_S, flop / peak)
    return least / t * 100.0
