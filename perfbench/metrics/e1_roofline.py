"""E1's share of its roofline: the least time of the traced batches' conv
encoders (``counts/wavlm_conv.py::conv_encoder_work`` at each batch) over
the traced device time of E1's kernels (``wavlm_conv*``), in %.  Bytes at
3.35 TB/s, operations at the dense TF32 peak where the configuration
allows TF32, else at 3xTF32's.  Nothing to read where no E1 kernel ran."""

from perfbench import counts

E1 = "wavlm_conv"


def read(ctx):
    t = ctx.device_s(lambda n: E1 in n)
    if t <= 0 or not ctx.traced_batches:
        return None
    from perfbench.counts.wavlm_conv import conv_encoder_work

    peak = counts.TF32_FLOP_S \
        if ctx.system.config["matmul_precision"] == "tf32" \
        else counts.FP32_FLOP_S
    least = 0.0
    for b in ctx.traced_batches:
        flop, nbytes = conv_encoder_work(ctx.system.model,
                                         ctx.system.feature, b)
        least += max(nbytes / counts.HBM_BYTES_S, flop / peak)
    return least / t * 100.0
