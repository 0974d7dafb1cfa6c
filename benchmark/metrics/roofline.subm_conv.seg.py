"""roofline.subm_conv.seg (%): kernel 2's least time over the window's
forwards (max(bytes / 3.35 TB/s, 2 nnz Cin Cout / 989 TFLOP/s) per conv,
from the benchmark's own topology) over its device seconds in the trace
(``subm_conv_wgmma_kernel``)."""

from benchmark.yardstick.counts import forward_conv_least_s
from benchmark.yardstick.trace import kernel_seconds


def read(ctx):
    fwds = ctx.get("forward_levels")
    if not fwds or "events" not in ctx:
        return None
    m = ctx["cfg"]["model"]
    least = sum(forward_conv_least_s((v, nnz), channels=m["channels"],
                                     num_blocks=m["num_blocks"]) * times
                for v, nnz, n, times in fwds)
    t0, t1 = ctx["win"]
    sec, n = kernel_seconds(ctx["events"], "subm_conv_wgmma_kernel", t0, t1)
    if sec <= 0:
        return None
    return 100.0 * least / sec
