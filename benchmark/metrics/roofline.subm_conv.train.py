"""roofline.subm_conv.train (%): kernel 2 in training, the forward convs
and the input gradients: their least time over the window's steps
(yardstick/counts.py, the benchmark's own topology of each batch) over the
device seconds of ``subm_conv_wgmma_kernel`` in the trace."""

from benchmark.yardstick.counts import backward_least_s, forward_conv_least_s
from benchmark.yardstick.trace import kernel_seconds


def read(ctx):
    lv = ctx.get("levels_per_step")
    if not lv or "events" not in ctx:
        return None
    m = ctx["cfg"]["model"]
    kw = {"channels": m["channels"], "num_blocks": m["num_blocks"]}
    least = sum(forward_conv_least_s((v, nnz), **kw)
                + backward_least_s((v, nnz), **kw)[0] for v, nnz, n in lv)
    t0, t1 = ctx["win"]
    sec, _ = kernel_seconds(ctx["events"], "subm_conv_wgmma_kernel", t0, t1)
    return 100.0 * least / sec if sec > 0 else None
