"""roofline.subm_conv.ptv3 (%): kernel 2 in PTv3 training, at the xCPE and
stem shapes: the forward convs' and input gradients' least time over the
window's steps (yardstick/ptv3_counts.py, the benchmark's own stages of
each batch) over the device seconds of ``subm_conv_wgmma_kernel``."""

from benchmark.yardstick.ptv3_counts import conv_least_s_step
from benchmark.yardstick.trace import kernel_seconds


def read(ctx):
    lv = ctx.get("levels_per_step")
    if not lv or "events" not in ctx or "ptv3" not in ctx["cfg"]["model"]:
        return None
    ptv3 = ctx["cfg"]["model"]["ptv3"]
    least = sum(conv_least_s_step(x, ptv3) for x in lv)
    t0, t1 = ctx["win"]
    sec, _ = kernel_seconds(ctx["events"], "subm_conv_wgmma_kernel", t0, t1)
    return 100.0 * least / sec if sec > 0 else None
