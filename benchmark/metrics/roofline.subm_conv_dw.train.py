"""roofline.subm_conv_dw.train (%): kernel 3, the weight gradients: their
least time over the window's steps (yardstick/counts.py) over the device
seconds of ``dw_wgmma_kernel`` (and the ordered reduce it launches,
``dw_reduce``) in the trace."""

from benchmark.yardstick.counts import backward_least_s
from benchmark.yardstick.trace import kernel_seconds


def read(ctx):
    lv = ctx.get("levels_per_step")
    if not lv or "events" not in ctx:
        return None
    m = ctx["cfg"]["model"]
    kw = {"channels": m["channels"], "num_blocks": m["num_blocks"]}
    least = sum(backward_least_s((v, nnz), **kw)[1] for v, nnz, n in lv)
    t0, t1 = ctx["win"]
    sec = sum(kernel_seconds(ctx["events"], pat, t0, t1)[0]
              for pat in ("dw_wgmma_kernel", "dw_reduce"))
    return 100.0 * least / sec if sec > 0 else None
