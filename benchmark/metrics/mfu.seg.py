"""mfu.seg (%): the window's forward FLOPs (the benchmark's own count from
its own voxel topology of each forward's input, yardstick/counts.py) over
the window's seconds times the card's bf16 peak (989 TFLOP/s)."""

from benchmark.yardstick.counts import PEAK_BF16_FLOPS, analytic_model_flops


def read(ctx):
    fwds = ctx.get("forward_levels")
    if not fwds:
        return None
    m = ctx["cfg"]["model"]
    flops = sum(analytic_model_flops(v, nnz, n, m["channels"],
                                     m["num_blocks"]) * times
                for v, nnz, n, times in fwds)
    return 100.0 * flops / (ctx["window_s"] * PEAK_BF16_FLOPS)
