"""mfu.train (%): the window's training FLOPs (forward, input gradient and
weight gradient of every step, the benchmark's own count from its own
topology of each step's batch, yardstick/counts.py) over the window's
seconds times the card's bf16 peak (989 TFLOP/s)."""

from benchmark.yardstick.counts import PEAK_BF16_FLOPS, train_step_flops


def read(ctx):
    lv = ctx.get("levels_per_step")
    if not lv:
        return None
    m = ctx["cfg"]["model"]
    flops = sum(train_step_flops(v, nnz, n, channels=m["channels"],
                                 num_blocks=m["num_blocks"])
                for v, nnz, n in lv)
    return 100.0 * flops / (ctx["window_s"] * PEAK_BF16_FLOPS)
