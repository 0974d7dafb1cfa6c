"""mfu.ptv3 (%): the window's model operations of the PTv3 training steps
(three times each step's forward, the benchmark's own count from its own
stages of each step's batch, yardstick/ptv3_counts.py) over the window's
seconds times the card's bf16 peak (989 TFLOP/s)."""

from benchmark.yardstick.counts import PEAK_BF16_FLOPS
from benchmark.yardstick.ptv3_counts import train_step_flops


def read(ctx):
    lv = ctx.get("levels_per_step")
    if not lv or "ptv3" not in ctx["cfg"]["model"]:
        return None
    ptv3 = ctx["cfg"]["model"]["ptv3"]
    flops = sum(train_step_flops(x, ptv3) for x in lv)
    return 100.0 * flops / (ctx["window_s"] * PEAK_BF16_FLOPS)
