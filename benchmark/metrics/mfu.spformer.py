"""mfu.spformer (%): the window's model operations of the SPFormer training
steps (three times each step's forward: the U-Net's from yardstick/counts.py
at its levels, the decoder's from yardstick/spformer_counts.py with the
masked attention over its open pairs) over the window's seconds times the
card's bf16 peak (989 TFLOP/s)."""

from benchmark.yardstick.counts import PEAK_BF16_FLOPS
from benchmark.yardstick.spformer_counts import open_pairs_of, train_flops


def read(ctx):
    lv = ctx.get("levels_per_step")
    if not lv or "spformer" not in ctx["cfg"]["model"]:
        return None
    opens = open_pairs_of(ctx.get("counters", {}))
    if not opens:
        return None
    flops = train_flops(lv, opens, ctx["cfg"]["model"])
    return 100.0 * flops / (ctx["window_s"] * PEAK_BF16_FLOPS)
