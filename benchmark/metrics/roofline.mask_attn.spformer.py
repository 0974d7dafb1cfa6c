"""roofline.mask_attn.spformer (%): the masked cross-attentions' least
time over the window's steps (yardstick/spformer_counts.py: operations
over their open pairs, the ``spformer.open_pairs.l<l>`` counters; bytes of
q, k, v, o, the mask, dO and the statistics) over the device seconds of
the memory-efficient attention kernels that compute them (``fmha_cutlass``
in the kernel's name: forward and backward)."""

from benchmark.yardstick.spformer_counts import (attention_least_s,
                                                 open_pairs_of)
from benchmark.yardstick.trace import kernel_seconds


def read(ctx):
    lv = ctx.get("levels_per_step")
    spf = ctx["cfg"]["model"].get("spformer")
    if not lv or "events" not in ctx or not spf:
        return None
    opens = open_pairs_of(ctx.get("counters", {}))
    if not opens:
        return None
    t0, t1 = ctx["win"]
    sec, _ = kernel_seconds(ctx["events"], "fmha_cutlass", t0, t1)
    return 100.0 * attention_least_s(lv, opens, spf) / sec if sec > 0 else None
