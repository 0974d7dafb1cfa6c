"""roofline.patch_attn.ptv3 (%): the patch attention's least time over the
window's steps (forward and backward, each the larger of its operations
over 989 TFLOP/s and its bytes over 3.35 TB/s; yardstick/ptv3_counts.py)
over the device seconds of the flash attention kernels (``flash_`` in the
kernel's name: forward, backward and their helpers) in the trace."""

from benchmark.yardstick.ptv3_counts import attention_least_s
from benchmark.yardstick.trace import kernel_seconds


def read(ctx):
    lv = ctx.get("levels_per_step")
    if not lv or "events" not in ctx or "ptv3" not in ctx["cfg"]["model"]:
        return None
    ptv3 = ctx["cfg"]["model"]["ptv3"]
    least = sum(attention_least_s(x, ptv3) for x in lv)
    t0, t1 = ctx["win"]
    sec, _ = kernel_seconds(ctx["events"], "flash_", t0, t1)
    return 100.0 * least / sec if sec > 0 else None
