"""idle_share.ptv3 (%): the share of the PTv3 training cell's traced window
in which no device op ran on the card (profiler trace)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
