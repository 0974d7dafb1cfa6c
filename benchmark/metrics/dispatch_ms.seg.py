"""dispatch_ms.seg (ms): host milliseconds to dispatch one batch of the
inference loop (its ``timings["dispatch_s"]`` over its batches), the mean
over the window's batches."""


def read(ctx):
    p = ctx.get("passes") or []
    steps = sum(x["model_timings"].get("steps", 0) for x in p)
    if not steps:
        return None
    return 1e3 * sum(x["model_timings"]["dispatch_s"] for x in p) / steps
