"""inference_wait_s.seg (s): host seconds the inference loop's main thread
waits for the loader thread's next batch (the pipeline's
``inference.wait_batch`` span) a plot: the spans in the window over the
window's plots."""

from benchmark.yardstick.trace import span_seconds


def read(ctx):
    p = ctx.get("passes") or []
    if "events" not in ctx or not p:
        return None
    t0, t1 = ctx["win"]
    sec = span_seconds(ctx["events"], "inference.wait_batch", t0, t1)
    return sum(sec) / len(p) if sec else None
