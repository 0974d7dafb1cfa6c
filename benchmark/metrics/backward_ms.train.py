"""backward_ms.train (ms): host milliseconds of the train step's
``step.backward`` span (profiler ranges in the window), per step."""

from benchmark.yardstick.trace import span_seconds


def read(ctx):
    if "events" not in ctx or not ctx.get("steps"):
        return None
    t0, t1 = ctx["win"]
    sec = span_seconds(ctx["events"], "step.backward", t0, t1)
    return 1e3 * sum(sec) / len(sec) if sec else None
