"""match_ms.spformer (ms): host milliseconds of the program's
``spformer.match`` ranges (targets, cost matrices, their one read to the
host, the assignments) in the traced window, per step."""

from benchmark.yardstick.trace import span_seconds


def read(ctx):
    if "events" not in ctx or not ctx.get("steps"):
        return None
    t0, t1 = ctx["win"]
    sec = span_seconds(ctx["events"], "spformer.match", t0, t1)
    return 1e3 * sum(sec) / len(ctx["steps"]) if sec else None
