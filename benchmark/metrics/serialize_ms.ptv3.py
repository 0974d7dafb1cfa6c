"""serialize_ms.ptv3 (ms): host milliseconds of the program's
``ptv3.serialize`` ranges (codes, argsorts, inverses, the order shuffle;
the depth's read) in the traced window, per step."""

from benchmark.yardstick.trace import span_seconds


def read(ctx):
    if "events" not in ctx or not ctx.get("steps"):
        return None
    t0, t1 = ctx["win"]
    sec = span_seconds(ctx["events"], "ptv3.serialize", t0, t1)
    return 1e3 * sum(sec) / len(ctx["steps"]) if sec else None
