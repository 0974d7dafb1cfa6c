"""save_trees_s.seg (s): host seconds of the per-tree output files (all of a
plot's together, the pipeline's ``save.treewise`` span) a plot: the spans in
the window over the window's plots."""

from benchmark.yardstick.trace import span_seconds


def read(ctx):
    p = ctx.get("passes") or []
    if "events" not in ctx or not p:
        return None
    t0, t1 = ctx["win"]
    sec = span_seconds(ctx["events"], "save.treewise", t0, t1)
    return sum(sec) / len(p) if sec else None
