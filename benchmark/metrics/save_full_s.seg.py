"""save_full_s.seg (s): host seconds of the full plot's output files (every
format of ``save_cfg.save_formats``, the pipeline's ``save.full_forest``
span) a plot: the spans in the window over the window's plots."""

from benchmark.yardstick.trace import span_seconds


def read(ctx):
    p = ctx.get("passes") or []
    if "events" not in ctx or not p:
        return None
    t0, t1 = ctx["win"]
    sec = span_seconds(ctx["events"], "save.full_forest", t0, t1)
    return sum(sec) / len(p) if sec else None
