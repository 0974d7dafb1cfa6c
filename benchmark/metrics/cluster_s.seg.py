"""cluster_s.seg (s): grouping per plot, the mean over the window's plots
of the pipeline's cluster stage."""


def read(ctx):
    p = ctx.get("passes") or []
    if not p:
        return None
    return sum(x["stage_seconds"]["cluster"] for x in p) / len(p)
