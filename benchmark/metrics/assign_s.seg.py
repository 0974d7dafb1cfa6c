"""assign_s.seg (s): the k-NN assignment per plot, the mean over the
window's plots of the pipeline's assign_remaining stage."""


def read(ctx):
    p = ctx.get("passes") or []
    if not p:
        return None
    return sum(x["stage_seconds"]["assign_remaining"] for x in p) / len(p)
