"""inference_s.seg (s): the inference loop per plot, the mean over the
window's plots of the pipeline's inference stage."""


def read(ctx):
    p = ctx.get("passes") or []
    if not p:
        return None
    return sum(x["stage_seconds"]["inference"] for x in p) / len(p)
