"""output_s.seg (s): the output per plot, the mean over the window's plots
of the pipeline's save_pointwise + propagate + save stages."""


def read(ctx):
    p = ctx.get("passes") or []
    if not p:
        return None
    keys = ("save_pointwise", "propagate", "save")
    return sum(sum(x["stage_seconds"].get(k, 0.0) for k in keys)
               for x in p) / len(p)
