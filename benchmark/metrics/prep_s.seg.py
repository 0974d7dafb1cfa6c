"""prep_s.seg (s): the entry's host prep per plot, the mean over the
window's plots of the pipeline's load_center + voxelize_features stages."""


def read(ctx):
    p = ctx.get("passes") or []
    if not p:
        return None
    return sum(x["stage_seconds"].get("load_center", 0.0)
               + x["stage_seconds"].get("voxelize_features", 0.0)
               for x in p) / len(p)
