"""load_ms.train (ms): host milliseconds from a step's batch request to the
batch in hand (TreeLoader), the mean over the window's steps."""


def read(ctx):
    s = ctx.get("steps") or []
    return 1e3 * sum(x["load_s"] for x in s) / len(s) if s else None
