"""forward_ms.seg (ms): the model forward on the card's stream, CUDA events
before and after each forward of the window, the mean over the forwards."""


def read(ctx):
    ms = ctx.get("forward_ms") or []
    return sum(ms) / len(ms) if ms else None
