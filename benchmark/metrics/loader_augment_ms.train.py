"""loader_augment_ms.train (ms): host milliseconds a batch of the loader's
augmentation, offset labels and masks (the ``loader.augment`` and
``loader.offsets`` spans): their sum in the window over the
``loader.batch`` spans there."""

from benchmark.yardstick.trace import span_seconds


def read(ctx):
    if "events" not in ctx:
        return None
    t0, t1 = ctx["win"]
    n = len(span_seconds(ctx["events"], "loader.batch", t0, t1))
    sec = [s for name in ("loader.augment", "loader.offsets")
           for s in span_seconds(ctx["events"], name, t0, t1)]
    return 1e3 * sum(sec) / n if n and sec else None
