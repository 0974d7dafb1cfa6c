"""loader_wait_ms.train (ms): host milliseconds the training loop's thread
spends on a batch request to the loader's producer process (the program's
``loader.wait`` spans, one a request): their sum in the window over their
count."""

from benchmark.yardstick.trace import span_seconds


def read(ctx):
    if "events" not in ctx:
        return None
    t0, t1 = ctx["win"]
    sec = span_seconds(ctx["events"], "loader.wait", t0, t1)
    return 1e3 * sum(sec) / len(sec) if sec else None
