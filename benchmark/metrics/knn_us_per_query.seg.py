"""knn_us_per_query.seg (us): host microseconds of the pipeline's k-NN a
query: the seconds of its ``knn.kdtree``, ``knn.banded`` and ``knn.vote``
spans in the window over the queries its ``knn.queries.<route>`` counters
took there (the program's ``utils/trace.py:counter_totals``)."""

from benchmark.yardstick.trace import span_seconds

SPANS = ("knn.kdtree", "knn.banded", "knn.vote")


def read(ctx):
    if "events" not in ctx:
        return None
    try:
        from treelearn_tpu_torch.utils.trace import counter_totals
    except ImportError:          # a program without counters
        return None
    t0, t1 = ctx["win"]
    queries = sum(n for name, n in counter_totals(t0, t1).items()
                  if name.startswith("knn.queries."))
    sec = [s for name in SPANS
           for s in span_seconds(ctx["events"], name, t0, t1)]
    return 1e6 * sum(sec) / queries if queries and sec else None
