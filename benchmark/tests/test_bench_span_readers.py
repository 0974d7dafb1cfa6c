"""The readers of the port's stage parts, loader parts and k-NN counter on
hand-made contexts: spans in and out of the window, two plots or three
batches, counters; and nothing read without a trace."""

import collections

import pytest

from benchmark.run import metric_reader

WIN = (1_000, 100_000)


def _plots(spans):
    return {"events": {"spans": sorted(spans), "device": []}, "win": WIN,
            "passes": [{"stage_seconds": {}}, {"stage_seconds": {}}]}


@pytest.mark.parametrize("metric,span", [
    ("save_full_s.seg", "save.full_forest"),
    ("save_trees_s.seg", "save.treewise"),
    ("voxelize_s.seg", "voxelize_features.voxelize"),
    ("inference_wait_s.seg", "inference.wait_batch"),
])
def test_plot_readers(metric, span):
    read = metric_reader(metric)
    ctx = _plots([
        (2_000, 5_000, span), (10_000, 17_000, span),   # 3 + 7 us in
        (500, 1_500, span),                             # starts before
        (99_000, 100_500, span),                        # ends after
        (20_000, 90_000, "save"), (30_000, 31_000, "other")])
    # 10,000 ns of spans over two plots
    assert read(ctx) == pytest.approx(10_000 / 1e9 / 2)
    assert read(_plots([(20_000, 90_000, "save")])) is None
    assert read({"passes": ctx["passes"], "win": WIN}) is None
    assert read(dict(ctx, passes=[])) is None


def _batches(spans):
    return {"events": {"spans": sorted(spans), "device": []}, "win": WIN,
            "steps": [{"load_s": 0.0}] * 3}


def _three_batches():
    out = []
    for i, t in enumerate((2_000, 30_000, 60_000)):
        out += [(t, t + 20_000, "loader.batch"),
                (t + 100, t + 1_100, "loader.read"),      # 1,000 each
                (t + 1_200, t + 3_200, "loader.read"),    # 2,000 each
                (t + 4_000, t + 4_500, "loader.augment"),
                (t + 5_000, t + 5_250, "loader.offsets"),
                (t + 10_000, t + 10_000 + 400 * (i + 1), "loader.collate"),
                (t + 15_000, t + 19_000, "step.forward")]
    # a batch outside the window counts neither its parts nor itself
    out += [(100_500, 120_500, "loader.batch"),
            (100_600, 101_600, "loader.read")]
    return out


@pytest.mark.parametrize("metric,ns_per_batch", [
    ("loader_read_ms.train", 3_000),
    ("loader_augment_ms.train", 750),
    ("loader_collate_ms.train", (400 + 800 + 1_200) / 3),
])
def test_loader_readers(metric, ns_per_batch):
    read = metric_reader(metric)
    assert read(_batches(_three_batches())) == pytest.approx(
        ns_per_batch / 1e6)
    no_batch = [s for s in _three_batches() if s[2] != "loader.batch"]
    assert read(_batches(no_batch)) is None
    assert read(_batches([(2_000, 22_000, "loader.batch")])) is None
    assert read({"steps": [{"load_s": 0.1}], "win": WIN}) is None


@pytest.fixture
def counters(monkeypatch):
    from treelearn_tpu_torch.utils import trace

    samples = collections.deque(maxlen=16)
    monkeypatch.setattr(trace, "_COUNTS", samples)
    return samples


def test_knn_reader(counters):
    read = metric_reader("knn_us_per_query.seg")
    spans = [(2_000, 4_000, "knn.kdtree"), (4_000, 5_000, "knn.vote"),
             (10_000, 16_000, "knn.banded"), (50_000, 51_000, "knn.kdtree"),
             (51_000, 51_500, "knn.vote"), (500, 1_500, "knn.kdtree"),
             (20_000, 30_000, "assign_remaining")]
    counters.extend([(3_000, "knn.queries.kdtree_small_refs", 40),
                     (12_000, "knn.queries.banded", 50),
                     (50_500, "knn.queries.kdtree_small_refs", 10),
                     (900, "knn.queries.kdtree_small_refs", 1_000),
                     (100_001, "knn.queries.banded", 1_000),
                     (40_000, "other", 7)])
    # 10,500 ns of spans over 100 queries
    assert read(_plots(spans)) == pytest.approx(10_500 / 1e3 / 100)
    counters.clear()
    assert read(_plots(spans)) is None
    counters.append((3_000, "knn.queries.banded", 5))
    assert read(_plots([(20_000, 30_000, "assign_remaining")])) is None
    assert read({"passes": [{}], "win": WIN}) is None
