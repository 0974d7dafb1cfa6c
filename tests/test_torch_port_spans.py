"""The port's spans and counters (utils/trace.py) where the host works: the
pipeline's stages and their parts, the k-NN query counter and the training
loader, read from a CPU ``torch.profiler`` run as the benchmark reads them."""

import os
import os.path as osp
import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

STAGES = ("load_center", "voxelize_features", "inference", "ensemble",
          "cluster", "assign_remaining", "save_pointwise", "propagate",
          "save")
# the parts a whole-plot pass of the small plot below runs, by stage
CHILDREN = {
    "load_center": ("load_center.read", "load_center.write"),
    "voxelize_features": ("voxelize_features.read",
                          "voxelize_features.voxelize",
                          "voxelize_features.write"),
    "inference": ("inference.stream", "inference.wait_batch",
                  "harvest.forward", "harvest.wait", "harvest.host"),
    "cluster": ("cluster.filter", "cluster.verticality",
                "cluster.components"),
    "assign_remaining": ("knn.kdtree", "knn.vote"),
    "save_pointwise": ("save_pointwise.npz", "save_pointwise.las"),
    "propagate": ("propagate.edge_trees", "propagate.trace_load",
                  "propagate.scatter", "propagate.gather",
                  "propagate.decenter"),
    "save": ("save.full_forest", "save.treewise"),
}
# save_data's parts, under each of the three spans that write LAS files
LAS_PARTS = ("las.palette", "las.write")
LAS_WRITERS = ("save.full_forest", "save.treewise", "save_pointwise.las")


def _spans(prof):
    """[(start_ns, end_ns, name)] of the named ranges of a finished
    profiler run, on the ``time.time_ns`` clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and "CUDA" not in str(e.device_type()):
            s = int(e.start_ns())
            out.append((s, s + int(e.duration_ns()), e.name()))
    return sorted(out)


def _named(spans, name):
    return [(a, b) for a, b, n in spans if n == name]


def _inside(inner, outer):
    return any(a <= inner[0] and inner[1] <= b for a, b in outer)


def _config(forest_path):
    from treelearn_tpu_torch.config import ConfigDict

    return ConfigDict.from_dict({
        "forest_path": forest_path, "pretrain": None, "fp16": False,
        "tile_generation": True, "whole_plot": True,
        "model": {"kernel_size": 3, "channels": 8, "num_blocks": 3,
                  "use_feats": False, "use_coords": False, "dim_coord": 3,
                  "dim_feat": 1, "max_num_points_per_voxel": 3,
                  "fixed_modules": [], "spatial_shape": [500, 500, 1000],
                  "voxel_size": 0.1},
        "sample_generation": {
            "voxel_size": 0.1, "search_radius_features": 0.6,
            "inner_edge": 12, "outer_edge": 6, "stride": 1,
            "sample_generator": {"n_neigh_sor": None, "multiplier_sor": None,
                                 "rad": None, "npoints_rad": None}},
        "grouping": {"tree_conf_thresh": 0.5, "tau_vert": 0.6, "tau_off": 4,
                     "tau_group": 0.15, "tau_min": 50, "use_hdbscan": False},
        "dataloader": {"batch_size": 1, "num_workers": 0},
        "dataset_test": {"training": False, "data_root": "",
                         "inner_square_edge_length": 12},
        "shape_cfg": {"outer_remove": None, "alpha": 0.6,
                      "buffer_size_to_determine_edge_trees": 0.3},
        "save_cfg": {"save_formats": ["las"], "save_treewise": True,
                     "save_pointwise": True, "return_type": "original",
                     "results_dir": "results"},
    })


def _run(root, data, traced):
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    d = osp.join(root, "forest")
    os.makedirs(d)
    path = osp.join(d, "mini.npz")
    np.savez(path, points=data[:, :3].astype(np.float32), labels=data[:, 3])
    if not traced:
        return run_treelearn_pipeline(_config(path), device="cpu"), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        res = run_treelearn_pipeline(_config(path), device="cpu")
        t1 = time.time_ns()
    return res, (_spans(prof), (t0, t1))


@pytest.fixture(scope="module")
def passes(tmp_path_factory):
    """One small plot through the pipeline with nothing listening and under
    the profiler: (plain result, traced result, spans, window)."""
    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest

    data, _ = make_synthetic_forest(n_trees=6, extent=20, points_per_tree=800,
                                    ground_points=4000, seed=3)
    root = tmp_path_factory.mktemp("spans")
    plain, _ = _run(str(root / "plain"), data, traced=False)
    traced, (spans, win) = _run(str(root / "traced"), data, traced=True)
    return plain, traced, spans, win


def test_each_stage_one_span_and_its_parts_inside(passes):
    _, res, spans, _ = passes
    assert list(res["stage_seconds"]) == list(STAGES)
    ends = []
    for stage in STAGES:
        (outer,) = _named(spans, stage)
        ends.append(outer)
        for child in CHILDREN.get(stage, ()):
            got = _named(spans, child)
            assert got, child
            assert all(_inside(c, [outer]) for c in got), (child, stage)
    writers = [w for name in LAS_WRITERS for w in _named(spans, name)]
    for name in LAS_PARTS:
        got = _named(spans, name)
        assert all(_inside(c, writers) for c in got), name
        assert sum(_inside(c, _named(spans, "save.full_forest"))
                   for c in got) == 1, name
    # the stages run one after another
    assert all(a[1] <= b[0] for a, b in zip(ends[:-1], ends[1:]))
    # a part of one stage lies in no other stage
    for stage, children in CHILDREN.items():
        others = [s for x in STAGES if x != stage for s in _named(spans, x)]
        for child in children:
            assert not any(_inside(c, others) for c in _named(spans, child))


def test_stage_seconds_are_the_spans(passes):
    _, res, spans, _ = passes
    for stage in STAGES:
        (span_,) = _named(spans, stage)
        got = res["stage_seconds"][stage]
        assert abs((span_[1] - span_[0]) / 1e9 - got) < 5e-3, stage
    # the seconds are no longer rounded to 0.01 s
    assert any(v != round(v, 2) for v in res["stage_seconds"].values())


def test_span_names_are_fixed(passes):
    """No span name carries a size, a count or a file name."""
    _, _, spans, _ = passes
    bad = sorted({n for _, _, n in spans
                  if re.search(r"\d{3}|[ /()\[\]]|mini|results", n)})
    assert not bad, bad


def test_profiler_changes_no_output(passes):
    """The pointwise dump and the saved labels are bit-identical with the
    profiler listening and without it."""
    from treelearn_tpu_torch.io.las import read_las

    plain, traced, _, _ = passes
    pw = [np.load(osp.join(r["results_dir"], "pointwise_results",
                           "pointwise_results.npz")) for r in (plain, traced)]
    assert sorted(pw[0].files) == sorted(pw[1].files)
    for k in pw[0].files:
        assert np.array_equal(pw[0][k], pw[1][k], equal_nan=True), k
    las = [read_las(r["output_path"]) for r in (plain, traced)]
    assert np.array_equal(las[0].xyz, las[1].xyz)
    assert np.array_equal(np.asarray(las[0].treeID), np.asarray(las[1].treeID))
    assert np.array_equal(np.asarray(las[0].classification),
                          np.asarray(las[1].classification))
    assert plain["n_trees"] == traced["n_trees"] > 0


def test_knn_queries_counted_in_assign_remaining(passes):
    """The k-NN counters stamped inside the assign_remaining span add up to
    the points that the 5-NN assigned there: the unassigned tree points
    after the initial clustering."""
    from treelearn_tpu_torch.utils.trace import _COUNTS

    _, res, spans, (t0, t1) = passes
    (lo, hi), = _named(spans, "assign_remaining")
    got = sum(n for t, name, n in list(_COUNTS)
              if lo <= t <= hi and name.startswith("knn.queries."))
    pw = np.load(osp.join(res["results_dir"], "pointwise_results",
                          "pointwise_results.npz"))
    initial = pw["instance_preds_after_initial_clustering"]
    want = int((initial == -1).sum())
    assert want > 0 and got == want
    assert (pw["instance_preds"] != -1).all()


def test_count_records_only_while_listened():
    from treelearn_tpu_torch.utils.trace import (_COUNTS, SpanTimer, count,
                                                 counter_totals, span)

    t0 = time.time_ns()
    count("test.off", 7)
    assert counter_totals(t0, time.time_ns()) == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("test.outer"):
            count("test.on", 3)
            count("test.on")
        count("test.after", 2)
    t1 = time.time_ns()
    assert counter_totals(t0, t1) == {"test.on": 4, "test.after": 2}
    (outer,) = _named(_spans(prof), "test.outer")
    stamps = [t for t, name, _ in list(_COUNTS) if name == "test.on"
              and t0 <= t <= t1]
    assert len(stamps) == 2
    assert all(outer[0] <= t <= outer[1] for t in stamps)
    (after,) = [t for t, name, _ in list(_COUNTS) if name == "test.after"
                and t0 <= t <= t1]
    assert after > outer[1]
    with SpanTimer("cpu") as timer:
        count("test.timer", 5)
    count("test.timer", 5)
    assert timer.counters() == {"test.timer": 5}


def test_counter_samples_are_bounded(monkeypatch):
    import collections

    from treelearn_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_COUNTS", collections.deque(maxlen=4))
    with trace.SpanTimer("cpu") as timer:
        for i in range(10):
            trace.count("test.bounded", i)
    assert len(trace._COUNTS) == 4
    assert timer.counters() == {"test.bounded": 6 + 7 + 8 + 9}


def test_loader_batch_spans(tmp_path):
    """A TreeLoader batch made in this process (``num_workers=0``) is one
    loader.batch span holding each crop's read, augmentation and offsets and
    the collate; the consumer's work after the batch is handed over lies
    outside it.  (The producer process's route:
    test_torch_port_loader_producer.py.)"""
    from treelearn_tpu_torch.data.dataset import TreeDataset, TreeLoader
    from treelearn_tpu_torch.data.synthetic import (make_crop_npz,
                                                    make_synthetic_forest,
                                                    verticality_proxy)
    from treelearn_tpu_torch.utils.trace import span

    for i in range(4):
        data, _ = make_synthetic_forest(n_trees=2, extent=6,
                                        points_per_tree=300,
                                        ground_points=800, seed=i + 1)
        data[:, :2] -= data[:, :2].mean(0)
        make_crop_npz(str(tmp_path / f"c{i}.npz"), data,
                      verticality_proxy(data))
    ds = TreeDataset(str(tmp_path), inner_square_edge_length=4.0,
                     training=True, data_augmentations={"jitter": True,
                                                        "rot": True})
    loader = iter(TreeLoader(ds, batch_size=2, training=True, seed=1,
                             min_bucket=2048, num_workers=0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch = next(loader)
        with span("test.consumer"):
            float(np.asarray(batch["coords"]).sum())
    spans = _spans(prof)
    (outer,) = _named(spans, "loader.batch")
    for name, n in (("loader.read", 2), ("loader.augment", 2),
                    ("loader.offsets", 2), ("loader.collate", 1)):
        got = _named(spans, name)
        assert len(got) == n, name
        assert all(_inside(c, [outer]) for c in got), name
    (consumer,) = _named(spans, "test.consumer")
    assert consumer[0] >= outer[1]
