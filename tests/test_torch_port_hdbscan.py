"""The port's HDBSCAN grouping (treelearn_tpu_torch/ops/hdbscan.py) against
the JAX package on the CPU.

The host half is the JAX package's numpy code: its functions must give equal
arrays on the same inputs.  The eps-ladder's component pass is held to the
JAX package's TPU branch (the exact banded kernel, Pallas in interpret mode);
its CPU branch is a capped approximation and no reference.  Whole clusterings
compare by ARI and cluster counts, since the port's core distances are exact
where the JAX grid pass may overestimate.
"""

import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_port_pipeline import _ari, _plot

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _blobs(n_blobs, n_per, spread, extent, seed=0, noise=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, extent, (n_blobs, 2))
    pts = np.concatenate(
        [c + rng.normal(0, spread, (n_per, 2)) for c in centers])
    if noise:
        pts = np.concatenate([pts, rng.uniform(0, extent, (noise, 2))])
    return pts.astype(np.float32)


def _varying_density():
    rng = np.random.default_rng(3)
    return np.concatenate([
        rng.normal((0, 0), 0.2, (300, 2)),
        rng.normal((4, 0), 0.2, (300, 2)),
        rng.normal((30, 30), 3.0, (300, 2)),
    ]).astype(np.float32)


def _tree_bases():
    rng = np.random.default_rng(4)
    bases = []
    for i in range(4):
        for j in range(4):
            c = np.array([10.0 * i, 10.0 * j]) + rng.uniform(-2, 2, 2)
            bases.append(c + rng.normal(0, 0.25, (400, 2)))
    return np.concatenate(
        bases + [rng.uniform(-5, 35, (500, 2))]).astype(np.float32)


def _dense_knots():
    n_knots = 24
    rng = np.random.default_rng(5)
    centers = rng.uniform(0, 80, (n_knots, 2)).astype(np.float32)
    knots = (centers[:, None, :]
             + rng.normal(0, 0.15, (n_knots, 1500, 2))).reshape(-1, 2)
    clutter = rng.uniform(0, 80, (8000, 2))
    return np.concatenate([knots, clutter]).astype(np.float32)


# the layouts of tests/test_hdbscan.py: (points, min_cluster_size)
LAYOUTS = {
    "blobs": lambda: (_blobs(6, 200, 0.3, 60, seed=2, noise=100), 50),
    "varying_density": lambda: (_varying_density(), 60),
    "tree_bases": lambda: (_tree_bases(), 100),
    "coincident": lambda: (np.zeros((500, 2), np.float32), 50),
    "dense_knots": lambda: (_dense_knots(), 50),
}
SMALL = ["blobs", "varying_density", "tree_bases"]


def _hd():
    from treelearn_tpu.ops import hdbscan as jhd
    from treelearn_tpu_torch.ops import hdbscan as phd

    return jhd, phd


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), float(np.abs(a - b).max())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ladder_and_coarse_reps_equal_jax(layout):
    jhd, phd = _hd()
    pts, m = LAYOUTS[layout]()
    core_d = np.sqrt(phd.kth_neighbor_d2(pts, m))
    for n_levels in (8, 32):
        _equal(phd._ladder(core_d, n_levels), jhd._ladder(core_d, n_levels))
    for eps in (0.05, 0.7, 9.0):
        _equal(phd._coarse_reps(pts, eps), jhd._coarse_reps(pts, eps))


@pytest.mark.parametrize("seed", range(4))
def test_union_nested_equals_jax(seed):
    jhd, phd = _hd()
    rng = np.random.default_rng(seed)
    n = 3000
    prev = rng.integers(-1, 200, n).astype(np.int32)
    cur = rng.integers(-1, 400, n).astype(np.int32)
    cur[prev == -1] = np.where(rng.random(int((prev == -1).sum())) < 0.5, -1,
                               cur[prev == -1])
    _equal(phd._union_nested(prev, cur), jhd._union_nested(prev, cur))
    _equal(phd._union_nested(np.full(n, -1, np.int32), cur),
           jhd._union_nested(np.full(n, -1, np.int32), cur))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_large_route_host_functions_equal_jax(layout):
    """_quantize_weighted, _weighted_core_distance, _knn_mst_edges,
    _levels_from_mst, the weighted _condense_and_extract and
    hdbscan_cluster_large: equal arrays on the same inputs."""
    jhd, phd = _hd()
    pts, m = LAYOUTS[layout]()
    q = phd._quantize_weighted(pts)
    _equal(q, jhd._quantize_weighted(pts))
    cells, w, _, _ = q
    core = phd._weighted_core_distance(cells, w, m)
    _equal(core, jhd._weighted_core_distance(cells, w, m))
    mst = phd._knn_mst_edges(cells, core)
    _equal(mst, jhd._knn_mst_edges(cells, core))
    eps_levels = np.geomspace(max(float(np.percentile(core, 2.0)), 1e-3),
                              max(float(core.max()), 1e-2) * 8.0, 24)
    levels = phd._levels_from_mst(*mst, core, eps_levels)
    _equal(levels, jhd._levels_from_mst(*mst, core, eps_levels))
    _equal(phd._condense_and_extract(levels, 1.0 / eps_levels, m, weights=w),
           jhd._condense_and_extract(levels, 1.0 / eps_levels, m, weights=w))
    _equal(phd.hdbscan_cluster_large(pts, m), jhd.hdbscan_cluster_large(pts, m))


@pytest.mark.parametrize("layout", SMALL)
def test_condense_and_extract_equals_jax(layout):
    """The unweighted condensed tree on the port's own ladder rows."""
    jhd, phd = _hd()
    pts, m = LAYOUTS[layout]()
    core_d = np.sqrt(phd.kth_neighbor_d2(pts, m))
    eps_levels = phd._ladder(core_d, 32)
    levels = phd._level_components(pts, core_d, eps_levels, device="cpu")
    lambdas = 1.0 / eps_levels
    _equal(phd._condense_and_extract(levels, lambdas, m),
           jhd._condense_and_extract(levels, lambdas, m))


@pytest.mark.parametrize("k", [1, 8, 50])
def test_kth_neighbor_d2_exact(k):
    """Exact self-inclusive k-th neighbor d2 against float64 brute force."""
    _, phd = _hd()
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(0, 10, (700, 2)),
                          rng.normal(5, 0.01, (300, 2))]).astype(np.float32)
    p64 = pts.astype(np.float64)
    full = ((p64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
    oracle = np.sort(full, axis=1)[:, k - 1]
    got = phd.kth_neighbor_d2(pts, k)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-12)


def test_kth_neighbor_d2_fewer_points_than_k():
    jhd, phd = _hd()
    pts = np.random.default_rng(2).uniform(0, 3, (7, 2)).astype(np.float32)
    _equal(phd.kth_neighbor_d2(pts, 10), jhd.kth_neighbor_d2(pts, 10))


def _knots(n_knots=6, per=400, clutter=600, seed=8):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 30, (n_knots, 2))
    knots = (centers[:, None, :]
             + rng.normal(0, 0.2, (n_knots, per, 2))).reshape(-1, 2)
    return np.concatenate(
        [knots, rng.uniform(0, 30, (clutter, 2))]).astype(np.float32)


def test_level_components_equals_jax_tpu_branch(monkeypatch):
    """(L, N) rows of the port's ladder on the CPU equal the JAX package's
    TPU branch (cc_labels_banded, interpret mode) with the same core
    distances; coarsen_above is lowered so _coarse_reps and _union_nested
    both run."""
    import jax

    import treelearn_tpu.ops.pallas_cc as pcc

    jhd, phd = _hd()
    pts = _knots()
    core_d = np.sqrt(phd.kth_neighbor_d2(pts, 50))
    eps_levels = phd._ladder(core_d, 8)
    log = {}
    ours = phd._level_components(pts, core_d, eps_levels, coarsen_above=1000,
                                 device="cpu", log=log)
    assert any(r < a for a, r in zip(log["active"], log["reps"]))
    monkeypatch.setattr(pcc, "_INTERPRET", True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    theirs = jhd._level_components(pts, core_d, eps_levels,
                                   coarsen_above=1000)
    _equal(ours, theirs)


@pytest.mark.parametrize("layout,n_clusters,min_ari", [
    ("blobs", 6, 0.95), ("varying_density", 3, 0.9), ("tree_bases", 16, 0.95)])
def test_hdbscan_cluster_against_jax_and_sklearn(layout, n_clusters, min_ari):
    """End to end on the ladder route: by ARI against the JAX package and
    sklearn, with the cluster counts of tests/test_hdbscan.py."""
    from sklearn.cluster import HDBSCAN

    from treelearn_tpu.ops.hdbscan import hdbscan_cluster as jax_hdbscan
    from treelearn_tpu_torch.ops.hdbscan import hdbscan_cluster

    pts, m = LAYOUTS[layout]()
    log = {}
    ours = hdbscan_cluster(pts, min_cluster_size=m, device="cpu", log=log)
    assert log["route"] == "ladder"
    oracle = HDBSCAN(min_cluster_size=m).fit(pts).labels_
    theirs = jax_hdbscan(pts, min_cluster_size=m)
    assert len(np.unique(ours[ours > 0])) == n_clusters
    assert len(np.unique(oracle[oracle >= 0])) == n_clusters
    assert _ari(ours, oracle) >= max(min_ari, 0.9)
    assert _ari(ours, theirs) >= 0.9


def test_hdbscan_cluster_small_inputs():
    from treelearn_tpu_torch.ops.hdbscan import hdbscan_cluster

    assert len(hdbscan_cluster(np.zeros((0, 2), np.float32), 50,
                               device="cpu")) == 0
    pts = np.random.default_rng(5).uniform(0, 100, (60, 2)).astype(np.float32)
    assert (hdbscan_cluster(pts, 100, device="cpu") == -1).all()


def test_device_max_dispatch_equals_jax(monkeypatch):
    """Above TL_HDBSCAN_DEVICE_MAX both packages take the same host route:
    equal labels, numbered from start_num, noise not_assigned_label."""
    from treelearn_tpu.ops.hdbscan import hdbscan_cluster as jax_hdbscan
    from treelearn_tpu_torch.ops.hdbscan import hdbscan_cluster

    monkeypatch.setenv("TL_HDBSCAN_DEVICE_MAX", "500")
    pts = _blobs(4, 400, 0.2, 30, seed=11, noise=200)
    log = {}
    ours = hdbscan_cluster(pts, min_cluster_size=60, not_assigned_label=-7,
                           start_num=3, device="cpu", log=log)
    assert log["route"] == "large"
    _equal(ours, jax_hdbscan(pts, min_cluster_size=60, not_assigned_label=-7,
                             start_num=3))
    pos = ours[ours != -7]
    assert pos.min() >= 3
    assert (np.unique(pos, return_counts=True)[1] >= 60).all()


def test_group_hdbscan_contract():
    from treelearn_tpu_torch.pipeline.instances import group_hdbscan

    pts = _blobs(3, 300, 0.3, 40, seed=6, noise=50)
    labels = group_hdbscan(pts, npoint_thr=100, not_assigned_label=-1,
                           start_num=1, device="cpu")
    tree_ids = np.unique(labels[labels >= 1])
    assert set(tree_ids) == {1, 2, 3}
    assert (labels[labels < 1] == -1).all()


def test_hdbscan_entry_points_raise_without_cuda():
    from treelearn_tpu_torch.ops.hdbscan import hdbscan_cluster
    from treelearn_tpu_torch.pipeline.instances import group_hdbscan

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pts = _blobs(2, 100, 0.2, 10, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        hdbscan_cluster(pts, 50)
    with pytest.raises(RuntimeError, match="CUDA"):
        group_hdbscan(pts, 50, -1, 1)


def _instances_inputs():
    """A small forest with an offset head that points near each tree's
    position and logits that favour the tree class on tree points."""
    from treelearn_tpu_torch.data.synthetic import make_synthetic_forest

    data, positions = make_synthetic_forest(
        n_trees=8, extent=30, points_per_tree=900, ground_points=3000, seed=4)
    rng = np.random.default_rng(0)
    coords = data[:, :3].astype(np.float32)
    tree = data[:, 3] > 0
    offset = np.zeros_like(coords)
    target = positions[np.maximum(data[:, 3].astype(np.int64) - 1, 0)]
    offset[tree, :2] = (target[tree] - coords[tree, :2]
                        + rng.normal(0, 0.15, (int(tree.sum()), 2)))
    offset[:, 2] = rng.normal(0, 0.5, len(coords))
    logits = rng.normal(0, 1, (len(coords), 2)).astype(np.float32)
    logits[tree, 1] += 3.0
    vert = rng.uniform(0.3, 1.0, (len(coords), 1)).astype(np.float32)
    return coords, offset.astype(np.float32), logits, vert


def test_get_instances_hdbscan_equals_jax(monkeypatch):
    """use_hdbscan: true with the device limit below the candidate count:
    both packages take the same host route, so the predictions are equal."""
    from treelearn_tpu.pipeline.instances import get_instances as jax_get
    from treelearn_tpu_torch.config import ConfigDict
    from treelearn_tpu_torch.pipeline.instances import get_instances

    coords, offset, logits, vert = _instances_inputs()
    cfg = ConfigDict.from_dict({
        "tree_conf_thresh": 0.5, "tau_vert": 0.6, "tau_off": 1.5,
        "tau_group": 0.15, "tau_min": 50, "use_hdbscan": True})
    monkeypatch.setenv("TL_HDBSCAN_DEVICE_MAX", "100")
    args = (coords, offset, logits, cfg, vert, 1, 0, -1, 1)
    ours = get_instances(*args, device="cpu")
    theirs = jax_get(*args)
    assert (ours > 0).sum() > 100
    _equal(ours, theirs)


def _run_both(tmp_path, device_max, monkeypatch):
    from test_integration import _pipeline_config
    from treelearn_tpu.io import load_data
    from treelearn_tpu.pipeline import run_treelearn_pipeline as jax_run
    from treelearn_tpu_torch.config import ConfigDict
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    import functools

    import treelearn_tpu.ops.features as jf
    import treelearn_tpu.ops.pallas_vert as pv

    # the JAX side's exact verticality, as in test_pipeline_matches_jax
    monkeypatch.setattr(pv, "_INTERPRET", True)
    monkeypatch.setattr(jf, "compute_verticality", functools.partial(
        jf.compute_verticality, use_banded=True))
    if device_max is not None:
        monkeypatch.setenv("TL_HDBSCAN_DEVICE_MAX", str(device_max))
    out = {}
    for side in ("jax", "port"):
        path, data = _plot(str(tmp_path / side))
        cfg = _pipeline_config(path)
        cfg.grouping.use_hdbscan = True
        cfg.whole_plot = True
        if side == "jax":
            res = jax_run(cfg)
        else:
            res = run_treelearn_pipeline(ConfigDict.from_dict(dict(cfg)),
                                         device="cpu")
        pw = np.load(osp.join(res["results_dir"], "pointwise_results",
                              "pointwise_results.npz"))
        n_cand = int((pw["instance_preds_after_initial_clustering"]
                      >= 0).sum())
        out[side] = (load_data(res["output_path"]), res["n_trees"], n_cand)
    assert len(out["port"][0]) == len(out["jax"][0]) == len(data)
    return out


def test_pipeline_hdbscan_host_route_matches_jax(tmp_path, monkeypatch):
    """HDBSCAN mode with the device limit below the candidate count: the
    same partition (ARI >= 0.999) and tree count as the JAX pipeline."""
    out = _run_both(tmp_path, 200, monkeypatch)
    assert out["port"][2] > 200
    assert out["port"][1] == out["jax"][1] > 0
    assert _ari(out["port"][0][:, 3], out["jax"][0][:, 3]) >= 0.999


def test_pipeline_hdbscan_ladder_route_against_jax(tmp_path, monkeypatch):
    """HDBSCAN mode on the default (ladder) route: ARI >= 0.9 against the
    JAX pipeline, whose CPU ladder is its capped engine."""
    out = _run_both(tmp_path, None, monkeypatch)
    assert out["port"][1] > 0
    assert _ari(out["port"][0][:, 3], out["jax"][0][:, 3]) >= 0.9


def test_pipeline_refuses_dist(tmp_path):
    """config.dist no longer raises (data-parallel inference is ported,
    parallel/mesh.py): without a process group of world size > 1 it runs
    the single-process path, with the same full-cloud labels as the run
    without it.  The 2-rank run is tests/test_torch_port_parallel.py's."""
    import torch.distributed as dist

    from test_integration import _pipeline_config
    from treelearn_tpu_torch.config import ConfigDict
    from treelearn_tpu_torch.io.pointcloud import load_data
    from treelearn_tpu_torch.pipeline import run_treelearn_pipeline

    assert not dist.is_initialized()
    labels = []
    for flag in (False, True):
        path, _ = _plot(str(tmp_path / str(flag)))
        cfg = ConfigDict.from_dict(dict(_pipeline_config(path)))
        cfg.dist = flag
        res = run_treelearn_pipeline(cfg, device="cpu")
        labels.append(load_data(res["output_path"])[:, 3])
    np.testing.assert_array_equal(labels[0], labels[1])


def test_cli_runs_default_config_on_cpu(tmp_path):
    """python -m treelearn_tpu_torch.tools.pipeline on the repository's own
    configs/pipeline/pipeline.yaml (HDBSCAN mode, full model width) with
    forest_path on a synthetic plot."""
    import yaml

    path, _ = _plot(str(tmp_path))
    with open(osp.join(REPO, "configs", "pipeline", "pipeline.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["default_args"] and "grouping" in " ".join(cfg["default_args"])
    cfg["default_args"] = [osp.join(REPO, p) for p in cfg["default_args"]]
    cfg["forest_path"] = path
    cfg["pretrain"] = None
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "treelearn_tpu_torch.tools.pipeline",
         "--config", cfg_path, "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "'n_trees'" in out.stdout
