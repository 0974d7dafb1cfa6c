"""treelearn_tpu_torch post-model stages vs the JAX package (CPU):
verticality (kernel 4's plain version), eps-graph components (kernel 5's
plain version) and the k-NN routes.  The Pallas kernels run in interpret
mode, as tests/test_pallas_vert.py and tests/test_pallas_cc.py run them."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _forest(seed=0, n_ground=2500, n_trunks=5):
    """Ground plane + vertical trunks (tests/test_pallas_vert.py:_forest)."""
    rng = np.random.default_rng(seed)
    ground = np.column_stack([
        rng.uniform(0, 10, n_ground), rng.uniform(0, 10, n_ground),
        rng.normal(scale=0.03, size=n_ground)]).astype(np.float32)
    parts = [ground]
    for _ in range(n_trunks):
        c = rng.uniform(1, 9, 2)
        m = 250
        parts.append(np.column_stack([
            c[0] + rng.normal(scale=0.04, size=m),
            c[1] + rng.normal(scale=0.04, size=m),
            rng.uniform(0, 4, m)]).astype(np.float32))
    return np.vstack(parts)


@pytest.mark.parametrize("seed", [0, 4])
def test_verticality_matches_pallas_interpret(seed, monkeypatch):
    """Counts equal the interpret-mode banded kernel's; |dvert| <= 1e-3
    after both round through float16; the > tau_vert decisions agree except
    within 1e-3 of 0.6."""
    import treelearn_tpu.ops.pallas_vert as pv
    from treelearn_tpu_torch.ops.vert import verticality

    monkeypatch.setattr(pv, "_INTERPRET", True)
    pts = _forest(seed)
    rng = np.random.default_rng(seed + 1)
    qidx = np.sort(rng.choice(len(pts), int(0.7 * len(pts)), replace=False))
    vj, cj, over = pv.verticality_banded(pts, pts[qidx], 0.6)
    vp, cp = verticality(torch.from_numpy(pts),
                         torch.from_numpy(pts[qidx]), 0.6)
    vp, cp = vp.numpy(), cp.numpy()
    ok = ~over
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(cp[ok], cj[ok])
    has = ok & (cj >= 3)
    err = np.abs(vp - vj)
    far = has & (err > 1e-3)
    # the float32 moments are centred per query here and per 64-query tile
    # in the Pallas kernel; on near-vertical, ill-conditioned neighborhoods
    # that moves the result by more than the float16 step.  Such points stay
    # rare, and there the port is at least as close to the float64 answer.
    assert far.sum() <= max(1, int(1e-3 * has.sum()))
    if far.any():
        from test_pallas_vert import _oracle

        ov, _ = _oracle(pts, pts[qidx][far], 0.6)
        assert (np.abs(vp[far] - ov) <= np.abs(vj[far] - ov) + 1e-3).all()
    differ = has & ~far & ((vp > 0.6) != (vj > 0.6))
    assert (np.abs(vj[differ] - 0.6) <= 1e-3).all()


def test_compute_verticality_query_subset_and_nan_fill():
    from treelearn_tpu_torch.ops.features import compute_verticality

    pts = _forest(2)
    # an isolated query with no neighbors takes the mean of the others
    pts = np.vstack([pts, [[50.0, 50.0, 0.0]]]).astype(np.float32)
    qidx = np.array([0, 1, 2600, len(pts) - 1])
    sub = compute_verticality(pts, 0.6, query_idx=qidx, device="cpu")
    assert sub.shape == (4, 1) and sub.dtype == np.float32
    np.testing.assert_allclose(sub[-1, 0], sub[:-1, 0].mean(), rtol=1e-6)
    full = compute_verticality(pts, 0.6, device="cpu")
    np.testing.assert_array_equal(full[qidx[:-1]], sub[:-1])


def _blobs(seed=0, n_blobs=6, pts=150, spread=0.04, sep=4.0, noise=40):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, sep * n_blobs, (n_blobs, 2))
    pts_list = [c + rng.normal(0, spread, (pts, 2)) for c in centers]
    scatter = rng.uniform(0, sep * n_blobs, (noise, 2))
    return np.vstack(pts_list + [scatter]).astype(np.float32)


def _dense_boundary():
    rng = np.random.default_rng(7)
    a = rng.normal([0.0, 0.0], 0.03, (800, 2))
    b = rng.normal([0.5, 0.0], 0.03, (800, 2))
    bridge = np.array([[0.2, 0.0], [0.3, 0.0]])
    return np.vstack([a, bridge, b]).astype(np.float32)


@pytest.mark.parametrize("case", ["blobs", "dense_boundary"])
def test_cc_matches_pallas_interpret(case, monkeypatch):
    """Plain found bits + host union-find give the interpret-mode banded
    kernel's labels exactly (the same minimum-input-index contract)."""
    import treelearn_tpu.ops.pallas_cc as pcc
    from treelearn_tpu_torch.ops.cc import cc_labels

    monkeypatch.setattr(pcc, "_INTERPRET", True)
    xy = _blobs() if case == "blobs" else _dense_boundary()
    want = pcc.cc_labels_banded(xy, eps=0.15)
    got = cc_labels(torch.from_numpy(xy), 0.15)
    np.testing.assert_array_equal(got, want)
    if case == "dense_boundary":
        assert len(np.unique(got)) == 1


def test_dbscan_cluster_matches_jax():
    from treelearn_tpu.ops.cluster import dbscan_cluster as jdb
    from treelearn_tpu_torch.ops.cluster import dbscan_cluster

    xy = _blobs(seed=3)
    want = jdb(xy, eps=0.15, min_size=50)
    got = dbscan_cluster(xy, eps=0.15, min_size=50, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(dbscan_cluster(xy[:0], 0.15, 50, device="cpu")) == 0


def _knn_case(seed, nr, nq):
    rng = np.random.default_rng(seed)
    refs = rng.uniform(0, 10, (nr, 3)).astype(np.float32)
    labels = rng.integers(1, 9, nr)
    queries = rng.uniform(0, 10, (nq, 3)).astype(np.float32)
    return refs, labels, queries


@pytest.mark.parametrize("env,route", [
    ({}, "kdtree_small_refs"),
    ({"TL_KNN_SMALL_REFS": "100", "TL_KNN_KDTREE_MIN_PAIRS": "1e5"},
     "kdtree_backstop"),
])
def test_knn_host_routes_match_jax(env, route, monkeypatch):
    from treelearn_tpu.ops.cluster import knn_classify as jknn
    from treelearn_tpu_torch.ops import cluster as pc

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    refs, labels, queries = _knn_case(0, 500, 300)
    want = jknn(refs, labels, queries, k=5)
    del pc.KNN_LOG[:]
    got = pc.knn_classify(refs, labels, queries, k=5)
    np.testing.assert_array_equal(got, want)
    assert [c[:3] for c in pc.KNN_LOG] == [(route, 500, 300)]


def test_knn_banded_route_raises(monkeypatch):
    """The banded route is the one k-NN route that needs the device: it
    raises without a card unless device='cpu', and on the CPU answers the
    JAX package's vote (its host KD-tree here)."""
    from treelearn_tpu.ops.cluster import knn_classify as jknn
    from treelearn_tpu_torch.ops import cluster as pc

    monkeypatch.setenv("TL_KNN_SMALL_REFS", "100")
    monkeypatch.setenv("TL_KNN_KDTREE_MIN_PAIRS", "1e9")
    refs, labels, queries = _knn_case(1, 500, 300)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pc.knn_classify(refs, labels, queries, k=5)
    del pc.KNN_LOG[:]
    got = pc.knn_classify(refs, labels, queries, k=5, device="cpu")
    assert pc.KNN_LOG[0].route == "banded"
    np.testing.assert_array_equal(got, jknn(refs, labels, queries, k=5))


def test_instances_match_jax(monkeypatch):
    """get_instances (deferred verticality, DBSCAN) and the 5-NN assignment
    against the JAX package, its verticality held to the exact banded kernel
    in interpret mode."""
    import functools

    import treelearn_tpu.ops.features as jf
    import treelearn_tpu.ops.pallas_vert as pv
    from treelearn_tpu.config import ConfigDict
    from treelearn_tpu.pipeline import instances as ji
    from treelearn_tpu_torch.pipeline import instances as pi

    monkeypatch.setattr(pv, "_INTERPRET", True)
    monkeypatch.setattr(jf, "compute_verticality", functools.partial(
        jf.compute_verticality, use_banded=True))
    pts = _forest(5)
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(len(pts), 2)).astype(np.float32)
    offset = (rng.normal(size=(len(pts), 3)) * 0.02).astype(np.float32)
    cfg = ConfigDict.from_dict({"tree_conf_thresh": 0.5, "tau_vert": 0.6,
                                "tau_off": 4, "tau_group": 0.15,
                                "tau_min": 20, "use_hdbscan": False})
    args = (pts, offset, logits, cfg, None, 0, 0, -1, 1)
    want = ji.get_instances(*args)
    got = pi.get_instances(*args, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 1
    tree = got != 0
    a = pi.assign_remaining_points_nearest_neighbor(
        (pts + offset)[tree], got[tree], -1)
    b = ji.assign_remaining_points_nearest_neighbor(
        (pts + offset)[tree], want[tree], -1)
    np.testing.assert_array_equal(a, b)
    # HDBSCAN mode, with the device limit below the candidate count: both
    # packages take the same host route and agree exactly
    cfg.use_hdbscan = True
    monkeypatch.setenv("TL_HDBSCAN_DEVICE_MAX", "10")
    np.testing.assert_array_equal(pi.get_instances(*args, device="cpu"),
                                  ji.get_instances(*args))
