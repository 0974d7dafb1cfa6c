"""The plain reference against the port's CPU path at a tiny size: the
forward in both BatchNorm modes, three training steps, the topology counts,
grouping (both of the port's HDBSCAN routes) and the 5-NN assignment; the
plain HDBSCAN against a dense Prim's tree and scikit-learn's HDBSCAN."""


import numpy as np
import pytest
import torch

from benchmark.reference import grouping as G
from benchmark.reference import training as T
from benchmark.reference.sparse import topology
from benchmark.reference.unet import Net, make_weights, param_spec

C, L = 8, 3


def _cloud(n=2500, seed=0, extent=3.0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(0, extent, (n, 3)).astype(np.float32))
    bid = torch.from_numpy((rng.uniform(size=n) < 0.5).astype(np.int32))
    valid = torch.ones(n, dtype=torch.bool)
    valid[-50:] = False
    return pts, bid, valid


@pytest.mark.parametrize("training", [False, True])
def test_forward_equals_port(training):
    from treelearn_tpu_torch.model import TreeLearn

    torch.set_num_threads(1)
    w = make_weights(2**31 + 7, "cpu", C, L)
    model = TreeLearn(channels=C, num_blocks=L, spatial_shape=(40, 40, 40))
    model.load_state_dict(w, strict=True)
    model.train(training)
    pts, bid, valid = _cloud()
    out = model(pts, torch.ones(len(pts), 1), bid, valid, batch_size=2)
    topo = topology(pts, bid, valid, 2, 0.1, L, (40, 40, 40))
    sem, off = Net(dict(w), topo, L, training).forward(valid)
    for prog, ref in ((out["semantic_prediction_logits"], sem),
                      (out["offset_predictions"], off)):
        d = (prog.detach()[valid] - ref.detach()[valid]).abs().max()
        assert float(d) <= 1e-5 * float(ref.abs().max())
    v, nnz = topo.counts()
    assert v == [int(x) for x in out["n_voxels_per_level"]]
    assert nnz == [int(x) for x in out["rule_nnz_per_level"]]


def test_odd_shape_drops_children_as_the_port():
    from treelearn_tpu_torch.model import TreeLearn

    model = TreeLearn(channels=C, num_blocks=L, spatial_shape=(31, 29, 33))
    pts, bid, valid = _cloud(extent=3.2)
    out = model(pts, torch.ones(len(pts), 1), bid, valid, batch_size=2)
    v, nnz = topology(pts, bid, valid, 2, 0.1, L, (31, 29, 33)).counts()
    assert v == [int(x) for x in out["n_voxels_per_level"]]
    assert nnz == [int(x) for x in out["rule_nnz_per_level"]]


def _batch(seed):
    from treelearn_tpu_torch.data.dataset import collate_padded
    from benchmark.yardstick.synthetic import make_synthetic_forest

    samples = []
    for i in range(2):
        data, _ = make_synthetic_forest(n_trees=3, extent=9.0,
                                        points_per_tree=500,
                                        ground_points=1500, seed=seed + i)
        data[:, :2] -= 4.5
        xyz = data[:, :3]
        inst = data[:, 3].astype(np.int64)
        sem, off, ms, mo = T.labels_of(xyz, inst, 8.0)
        samples.append({"coords": xyz.astype(np.float32),
                        "input_feats": np.ones((len(xyz), 1), np.float32),
                        "instance_labels": inst, "semantic_labels": sem,
                        "offset_labels": off.astype(np.float32),
                        "masks_sem": ms, "masks_off": mo})
    return collate_padded(samples, min_bucket=1 << 12)


def test_training_steps_equal_port():
    from treelearn_tpu_torch.model import TreeLearn
    from treelearn_tpu_torch.train.loop import build_optimizer, make_train_step

    torch.set_num_threads(1)
    cfg = {"model": {"channels": C, "num_blocks": L, "voxel_size": 0.1,
                     "spatial_shape": [500, 500, 1000]},
           "optimizer": {"type": "AdamW", "lr": 0.003, "weight_decay": 0.001},
           "scheduler": {"t_initial": 10, "lr_min": 5e-5, "warmup_t": 1,
                         "warmup_lr_init": 1e-5},
           "dataloader": {"train": {"batch_size": 2}},
           "examples_per_epoch": 2, "grad_norm_clip": True}
    w = make_weights(5, "cpu", C, L)
    model = TreeLearn(channels=C, num_blocks=L, spatial_shape=(500, 500, 1000))
    model.load_state_dict(w, strict=True)
    params = [p for p in model.parameters() if p.requires_grad]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    opt, sched = build_optimizer(params, dict(cfg["optimizer"]),
                                 dict(cfg["scheduler"]), steps_per_epoch=1)
    step = make_train_step(model, opt, sched, batch_size=2,
                           compute_dtype=torch.float32, grad_norm_clip=True)
    batches = [_batch(10 * i) for i in range(3)]
    losses = []
    for i, b in enumerate(batches):
        losses.append(float(step(b)[0]))
        if i == 0:
            g1 = {n: opt.state[p]["exp_avg"] / 0.1 for n, p in zip(names, params)}
    ref_losses, ref_g1, after, _ = T.train_steps(w, param_spec(C, L),
                                                 batches, cfg, "cpu")
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert T.leaf_gap(g1, ref_g1)[0] < 1e-4
    # elementwise, Adam's step on a gradient near its eps amplifies the
    # summation order; the norms of each leaf's change agree to ~1 %
    prog_after = dict(zip(names, [p.detach() for p in params]))
    d_prog = {k: prog_after[k] - w[k] for k in after}
    d_ref = {k: after[k] - w[k] for k in after}
    assert T.leaf_gap(d_prog, d_ref)[0] < 2e-2
    assert T.loader_miss(batches[0], 8.0) == 0.0



@pytest.mark.parametrize("x, mask, missed", [
    (-4.0, False, 0),   # on the edge in float32: either side holds
    (-4.0, True, 0),
    (-3.99, False, 1),  # inside by a centimetre: the mask is wrong
    (-4.01, True, 1),
])
def test_loader_miss_edge_within_rounding(x, mask, missed):
    b = _batch(30)
    n = int(b["n_points"])
    i = int(np.where((b["instance_labels"][:n] == 0)
                     & (b["batch_ids"][:n] == 0))[0][0])
    b["coords"][i, 0] = x
    b["offset_labels"][i, 0] = 1.0 - x
    b["masks_sem"][i] = mask
    assert T.loader_miss(b, 8.0) == missed / n

def test_labels_equal_port_dataset():
    from treelearn_tpu_torch.data.dataset import (get_offset_labels,
                                                  semantic_from_instance)
    from benchmark.yardstick.synthetic import make_synthetic_forest_hard

    data, _ = make_synthetic_forest_hard(n_trees=4, extent=10.0,
                                         points_per_tree=800,
                                         ground_points=2000, seed=3)
    data[:, :2] -= 5.0
    inst = data[:, 3].astype(np.int64)
    sem_p = semantic_from_instance(inst)
    off_p, ok_p = get_offset_labels(data[:, :3], inst, sem_p)
    sem, off, _, mo = T.labels_of(data[:, :3], inst, 8.0)
    assert (sem == sem_p).all()
    np.testing.assert_allclose(off, off_p, atol=1e-5)


@pytest.mark.parametrize("route", ["ladder", "large"])
def test_grouping_and_vote_equal_port(monkeypatch, route):
    from treelearn_tpu_torch.config import ConfigDict
    from treelearn_tpu_torch.pipeline.instances import (
        assign_remaining_points_nearest_neighbor, get_instances)
    from benchmark.yardstick.synthetic import make_synthetic_forest

    if route == "large":
        monkeypatch.setenv("TL_HDBSCAN_DEVICE_MAX", "0")
    data, pos = make_synthetic_forest(n_trees=5, extent=14.0,
                                      points_per_tree=1200,
                                      ground_points=3000, seed=9)
    rng = np.random.default_rng(1)
    coords = data[:, :3].astype(np.float32)
    tree = data[:, 3] > 0
    off = np.zeros_like(coords)
    off[tree, :2] = (pos[data[tree, 3].astype(int) - 1] - coords[tree, :2]
                     + rng.normal(0, 0.1, (tree.sum(), 2)))
    off[:, 2] = rng.normal(0, 1.0, len(coords))
    logits = np.stack([np.where(tree, 1.0, -1.0), np.zeros(len(coords))], 1)
    logits += rng.normal(0, 0.5, logits.shape)
    cfg = {"tree_conf_thresh": 0.5, "tau_vert": 0.6, "tau_off": 4,
           "tau_group": 0.15, "tau_min": 50, "use_hdbscan": True}
    init = get_instances(coords, off, logits.astype(np.float32),
                         ConfigDict.from_dict(cfg), None, 0, 0, -1, 1,
                         search_radius=0.6, device="cpu")
    final = init.copy()
    tm = final != 0
    final[tm] = assign_remaining_points_nearest_neighbor(
        (coords + off)[tm], final[tm], -1, device="cpu")
    dump = {"coords": coords, "offset_predictions": off,
            "semantic_prediction_logits": logits.astype(np.float32),
            "instance_preds_after_initial_clustering": init,
            "instance_preds": final}
    got = G.check_grouping(dump, cfg, 0.6, "cpu")
    assert got["nontree_miss"] == 0
    assert got["group_gap"] < 0.01
    assert got["assign_miss"] == 0.0
    assert got["n_trees"] >= 3
    bad = dict(dump, instance_preds=np.where(final > 1, 1, final))
    assert G.check_grouping(bad, cfg, 0.6, "cpu")["assign_miss"] > 0.0


def test_ari():
    a = np.array([0, 0, 1, 1, 2, 2])
    assert G.ari(a, a[::-1] * 0 + a) == 1.0
    assert G.ari(a, np.array([5, 5, 7, 7, 9, 9])) == 1.0
    assert G.ari(a, np.array([0, 1, 0, 1, 0, 1])) < 0.0


def _blobs(seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 20, (8, 2))
    pts = [c + rng.normal(0, rng.uniform(0.1, 0.6), (rng.integers(60, 400), 2))
           for c in centers]
    pts.append(rng.uniform(0, 20, (300, 2)))
    return np.vstack(pts).astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hdbscan_tree_is_the_minimum(seed):
    """The Boruvka tree weighs what Prim's does on the dense
    mutual-reachability matrix."""
    from benchmark.reference import hdbscan as H

    xy = _blobs(seed)[::3]
    core = H.core_distances(xy, 10)
    u, v, w = H.mutual_reachability_mst(xy, core, "cpu", block=97)
    n = len(xy)
    assert len(w) == n - 1
    d = np.sqrt(((xy[:, None] - xy[None]) ** 2).sum(-1))
    d = np.maximum(d, np.maximum(core[:, None], core[None]))
    inside = np.zeros(n, bool)
    inside[0] = True
    best = d[0].copy()
    total = 0.0
    for _ in range(n - 1):
        j = int(np.argmin(np.where(inside, np.inf, best)))
        total += best[j]
        inside[j] = True
        best = np.minimum(best, d[j])
    assert abs(w.sum() - total) <= 1e-9 * total
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    g = coo_matrix((np.ones(n - 1), (u, v)), shape=(n, n))
    assert connected_components(g, directed=False)[0] == 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hdbscan_equals_sklearn(seed):
    """Labels of scikit-learn's HDBSCAN(min_cluster_size=50): the same
    condensed tree and selection on the same spanning tree, and within
    tie order (edges of equal weight merge in another order) on its own."""
    pytest.importorskip("sklearn")
    from sklearn.cluster import HDBSCAN

    from benchmark.reference import hdbscan as H

    xy = _blobs(seed)
    got = H.hdbscan_labels(xy, 50)
    want = HDBSCAN(min_cluster_size=50, copy=True).fit(xy).labels_
    assert G.ari(got, want) > 0.99
    assert len(set(got)) == len(set(want))
    try:
        from sklearn.cluster._hdbscan._linkage import (MST_edge_dtype,
                                                       make_single_linkage)
        from sklearn.cluster._hdbscan._tree import tree_to_labels
    except ImportError:
        return
    core = H.core_distances(xy, 50)
    u, v, w = H.mutual_reachability_mst(xy, core, "cpu")
    mst = np.empty(len(u), dtype=MST_edge_dtype)
    mst["current_node"], mst["next_node"], mst["distance"] = u, v, w
    mst = mst[np.argsort(mst["distance"], kind="mergesort")]
    lab, _ = tree_to_labels(make_single_linkage(mst), 50, "eom", False, 0.0,
                            None)
    assert G.ari(got, lab) == 1.0
