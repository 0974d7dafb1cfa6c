"""Grouping: DBSCAN-mode connected components and k-NN voting (port of
treelearn_tpu/ops/cluster.py and the routing of ops/pallas_knn.py).

DBSCAN(eps, min_samples=2) followed by the tau_min size filter (reference
util/pipeline.py:145-206) is exactly the connected components of the
eps-ball graph, filtered by size: every point with a neighbor is core.  The
components come from ops/cc.py (the found-bits CUDA kernel + host
union-find).

k-NN keeps the JAX package's routing (pallas_knn.py:310-421): reference sets
up to ``TL_KNN_SMALL_REFS`` (2^17) points use the host KD-tree vote, and
problems above ``TL_KNN_KDTREE_MIN_PAIRS`` (2e10) query x ref pairs use the
host KD-tree backstop.  The banded k-NN kernel that serves the sizes between
those two routes is not ported yet (ROADMAP B.5); that route raises
NotImplementedError instead of quietly answering with the host tree.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device

# (route, n_refs, n_queries) of every knn_classify call, for run reports
KNN_LOG: list = []


def relabel_components_np(labels: np.ndarray, min_size: int,
                          not_assigned_label: int = -1, start_num: int = 1):
    """Drop components smaller than min_size, relabel the rest consecutively
    from start_num (parity: group_dbscan + make_labels_consecutive, reference
    util/pipeline.py:173-206)."""
    labels = np.asarray(labels)
    out = np.full(labels.shape, not_assigned_label, np.int64)
    valid = labels >= 0
    uniq, inv, counts = np.unique(labels[valid], return_inverse=True,
                                  return_counts=True)
    keep = counts >= min_size
    new_ids = np.full(len(uniq), not_assigned_label, np.int64)
    new_ids[keep] = np.arange(keep.sum()) + start_num
    out[valid] = new_ids[inv]
    return out


def dbscan_cluster(points_xy: np.ndarray, eps: float, min_size: int,
                   not_assigned_label: int = -1, start_num: int = 1,
                   device=None) -> np.ndarray:
    """DBSCAN-mode grouping: eps-graph components on ``device`` (the CUDA
    found-bits kernel on the card), host union-find and relabel."""
    from .cc import cc_labels

    n = len(points_xy)
    if n == 0:
        return np.zeros(0, np.int64)
    dev = resolve_device(device)
    pts = torch.from_numpy(
        np.ascontiguousarray(points_xy[:, :2], np.float32)).to(dev)
    comp = cc_labels(pts, float(eps))
    return relabel_components_np(comp, min_size, not_assigned_label,
                                 start_num)


def _vote(enc_nn: np.ndarray) -> np.ndarray:
    """Row-wise mode, smallest label among ties (bincount-argmax parity)."""
    votes = np.sort(enc_nn, axis=1)
    counts = (votes[:, :, None] == votes[:, None, :]).sum(axis=2)
    return np.take_along_axis(votes, counts.argmax(axis=1)[:, None],
                              axis=1)[:, 0]


def knn_classify(ref_pts: np.ndarray, ref_labels: np.ndarray,
                 query_pts: np.ndarray, k: int = 5) -> np.ndarray:
    """Majority vote over the k nearest refs (reference KNeighborsClassifier,
    util/pipeline.py:287-331), exact up to float-equal distance ties."""
    from scipy.spatial import cKDTree

    ref_pts = np.asarray(ref_pts, np.float32)
    query_pts = np.asarray(query_pts, np.float32)
    labels = np.asarray(ref_labels).astype(np.int64)
    nq, nr = len(query_pts), len(ref_pts)
    if nq == 0:
        return np.zeros(0, np.int64)
    if nr == 0:
        raise ValueError("knn_classify: no reference points")
    small = int(os.environ.get("TL_KNN_SMALL_REFS", 1 << 17))
    min_pairs = float(os.environ.get("TL_KNN_KDTREE_MIN_PAIRS", 2e10))
    if nr <= small:
        route = "kdtree_small_refs"
    elif nr < k or nq * nr > min_pairs:
        route = "kdtree_backstop"
    else:
        KNN_LOG.append(("banded", nr, nq))
        raise NotImplementedError(
            f"knn_classify: {nr} refs x {nq} queries needs the banded k-NN "
            "kernel (treelearn_tpu/ops/pallas_knn.py), which is not ported "
            "yet (ROADMAP B.5)")
    KNN_LOG.append((route, nr, nq))
    k_eff = min(int(k), nr)
    _, nn = cKDTree(ref_pts).query(query_pts, k=k_eff, workers=-1)
    return _vote(labels[nn.reshape(nq, k_eff)])
