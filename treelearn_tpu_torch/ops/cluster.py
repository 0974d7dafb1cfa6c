"""Grouping: DBSCAN-mode connected components and k-NN voting (port of
treelearn_tpu/ops/cluster.py and the routing of ops/pallas_knn.py).

DBSCAN(eps, min_samples=2) followed by the tau_min size filter (reference
util/pipeline.py:145-206) is exactly the connected components of the
eps-ball graph, filtered by size: every point with a neighbor is core.  The
components come from ops/cc.py (the found-bits CUDA kernel + host
union-find).

k-NN keeps the JAX package's routing (pallas_knn.py:310-421): reference sets
up to ``TL_KNN_SMALL_REFS`` (2^17) points use the host KD-tree vote,
problems above ``TL_KNN_KDTREE_MIN_PAIRS`` (2e10) query x ref pairs use the
host KD-tree backstop, and the sizes between go to the banded k-NN passes of
ops/knn.py (kernel 6 on the card).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

# a KnnCall for every knn_classify call, for run reports
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


class KnnCall(NamedTuple):
    """One knn_classify call: its route and, on the banded route, each
    round's (n_queries, cell, done share, seconds) and the stragglers the
    backstop answered."""

    route: str
    n_refs: int
    n_queries: int
    rounds: tuple = ()
    n_brute: int = 0


def vote(enc_nn: np.ndarray) -> np.ndarray:
    """Row-wise mode, smallest label among ties (bincount-argmax parity)."""
    votes = np.sort(enc_nn, axis=1)
    counts = (votes[:, :, None] == votes[:, None, :]).sum(axis=2)
    return np.take_along_axis(votes, counts.argmax(axis=1)[:, None],
                              axis=1)[:, 0]


def kdtree_knn(ref_pts: np.ndarray, query_pts: np.ndarray,
               k: int) -> np.ndarray:
    """(Q, min(k, R)) indices of the nearest refs from the host KD-tree (the
    structure the reference's KNeighborsClassifier uses,
    util/pipeline.py:292)."""
    from scipy.spatial import cKDTree

    k_eff = min(int(k), len(ref_pts))
    _, nn = cKDTree(ref_pts).query(query_pts, k=k_eff, workers=-1)
    return nn.reshape(len(query_pts), k_eff)


def brute_knn(ref_pts: np.ndarray, query_pts: np.ndarray, k: int = 5,
              q_block: int = 8192, r_block: int = 32768,
              device=None) -> np.ndarray:
    """Exact k-NN with bounded memory on ``device``: queries in blocks,
    refs streamed in blocks, a running top-k per query (counterpart of
    treelearn_tpu/ops/cluster.py:brute_knn, which XLA runs).  Distances are
    differences squared and summed (``torch.cdist`` without the matmul
    form, whose cancellation can reorder near neighbors).  Fewer refs than
    k: the nearest repeats."""
    dev = resolve_device(device)
    nq, nr = len(query_pts), len(ref_pts)
    if nr == 0:
        raise ValueError("brute_knn: no reference points")
    k_eff = min(int(k), nr)
    refs = torch.from_numpy(np.ascontiguousarray(ref_pts, np.float32)).to(dev)
    out = np.empty((nq, k), np.int64)
    for lo in range(0, nq, q_block):
        q = torch.from_numpy(np.ascontiguousarray(
            query_pts[lo:lo + q_block], np.float32)).to(dev)
        best_d = torch.full((len(q), 0), torch.inf, device=dev)
        best_i = torch.zeros((len(q), 0), dtype=torch.long, device=dev)
        for r0 in range(0, nr, r_block):
            d = torch.cdist(q, refs[r0:r0 + r_block],
                            compute_mode="donot_use_mm_for_euclid_dist")
            kk = min(k_eff, d.shape[1])
            dv, di = torch.topk(d, kk, dim=1, largest=False, sorted=True)
            cat_d = torch.cat([best_d, dv], 1)
            cat_i = torch.cat([best_i, di + r0], 1)
            # stable: on equal distances the earlier ref wins
            cat_d, sel = torch.sort(cat_d, dim=1, stable=True)
            best_d = cat_d[:, :k_eff]
            best_i = torch.gather(cat_i, 1, sel[:, :k_eff])
        idx = best_i.cpu().numpy()
        if k_eff < k:
            idx = np.concatenate([idx, np.repeat(idx[:, :1], k - k_eff, 1)], 1)
        out[lo:lo + len(q)] = idx
    return out


def knn_classify(ref_pts: np.ndarray, ref_labels: np.ndarray,
                 query_pts: np.ndarray, k: int = 5,
                 device=None) -> np.ndarray:
    """Majority vote over the k nearest refs (reference KNeighborsClassifier,
    util/pipeline.py:287-331), exact up to float-equal distance ties.

    The JAX package's routing (pallas_knn.py:310-421): up to
    ``TL_KNN_SMALL_REFS`` (2^17) refs the host KD-tree; above
    ``TL_KNN_KDTREE_MIN_PAIRS`` (2e10) query x ref pairs the host KD-tree
    backstop; in between the banded k-NN passes on ``device``
    (ops/knn.py, kernel 6 on the card).  Only the banded route needs the
    device.  The route runs under the span knn.banded, or knn.kdtree and
    then knn.vote, and the counter ``knn.queries.<route>`` takes the
    call's queries (utils/trace.py)."""
    from ..utils.trace import count, span
    from . import _cuda
    from .knn import banded_knn_classify

    ref_pts = np.asarray(ref_pts, np.float32)
    query_pts = np.asarray(query_pts, np.float32)
    labels = np.asarray(ref_labels).astype(np.int64)
    nq, nr = len(query_pts), len(ref_pts)
    if nq == 0:
        return np.zeros(0, np.int64)
    if nr == 0:
        raise ValueError("knn_classify: no reference points")
    _cuda.record("knn_problem", ref_pts=ref_pts, ref_labels=labels,
                 query_pts=query_pts, k=int(k))
    small = int(os.environ.get("TL_KNN_SMALL_REFS", 1 << 17))
    min_pairs = float(os.environ.get("TL_KNN_KDTREE_MIN_PAIRS", 2e10))
    if nr <= small:
        route = "kdtree_small_refs"
    elif nr < k or nq * nr > min_pairs:
        route = "kdtree_backstop"
    else:
        info = {}
        with span("knn.banded"):
            out = banded_knn_classify(ref_pts, labels, query_pts, k=k,
                                      min_pairs=min_pairs, device=device,
                                      log=info)
        count("knn.queries.banded", nq)
        KNN_LOG.append(KnnCall("banded", nr, nq, tuple(info["rounds"]),
                               info["n_brute"]))
        return out
    with span("knn.kdtree"):
        nn = kdtree_knn(ref_pts, query_pts, k)
    with span("knn.vote"):
        out = vote(labels[nn])
    count(f"knn.queries.{route}", nq)
    KNN_LOG.append(KnnCall(route, nr, nq))
    return out
