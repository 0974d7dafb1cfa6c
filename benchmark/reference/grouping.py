"""Plain grouping and assignment of the segmentation pipeline
(github.com/ecker-lab/TreeLearn, tree_learn/util/pipeline.py:145-206,
287-296), worked out again from a run's pointwise outputs.

- Non-tree points: semantic tree confidence below ``tree_conf_thresh``
  (softmax of the two logits; class 0 is tree) are labelled 0.
- Candidates: tree points with |offset z| < ``tau_off`` and verticality
  above ``tau_vert``; verticality is 1 - |n_z|, n the eigenvector of the
  smallest eigenvalue of the covariance of the points within
  ``search_radius`` (all points, unshifted), fewer than 3 neighbours taking
  the mean of the others.
- Candidates are clustered on the xy of coords + offsets, by HDBSCAN with
  ``min_cluster_size`` ``tau_min`` where ``use_hdbscan`` is set
  (``reference/hdbscan.py``: exact), else by DBSCAN with eps ``tau_group``
  and ``min_samples`` 2 (the components of the graph joining candidates
  within eps, float64 distances, ``<=`` eps); clusters under ``tau_min``
  points dropped, the rest numbered from 1; every other tree point is -1.
- Assignment: each tree point left at -1 takes the majority label of its 5
  nearest clustered points (coords + offsets, 3-D), the smallest label
  among ties.
"""

from __future__ import annotations

import numpy as np
import torch

from .hdbscan import hdbscan_labels


def tree_mask(logits: np.ndarray, thr: float) -> np.ndarray:
    z = np.asarray(logits, np.float64)
    z = z - z.max(1, keepdims=True)
    e = np.exp(z)
    return e[:, 0] / e.sum(1) >= thr


def verticality(points: np.ndarray, query_idx: np.ndarray, radius: float,
                device, chunk: int = 8192) -> np.ndarray:
    """(Q,) float64 verticality of ``points[query_idx]`` against every
    point, from a grid of ``radius`` cells, moments in float64."""
    if len(query_idx) == 0:
        return np.zeros(0)
    p = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    lo = p.min(0).values
    ijk = torch.floor((p - lo) / radius).long()
    dims = ijk.max(0).values + 3
    key = ((ijk[:, 0] + 1) * dims[1] + ijk[:, 1] + 1) * dims[2] + ijk[:, 2] + 1
    key, order = torch.sort(key)
    ps = p[order]
    q_idx = torch.from_numpy(np.asarray(query_idx, np.int64)).to(device)
    r2 = float(np.float32(radius) * np.float32(radius))
    out = torch.empty(len(query_idx), dtype=torch.float64, device=device)
    cnt_all = torch.empty(len(query_idx), dtype=torch.float64, device=device)
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)]
    for s in range(0, len(query_idx), chunk):
        qi = q_idx[s:s + chunk]
        q = p[qi]
        qk = ijk[qi]
        mom = torch.zeros((len(qi), 10), dtype=torch.float64, device=device)
        for a, b, c in offs:
            nk = (((qk[:, 0] + 1 + a) * dims[1] + qk[:, 1] + 1 + b) * dims[2]
                  + qk[:, 2] + 1 + c)
            st = torch.searchsorted(key, nk)
            en = torch.searchsorted(key, nk, right=True)
            span = en - st
            width = int(span.max()) if len(span) else 0
            if width == 0:
                continue
            ar = torch.arange(width, device=device)
            m = ar[None, :] < span[:, None]
            idx = torch.where(m, st[:, None] + ar[None, :], 0)
            d = ps[idx] - q[:, None, :]
            d2 = (d * d).sum(-1)
            w = (m & (d2 <= r2)).double()
            dd = d.double()
            mom[:, 0] += w.sum(1)
            mom[:, 1:4] += (w[..., None] * dd).sum(1)
            iu = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
            for j, (u, v) in enumerate(iu):
                mom[:, 4 + j] += (w * dd[..., u] * dd[..., v]).sum(1)
        n = mom[:, 0].clamp(min=1.0)
        mean = mom[:, 1:4] / n[:, None]
        cov = torch.empty((len(qi), 3, 3), dtype=torch.float64, device=device)
        iu = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
        for j, (u, v) in enumerate(iu):
            val = mom[:, 4 + j] / n - mean[:, u] * mean[:, v]
            cov[:, u, v] = val
            cov[:, v, u] = val
        _, vec = torch.linalg.eigh(cov)
        out[s:s + chunk] = 1.0 - vec[:, 2, 0].abs()
        cnt_all[s:s + chunk] = mom[:, 0]
    vert = out.cpu().numpy()
    few = cnt_all.cpu().numpy() < 3
    if few.any():
        vert[few] = vert[~few].mean() if (~few).any() else 0.0
    return vert


def dbscan_labels(xy: np.ndarray, eps: float) -> np.ndarray:
    """DBSCAN(eps, min_samples=2) cluster ids from 0, -1 for noise: the
    components of the graph that joins points within ``eps``; a point with
    no other point within ``eps`` is noise."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    xy = np.asarray(xy, np.float64)
    n = len(xy)
    pairs = cKDTree(xy).query_pairs(float(eps), output_type="ndarray")
    g = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                   shape=(n, n))
    _, lab = connected_components(g, directed=False)
    alone = np.bincount(pairs.ravel(), minlength=n) == 0
    lab = lab.astype(np.int64)
    lab[alone] = -1
    return lab


def cluster(xy: np.ndarray, grouping: dict, device="cpu") -> np.ndarray:
    """The configuration's clusters numbered from 1 with clusters under
    ``tau_min`` points dropped; -1 for the rest."""
    tau_min = int(grouping["tau_min"])
    if len(xy) < tau_min:
        return np.full(len(xy), -1, np.int64)
    xy = np.asarray(xy, np.float32)
    if grouping.get("use_hdbscan", False):
        lab = hdbscan_labels(xy, tau_min, device=device)
    else:
        lab = dbscan_labels(xy, float(grouping["tau_group"]))
    out = np.full(len(xy), -1, np.int64)
    ok = lab >= 0
    uniq, inv, cnt = np.unique(lab[ok], return_inverse=True,
                               return_counts=True)
    keep = cnt >= tau_min
    new = np.full(len(uniq), -1, np.int64)
    new[keep] = np.arange(keep.sum()) + 1
    out[ok] = new[inv]
    return out


def vote5(ref_xyz: np.ndarray, ref_labels: np.ndarray, q_xyz: np.ndarray,
          k: int = 5) -> np.ndarray:
    from scipy.spatial import cKDTree

    if len(q_xyz) == 0:
        return np.zeros(0, np.int64)
    k = min(k, len(ref_xyz))
    _, nn = cKDTree(np.asarray(ref_xyz, np.float64)).query(
        np.asarray(q_xyz, np.float64), k=k)
    lab = ref_labels[nn.reshape(len(q_xyz), k)]
    lab = np.sort(lab, axis=1)
    counts = (lab[:, :, None] == lab[:, None, :]).sum(2)
    return np.take_along_axis(lab, counts.argmax(1)[:, None], 1)[:, 0]


def ari(a: np.ndarray, b: np.ndarray) -> float:
    """Adjusted Rand index of two labelings of the same points."""
    n = len(a)
    if n < 2:
        return 1.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    pair = ai.astype(np.int64) * (bi.max() + 1) + bi
    _, nij = np.unique(pair, return_counts=True)
    comb = lambda x: (x.astype(np.float64) * (x - 1) / 2.0).sum()  # noqa: E731
    sum_ij = comb(nij)
    sum_a = comb(np.bincount(ai))
    sum_b = comb(np.bincount(bi))
    expected = sum_a * sum_b / (n * (n - 1) / 2.0)
    top = (sum_a + sum_b) / 2.0
    if top == expected:
        return 1.0
    return float((sum_ij - expected) / (top - expected))


def check_grouping(dump: dict, grouping: dict, search_radius: float,
                   device) -> dict:
    """The grouping and assignment numbers of one pass, following the
    pass's own pointwise outputs (``dump``: coords, offset_predictions,
    semantic_prediction_logits, instance_preds_after_initial_clustering,
    instance_preds):

    - ``nontree_miss``: points whose label 0 disagrees with the tree test;
    - ``group_gap``: 1 - ARI of the initial labels against the
      reference's candidates and clusters, over the points that either
      clusters (a point the other leaves out counts as its own class, -1);
    - ``assign_miss``: share of the tree points left at -1 by the initial
      labels whose final label is not the 5-NN vote."""
    coords = np.asarray(dump["coords"], np.float32)
    off = np.asarray(dump["offset_predictions"], np.float32)
    logits = dump["semantic_prediction_logits"]
    init = np.asarray(dump["instance_preds_after_initial_clustering"])
    final = np.asarray(dump["instance_preds"])
    tree = tree_mask(logits, float(grouping["tree_conf_thresh"]))
    nontree_miss = int(((final == 0) != ~tree).sum())

    low = tree & (np.abs(off[:, 2]) < float(grouping["tau_off"]))
    pre = np.where(low)[0]
    vert = verticality(coords, pre, search_radius, device)
    cand = pre[vert > float(grouping["tau_vert"])]
    shifted = (coords + off).astype(np.float32)
    ref_init = np.where(tree, -1, 0).astype(np.int64)
    ref_init[cand] = cluster(shifted[cand, :2], grouping, device)
    both = (init > 0) | (ref_init > 0)
    group_gap = 1.0 - ari(init[both], ref_init[both])

    q = np.where(tree & (init == -1))[0]
    r = np.where(init > 0)[0]
    if len(q) and len(r):
        want = vote5(shifted[r], init[r], shifted[q])
        assign_miss = float((final[q] != want).mean())
    else:
        assign_miss = float((final[q] != -1).mean()) if len(q) else 0.0
    return {"nontree_miss": nontree_miss, "group_gap": group_gap,
            "assign_miss": assign_miss,
            "n_candidates": int(len(cand)), "n_trees": int(final.max()),
            "n_ref_trees": int(ref_init.max())}
