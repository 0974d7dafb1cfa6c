"""Point-cloud denoising filters: statistical and radius outlier removal
(port of treelearn_tpu/ops/filters.py).

Parity: the reference's crop-denoising knobs (sor_filter / rad_filter,
reference tree_learn/util/data_preparation.py:589-615, backed by Open3D).
Both are off by default (sample_generation.yaml:11-15).  Neighbors come from
an exact host KD-tree, where the JAX package uses its grid k-NN.  The query
point is a member of the cloud and is its own nearest neighbor (Open3D
semantics).
"""

from __future__ import annotations

import numpy as np


def _knn_idx(pts: np.ndarray, k: int) -> np.ndarray:
    from scipy.spatial import cKDTree

    _, idx = cKDTree(pts).query(pts, k=k, workers=-1)
    return idx.reshape(len(pts), k)


def sor_filter(points: np.ndarray, n_neigh_sor: int,
               multiplier_sor: float) -> np.ndarray:
    """Statistical outlier removal mask (True = keep): mean distance to the
    ``n_neigh_sor`` nearest neighbors below mean + multiplier * std
    (reference data_preparation.py:589-601)."""
    pts = np.asarray(points[:, :3], np.float32)
    assert len(pts) > 0
    k = min(int(n_neigh_sor), len(pts))
    idx = _knn_idx(pts, k)
    d = np.sqrt(((pts[:, None, :] - pts[idx]) ** 2).sum(-1)).mean(axis=1)
    thr = d.mean() + float(multiplier_sor) * d.std(ddof=1 if len(d) > 1 else 0)
    return d < thr


def rad_filter(points: np.ndarray, rad: float, npoints_rad: int) -> np.ndarray:
    """Radius outlier removal mask (True = keep): at least ``npoints_rad``
    cloud members (the point included) within ``rad``
    (reference data_preparation.py:603-615)."""
    pts = np.asarray(points[:, :3], np.float32)
    assert len(pts) > 0
    k = min(int(npoints_rad), len(pts))
    idx = _knn_idx(pts, k)
    kth_d2 = ((pts - pts[idx[:, -1]]) ** 2).sum(-1)
    keep = kth_d2 <= float(rad) ** 2
    if k < npoints_rad:
        keep[:] = False
    return keep
