"""Geometric point features: verticality via neighborhood covariance (port of
treelearn_tpu/ops/features.py).

verticality = 1 - |n_z|, n the unit eigenvector of the smallest eigenvalue
of the radius-neighborhood covariance (jakteristics / CloudCompare; reference
tree_learn/util/data_preparation.py:83-100, radius 0.6).  The neighborhood
moments come from ops/vert.py (the CUDA kernel on the card, its plain
version on the CPU); both are exact, so the JAX package's capped, strided
XLA pass has no counterpart here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device


def verticality_from_cov6(xx, xy, xz, yy, yz, zz):
    """|z| of the smallest-eigenvalue eigenvector of symmetric 3x3 matrices
    given as six (N,) component columns, in closed form (trigonometric
    eigenvalue, then the largest cross product of two rows of A - l I)."""
    q = (xx + yy + zz) / 3.0
    axx, ayy, azz = xx - q, yy - q, zz - q
    p2 = (axx * axx + ayy * ayy + azz * azz
          + 2.0 * (xy * xy + xz * xz + yz * yz)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    bxx, byy, bzz = axx / p, ayy / p, azz / p
    bxy, bxz, byz = xy / p, xz / p, yz / p
    detb = (bxx * (byy * bzz - byz * byz)
            - bxy * (bxy * bzz - byz * bxz)
            + bxz * (bxy * byz - byy * bxz)) / 2.0
    detb = torch.clamp(detb, -1.0, 1.0)
    phi = torch.arccos(detb) / 3.0
    eig_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    mxx, myy, mzz = xx - eig_min, yy - eig_min, zz - eig_min
    crosses = []
    for (a0, a1, a2), (b0, b1, b2) in (
            ((mxx, xy, xz), (xy, myy, yz)),   # r0 x r1
            ((mxx, xy, xz), (xz, yz, mzz)),   # r0 x r2
            ((xy, myy, yz), (xz, yz, mzz))):  # r1 x r2
        cx = a1 * b2 - a2 * b1
        cy = a2 * b0 - a0 * b2
        cz = a0 * b1 - a1 * b0
        crosses.append((cz, cx * cx + cy * cy + cz * cz))
    (z0, n0), (z1, n1), (z2, n2) = crosses
    best01_z = torch.where(n0 >= n1, z0, z1)
    best01_n = torch.maximum(n0, n1)
    best_z = torch.where(best01_n >= n2, best01_z, z2)
    best_n = torch.maximum(best01_n, n2)
    return torch.abs(best_z) / torch.sqrt(torch.clamp(best_n, min=1e-40))


def compute_verticality(points: np.ndarray, search_radius: float = 0.6,
                        query_idx: np.ndarray = None,
                        device=None) -> np.ndarray:
    """(N, 1) float32 verticality of every point — or (len(query_idx), 1)
    when ``query_idx`` selects query rows (neighborhoods always come from the
    full cloud; the deferred-verticality path of pipeline/instances.py
    evaluates only the grouping filter's candidates).  Points with fewer
    than 3 neighbors take the mean of the others (reference
    replace_nanfeatures, data_preparation.py:91-100)."""
    from .vert import verticality

    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    queries = points if query_idx is None else points[np.asarray(query_idx)]
    if len(queries) == 0:
        return np.zeros((0, 1), np.float32)
    pts_t = torch.from_numpy(points).to(dev)
    q_t = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    vert_t, cnt_t = verticality(pts_t, q_t, float(search_radius))
    vert = torch.where(cnt_t >= 3, vert_t, torch.nan).cpu().numpy()
    nanmask = np.isnan(vert)
    if nanmask.any():
        mean = np.nanmean(vert) if not nanmask.all() else 0.0
        vert = np.where(nanmask, mean, vert)
    return vert.astype(np.float32)[:, None]
