"""Point->voxel pooling and voxel->point gathering (port of
treelearn_tpu/ops/voxelize.py).

One stable sort by voxel key drives deduplication, the point->voxel map and
the "first ``max_pts`` points per voxel in scan order" pooling (reference
tree_learn/model/tree_learn.py:129-167).  The JAX version pads every output
to a static ``capacity``; here the voxel arrays have exactly ``n_voxels``
rows, and invalid points map to slot ``n_voxels``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .hashing import SENTINEL, decode_keys, encode_keys


class VoxelizedBatch(NamedTuple):
    """Result of :func:`voxelize_points`."""

    voxel_feats: torch.Tensor    # (V, F) pooled features
    voxel_coords: torch.Tensor   # (V, 4) int32 (b, x, y, z)
    voxel_keys: torch.Tensor     # (V,) sorted int32 keys
    v2p_map: torch.Tensor        # (N,) int64 point -> voxel slot; V for invalid points
    n_voxels: int
    spatial_shape: tuple         # (X, Y, Z) grid extent used for keys


def compute_voxel_ijk(coords: torch.Tensor, batch_ids: torch.Tensor,
                      valid: torch.Tensor, batch_size: int,
                      voxel_size: float) -> torch.Tensor:
    """Integer voxel coordinates relative to each batch element's min corner
    (reference tree_learn.py:134-143): floor((p - min_b) * f32(1 /
    voxel_size)).  The multiply by the float32 reciprocal is what the JAX
    package's compiled forward computes (XLA turns its division by the
    constant voxel size into that multiply), and it is the repository's
    rule for every cell index: never floor(x / cell)."""
    big = 3e38
    masked = torch.where(valid[:, None], coords, torch.full_like(coords, big))
    bid = batch_ids.long()
    in_batch = (bid >= 0) & (bid < batch_size)
    mins = torch.full((batch_size, 3), big, dtype=coords.dtype,
                      device=coords.device)
    mins.scatter_reduce_(0, bid[in_batch][:, None].expand(-1, 3),
                         masked[in_batch], reduce="amin")
    rel = coords - mins[bid.clamp(0, batch_size - 1)]
    inv = float(np.float32(1.0) / np.float32(voxel_size))
    return torch.floor(rel * inv).to(torch.int32)


def voxelize_points(coords: torch.Tensor, feats: torch.Tensor,
                    batch_ids: torch.Tensor, valid: torch.Tensor, *,
                    batch_size: int, voxel_size: float, max_pts: int = 3,
                    spatial_shape: Optional[Sequence[int]] = None,
                    use_coords: bool = False,
                    use_feats: bool = False) -> VoxelizedBatch:
    """Voxelize a flat point batch into a sorted sparse voxel grid.

    The pooled per-voxel feature is the mean of the first ``max_pts`` points
    (scan order) of ``[coords | feats]``; the coord part becomes ones unless
    ``use_coords``, the feat part unless ``use_feats``; the output order is
    ``[feats | coords]`` (reference tree_learn.py:149-156).  Points outside
    ``spatial_shape`` are clamped onto its boundary.
    """
    n = coords.shape[0]
    dev = coords.device
    ijk = compute_voxel_ijk(coords, batch_ids, valid, batch_size, voxel_size)
    if spatial_shape is None:
        live_ijk = ijk[valid]
        spatial_shape = tuple(int(m) + 1 for m in live_ijk.max(0).values)
    spatial_shape = tuple(int(s) for s in spatial_shape)
    hi = torch.tensor(spatial_shape, dtype=torch.int32, device=dev) - 1
    ijk = torch.minimum(torch.clamp(ijk, min=0), hi[None, :])

    bxyz = torch.cat([batch_ids.to(torch.int32)[:, None], ijk], dim=1)
    keys = torch.where(valid, encode_keys(bxyz, spatial_shape), SENTINEL)
    keys = keys.to(torch.int32)

    sorted_keys, order = torch.sort(keys, stable=True)
    pos = torch.arange(n, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    live = sorted_keys != SENTINEL
    first_live = first & live
    uid = torch.cumsum(first_live, 0) - 1
    n_voxels = int(first_live.sum())
    uid = torch.where(live, uid, n_voxels)
    v2p_map = torch.empty(n, dtype=torch.int64, device=dev)
    v2p_map[order] = uid
    voxel_keys = sorted_keys[first_live]

    seg_start = torch.cummax(torch.where(first, pos, 0), 0).values
    take = ((pos - seg_start) < max_pts) & live

    point_feats = torch.cat([coords, feats], dim=1)
    contrib = point_feats[order][take]
    tid = uid[take]
    f = point_feats.shape[1]
    # each taken point has its own (voxel, scan position) slot; the sum over
    # slots in scan order gives the same bits on every launch, where an
    # index_add_ adds with atomics on the card
    slots = torch.zeros((n_voxels * max_pts, f), dtype=point_feats.dtype,
                        device=dev)
    slots[tid * max_pts + (pos - seg_start)[take]] = contrib
    sums = slots.view(n_voxels, max_pts, f).sum(1)
    cnts = torch.zeros(n_voxels, dtype=point_feats.dtype, device=dev)
    cnts.index_add_(0, tid, torch.ones_like(tid, dtype=point_feats.dtype))
    pooled = sums / torch.clamp(cnts, min=1.0)[:, None]

    coord_part = pooled[:, :3]
    feat_part = pooled[:, 3:]
    if not use_coords:
        coord_part = torch.ones_like(coord_part)
    if not use_feats:
        feat_part = torch.ones_like(feat_part)
    voxel_feats = torch.cat([feat_part, coord_part], dim=1)
    return VoxelizedBatch(
        voxel_feats=voxel_feats,
        voxel_coords=decode_keys(voxel_keys, spatial_shape),
        voxel_keys=voxel_keys,
        v2p_map=v2p_map,
        n_voxels=n_voxels,
        spatial_shape=spatial_shape,
    )


def devoxelize(voxel_feats: torch.Tensor, v2p_map: torch.Tensor) -> torch.Tensor:
    """Gather per-voxel features back to points (reference tree_learn.py:99);
    invalid points (v2p == V) receive zeros."""
    v = voxel_feats.shape[0]
    if v == 0:
        return voxel_feats.new_zeros((v2p_map.shape[0], voxel_feats.shape[1]))
    out = voxel_feats[v2p_map.clamp(0, v - 1)]
    return torch.where((v2p_map < v)[:, None], out, torch.zeros_like(out))


def voxel_downsample_trace_np(points, voxel_size: float, round_decimals: int = 2):
    """Host-side voxel downsampling with trace (numpy).

    Replaces open3d's ``voxel_down_sample_and_trace`` in data preparation
    (reference: tree_learn/util/data_preparation.py:60-79): coordinates are
    rounded to 2 decimals, points are bucketed into ``voxel_size`` cubes, each
    surviving voxel gets the *centroid* of its points (open3d semantics) while
    labels/attributes are taken from the first point (by scan order) in the
    voxel, matching ``idx_keep = [item[0] for item in idx]``.

    Returns (down_xyz (V,3), first_idx (V,), inverse (N,) mapping each original
    point to its voxel row).  Voxels are ordered by first occurrence.
    """
    pts = np.round(np.asarray(points, dtype=np.float64), round_decimals)
    mins = pts.min(axis=0)
    ijk = np.floor((pts - mins) / voxel_size).astype(np.int64)
    dims = ijk.max(axis=0) + 1
    lin = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]

    order = np.argsort(lin, kind="stable")
    sorted_lin = lin[order]
    first = np.ones(len(pts), dtype=bool)
    first[1:] = sorted_lin[1:] != sorted_lin[:-1]
    uid_sorted = np.cumsum(first) - 1
    inverse = np.empty(len(pts), dtype=np.int64)
    inverse[order] = uid_sorted

    n_vox = int(uid_sorted[-1]) + 1 if len(pts) else 0
    sums = np.zeros((n_vox, 3), dtype=np.float64)
    np.add.at(sums, inverse, pts)
    cnts = np.bincount(inverse, minlength=n_vox).astype(np.float64)
    centroids = sums / cnts[:, None]

    first_idx_sorted = order[first]
    occ_order = np.argsort(first_idx_sorted, kind="stable")
    rank = np.empty(n_vox, dtype=np.int64)
    rank[occ_order] = np.arange(n_vox)
    inverse = rank[inverse]
    centroids = centroids[occ_order]
    first_idx = first_idx_sorted[occ_order]
    return centroids, first_idx, inverse


def level_voxel_counts_np(xyz, voxel_size: float, spatial_shape,
                          num_levels: int, reciprocal: bool = False):
    """Host-side exact per-level active-voxel counts for one batch element:
    the float32 min-corner grid of :func:`compute_voxel_ijk`, clamping to
    ``spatial_shape``, and the k=2 s=2 downsample rule of
    ops/sparse.py:build_downsample (``out_dim = in_dim // 2``).  The cell
    index divides by ``voxel_size`` as the JAX package's host sizing does;
    ``reciprocal`` multiplies by its float32 reciprocal instead, as the
    jitted JAX forward and :func:`compute_voxel_ijk` do."""
    p = np.asarray(xyz, np.float32)
    shape = np.asarray(spatial_shape, np.int64)
    rel = p - p.min(axis=0)
    if reciprocal:
        rel = rel * (np.float32(1.0) / np.float32(voxel_size))
    else:
        rel = rel / np.float32(voxel_size)
    ijk = np.floor(rel).astype(np.int64)
    ijk = np.clip(ijk, 0, shape - 1)

    def dedup(ijk, shape):
        keys = (ijk[:, 0] * shape[1] + ijk[:, 1]) * shape[2] + ijk[:, 2]
        uk = np.unique(keys)
        x, r = np.divmod(uk, shape[1] * shape[2])
        y, z = np.divmod(r, shape[2])
        return np.stack([x, y, z], axis=1)

    cur = dedup(ijk, shape)
    counts = [len(cur)]
    for _ in range(1, num_levels):
        out_shape = shape // 2
        parent = cur // 2
        parent = parent[np.all(parent < out_shape, axis=1)]
        cur = dedup(parent, out_shape)
        counts.append(len(cur))
        shape = out_shape
    return counts
