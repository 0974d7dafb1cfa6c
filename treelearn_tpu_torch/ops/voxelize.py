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
from torch.autograd.function import once_differentiable

from ..utils.trace import count
from . import _cuda
from .hashing import SENTINEL, decode_keys, encode_keys


class VoxelizedBatch(NamedTuple):
    """Result of :func:`voxelize_points`."""

    voxel_feats: torch.Tensor    # (V, F) pooled features
    voxel_coords: torch.Tensor   # (V, 4) int32 (b, x, y, z)
    voxel_keys: torch.Tensor     # (V,) sorted int32 keys
    v2p_map: torch.Tensor        # (N,) int64 point -> voxel slot; V for invalid points
    n_voxels: int
    spatial_shape: tuple         # (X, Y, Z) grid extent used for keys
    # the stable sort of the points' keys: each voxel's points in ascending
    # point index, invalid points last; devoxelize's backward on the card
    # builds its voxel -> point CSR from it (voxel_point_csr)
    order: torch.Tensor          # (N,) int64
    # voxels of each batch element (their rows are consecutive, in element
    # order), when asked for: read with n_voxels, in the same host read
    elem_counts: Optional[tuple] = None


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
                    use_feats: bool = False,
                    elem_counts: bool = False) -> VoxelizedBatch:
    """Voxelize a flat point batch into a sorted sparse voxel grid.

    The pooled per-voxel feature is the mean of the first ``max_pts`` points
    (scan order) of ``[coords | feats]``; the coord part becomes ones unless
    ``use_coords``, the feat part unless ``use_feats``; the output order is
    ``[feats | coords]`` (reference tree_learn.py:149-156).  Points outside
    ``spatial_shape`` are clamped onto its boundary.  With ``elem_counts``
    the voxels of each batch element come back too, read in the same host
    read as the voxel count.
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
    if elem_counts:
        per_elem = torch.zeros(batch_size, dtype=torch.int64, device=dev)
        per_elem.scatter_add_(
            0, batch_ids.long()[order].clamp(0, batch_size - 1),
            first_live.long())
        per_elem = tuple(per_elem.tolist())
        n_voxels = sum(per_elem)
    else:
        per_elem = None
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
        order=order,
        elem_counts=per_elem,
    )


def voxel_point_csr(order: torch.Tensor, v2p_map: torch.Tensor,
                    n_voxels: int):
    """The voxel -> point CSR (p_order (N,) int32, v_start (V + 1,) int32)
    of a :class:`VoxelizedBatch`'s ``order`` and ``v2p_map``: voxel v's
    points are ``p_order[v_start[v]:v_start[v + 1]]``, in ascending point
    index, and ``v_start[V]`` is the live point count.  No sort and no host
    read: the voxel ids ascend along ``order`` (invalid points, id V, last),
    so each voxel's run starts where its id is first reached."""
    v_start = torch.searchsorted(
        v2p_map[order], torch.arange(n_voxels + 1, device=order.device),
        out_int32=True)
    return order.to(torch.int32), v_start


def devoxelize_plain(voxel_feats: torch.Tensor,
                     v2p_map: torch.Tensor) -> torch.Tensor:
    """The gather of :func:`devoxelize` in plain torch ops."""
    v = voxel_feats.shape[0]
    if v == 0:
        return voxel_feats.new_zeros((v2p_map.shape[0], voxel_feats.shape[1]))
    out = voxel_feats[v2p_map.clamp(0, v - 1)]
    return torch.where((v2p_map < v)[:, None], out, torch.zeros_like(out))


def devoxelize_backward_plain(grad: torch.Tensor, v2p_map: torch.Tensor,
                              n_voxels: int) -> torch.Tensor:
    """Each voxel's sum of its live points' gradient rows, taken in float32
    (float64 stays float64) in ascending point order and rounded once to
    the gradient's dtype: the arithmetic of ``csrc/devoxelize.cu``'s
    backward."""
    acc_dtype = torch.float64 if grad.dtype == torch.float64 else torch.float32
    live = v2p_map < n_voxels
    acc = torch.zeros((n_voxels, grad.shape[1]), dtype=acc_dtype,
                      device=grad.device)
    acc.index_add_(0, v2p_map[live], grad[live].to(acc_dtype))
    return acc.to(grad.dtype)


def _lanes(t: torch.Tensor, name: str) -> int:
    """16-byte lanes a row of ``t`` for the kernels of
    ``csrc/devoxelize.cu``; raises on what they do not take."""
    _cuda.require(t, name, (torch.bfloat16, torch.float32), 2)
    lanes, rest = divmod(t.shape[1] * t.element_size(), 16)
    if rest or lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"{name}: rows of {t.shape[1]} {t.dtype} channels "
                         f"are not 1, 2, 4, 8, 16 or 32 lanes of 16 bytes")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")
    return lanes


def devoxelize_cuda(voxel_feats: torch.Tensor,
                    v2p_map: torch.Tensor) -> torch.Tensor:
    """The gather of :func:`devoxelize` on the card (``tl_devoxelize_fwd``)."""
    feats = voxel_feats.contiguous()
    lanes = _lanes(feats, "devoxelize feats")
    _cuda.require(v2p_map, "devoxelize v2p_map", torch.int64, 1)
    n, v = v2p_map.shape[0], feats.shape[0]
    out = feats.new_empty((n, feats.shape[1]))
    if n == 0:
        return out
    if v == 0:
        return out.zero_()
    code = _cuda.library().tl_devoxelize_fwd(
        feats.data_ptr(), v2p_map.data_ptr(), out.data_ptr(), n, v, lanes,
        _cuda.stream_ptr(feats))
    _cuda.check(code, "tl_devoxelize_fwd")
    _cuda.LAUNCHES["devoxelize_fwd"] += 1
    return out


def devoxelize_backward_cuda(grad: torch.Tensor, p_order: torch.Tensor,
                             v_start: torch.Tensor) -> torch.Tensor:
    """:func:`devoxelize_backward_plain` on the card
    (``tl_devoxelize_bwd``), walking the voxel -> point CSR of
    :class:`VoxelizedBatch`."""
    grad = grad.contiguous()
    lanes = _lanes(grad, "devoxelize grad")
    _cuda.require(p_order, "devoxelize p_order", torch.int32, 1)
    _cuda.require(v_start, "devoxelize v_start", torch.int32, 1)
    v = v_start.shape[0] - 1
    dfeats = grad.new_empty((v, grad.shape[1]))
    if v == 0:
        return dfeats
    code = _cuda.library().tl_devoxelize_bwd(
        grad.data_ptr(), p_order.data_ptr(), v_start.data_ptr(),
        dfeats.data_ptr(), v, lanes, int(grad.dtype == torch.bfloat16),
        _cuda.stream_ptr(grad))
    _cuda.check(code, "tl_devoxelize_bwd")
    _cuda.LAUNCHES["devoxelize_bwd"] += 1
    return dfeats


class DevoxelizeFn(torch.autograd.Function):
    """The gather and, as its backward, each voxel's sum of its own points'
    gradient rows.  CPU tensors take the plain versions; CUDA tensors launch
    the kernels of ``csrc/devoxelize.cu`` or raise, the backward over the
    CSR of :func:`voxel_point_csr`, built only when a backward runs.  The
    counter ``devoxelize.bwd.<route>`` (``cuda`` or ``plain``) takes one a
    backward."""

    @staticmethod
    def forward(ctx, voxel_feats, v2p_map, order):
        ctx.n_voxels = voxel_feats.shape[0]
        ctx.save_for_backward(v2p_map, order)
        if voxel_feats.is_cuda:
            return devoxelize_cuda(voxel_feats, v2p_map)
        return devoxelize_plain(voxel_feats, v2p_map)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        v2p_map, order = ctx.saved_tensors
        if not grad.is_cuda:
            count("devoxelize.bwd.plain")
            return (devoxelize_backward_plain(grad, v2p_map, ctx.n_voxels),
                    None, None)
        count("devoxelize.bwd.cuda")
        p_order, v_start = voxel_point_csr(order, v2p_map, ctx.n_voxels)
        return devoxelize_backward_cuda(grad, p_order, v_start), None, None


def devoxelize(voxel_feats: torch.Tensor, vb: VoxelizedBatch) -> torch.Tensor:
    """Gather per-voxel features (``vb.n_voxels`` rows) back to the points of
    ``vb`` (reference tree_learn.py:99); invalid points (v2p == V) receive
    zeros.  The gradient is each voxel's sum of its points' gradient
    rows."""
    return DevoxelizeFn.apply(voxel_feats, vb.v2p_map, vb.order)


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
