"""Plain voxel topology of the TreeLearn U-Net: voxel keys, the 27-offset
submanifold rules and the stride-2 downsampling of every level, worked out
with torch sorts and binary searches from the point coordinates.

Semantics, as the model states them: a point's voxel is floor((p - min of
its batch element) * float32(1 / voxel_size)), clamped into the spatial
shape; a level's submanifold rule pairs every voxel with the voxel at each
offset in (-1, 0, 1)^3 (x slowest, z fastest) where one is present; the next
level's voxels are the parents (coordinate // 2) that fall inside half the
shape, and a child whose parent falls outside is dropped.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch


class Level(NamedTuple):
    keys: torch.Tensor       # (V,) int64, sorted
    bxyz: torch.Tensor       # (V, 4) int64
    shape: tuple
    rule: torch.Tensor       # (27, V) int64, -1 where no neighbour
    parent: Optional[torch.Tensor]   # (V,) int64 into the next level, -1 dropped
    corner: Optional[torch.Tensor]   # (V,) int64 in [0, 8)


class Topology(NamedTuple):
    levels: List[Level]
    v2p: torch.Tensor        # (N,) int64 point -> level-0 voxel, -1 invalid

    def counts(self):
        return ([int(lv.keys.shape[0]) for lv in self.levels],
                [int((lv.rule >= 0).sum()) for lv in self.levels])


def _key(bxyz: torch.Tensor, shape) -> torch.Tensor:
    sx, sy, sz = shape
    return ((bxyz[:, 0] * sx + bxyz[:, 1]) * sy + bxyz[:, 2]) * sz + bxyz[:, 3]


def _offsets(device) -> torch.Tensor:
    ax = torch.tensor([-1, 0, 1], dtype=torch.int64, device=device)
    dx, dy, dz = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)], 1)


def _rule(keys: torch.Tensor, bxyz: torch.Tensor, shape) -> torch.Tensor:
    hi = torch.tensor(shape, dtype=torch.int64, device=keys.device)
    v = keys.shape[0]
    rows = []
    for off in _offsets(keys.device):
        nb = bxyz.clone()
        nb[:, 1:] += off
        inside = ((nb[:, 1:] >= 0) & (nb[:, 1:] < hi)).all(1)
        nk = _key(nb, shape)
        pos = torch.searchsorted(keys, nk).clamp(max=max(v - 1, 0))
        hit = inside & (keys[pos] == nk) if v else inside & False
        rows.append(torch.where(hit, pos, torch.full_like(pos, -1)))
    return torch.stack(rows, 0)


def voxel_ijk(coords: torch.Tensor, batch_ids: torch.Tensor,
              valid: torch.Tensor, batch_size: int, voxel_size: float,
              spatial_shape=None):
    """(ijk (N, 3) int64, shape): every valid point's voxel relative to its
    batch element's minimum corner, clamped into the shape."""
    c = coords.float()
    b = batch_ids.long().clamp(0, batch_size - 1)
    mins = torch.full((batch_size, 3), float("inf"), device=c.device)
    mins = mins.scatter_reduce(0, b[valid][:, None].expand(-1, 3), c[valid],
                               reduce="amin")
    inv = float(np.float32(1.0) / np.float32(voxel_size))
    ijk = torch.floor((c - mins[b]) * inv).long()
    if spatial_shape is None:
        spatial_shape = tuple(int(m) + 1 for m in ijk[valid].max(0).values)
    hi = torch.tensor(spatial_shape, dtype=torch.int64, device=c.device) - 1
    ijk = torch.minimum(ijk.clamp(min=0), hi)
    return ijk, tuple(int(s) for s in spatial_shape)


def topology(coords: torch.Tensor, batch_ids: torch.Tensor,
             valid: torch.Tensor, batch_size: int, voxel_size: float,
             num_levels: int, spatial_shape=None) -> Topology:
    ijk, shape = voxel_ijk(coords, batch_ids, valid, batch_size, voxel_size,
                           spatial_shape)
    bxyz = torch.cat([batch_ids.long()[:, None], ijk], 1)
    keys_all = _key(bxyz, shape)
    keys, inverse = torch.unique(keys_all[valid], sorted=True,
                                 return_inverse=True)
    v2p = torch.full((coords.shape[0],), -1, dtype=torch.int64,
                     device=coords.device)
    v2p[valid] = inverse
    levels = []
    cur_b = _decode(keys, shape)
    for lvl in range(num_levels):
        rule = _rule(keys, cur_b, shape)
        if lvl == num_levels - 1:
            levels.append(Level(keys, cur_b, shape, rule, None, None))
            break
        out_shape = tuple(s // 2 for s in shape)
        par = cur_b.clone()
        par[:, 1:] //= 2
        hi = torch.tensor(out_shape, dtype=torch.int64, device=keys.device)
        ok = (par[:, 1:] < hi).all(1)
        pkeys = _key(par, out_shape)
        nkeys, pinv = torch.unique(pkeys[ok], sorted=True, return_inverse=True)
        parent = torch.full_like(keys, -1)
        parent[ok] = pinv
        d = cur_b[:, 1:] - par[:, 1:] * 2
        corner = (d[:, 0] * 2 + d[:, 1]) * 2 + d[:, 2]
        levels.append(Level(keys, cur_b, shape, rule, parent, corner))
        keys, shape = nkeys, out_shape
        cur_b = _decode(keys, shape)
    return Topology(levels, v2p)


def _decode(keys: torch.Tensor, shape) -> torch.Tensor:
    sx, sy, sz = shape
    z = keys % sz
    r = keys // sz
    y = r % sy
    r = r // sy
    x = r % sx
    b = r // sx
    return torch.stack([b, x, y, z], 1)
