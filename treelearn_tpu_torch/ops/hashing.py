"""Voxel-key hashing primitives (port of treelearn_tpu/ops/hashing.py).

Every U-Net level's active set is a sorted int32 linear-key array; keys are
``(((b * X + x) * Y + y) * Z + z)`` over the spatial shape, z fastest.  The
JAX package pads these arrays to static capacities; PyTorch runs eagerly, so
the port keeps exact lengths and ``SENTINEL`` only marks out-of-range
probes and invalid points.
"""

from __future__ import annotations

import torch

# Sentinel key for invalid entries. Sorts to the end.
SENTINEL = 2**31 - 1


def encode_keys(coords: torch.Tensor, spatial_shape) -> torch.Tensor:
    """(V, 4) ``(b, x, y, z)`` integer coords -> (V,) int32 keys.

    Out-of-range or negative coords map to SENTINEL.  ``spatial_shape`` is a
    3-sequence of python ints.  The key is formed in int64 and narrowed only
    where it is in range, so probes past the grid never wrap.
    """
    sx, sy, sz = (int(s) for s in spatial_shape)
    c = coords.long()
    b, x, y, z = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    key = ((b * sx + x) * sy + y) * sz + z
    in_range = ((x >= 0) & (x < sx) & (y >= 0) & (y < sy) & (z >= 0)
                & (z < sz) & (b >= 0))
    return torch.where(in_range, key, SENTINEL).to(torch.int32)


def decode_keys(keys: torch.Tensor, spatial_shape) -> torch.Tensor:
    """int32 keys -> (V, 4) int32 ``(b, x, y, z)``; SENTINEL rows become -1."""
    sx, sy, sz = (int(s) for s in spatial_shape)
    k = keys.long()
    z = k % sz
    r = k // sz
    y = r % sy
    r = r // sy
    x = r % sx
    b = r // sx
    coords = torch.stack([b, x, y, z], dim=1).to(torch.int32)
    return torch.where((keys == SENTINEL)[:, None], -1, coords)


def sort_unique(keys: torch.Tensor):
    """Sorted live unique keys and the inverse map.

    Returns (unique_keys (U,) int32 ascending, inverse (N,) int64 with U for
    SENTINEL rows) — the capacity-free form of the JAX ``sort_unique``.
    """
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    if uniq.numel() and int(uniq[-1]) == SENTINEL:
        uniq = uniq[:-1]
    return uniq, inverse


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Binary-search membership: index of each query in ``sorted_keys`` or
    -1 (int32)."""
    if sorted_keys.numel() == 0:
        return torch.full(queries.shape, -1, dtype=torch.int32,
                          device=queries.device)
    pos = torch.searchsorted(sorted_keys, queries)
    pos = pos.clamp_(0, sorted_keys.shape[0] - 1)
    found = (sorted_keys[pos] == queries) & (queries != SENTINEL)
    return torch.where(found, pos, -1).to(torch.int32)
