"""Sparse 3D convolution engine (port of treelearn_tpu/ops/sparse.py).

* Every U-Net level's active set is a :class:`SparseGrid`: sorted int32 keys
  of exactly ``n_active`` voxels (the JAX package pads to a static capacity;
  eager PyTorch needs no padding).
* Submanifold conv: a (27, V) gather rulebook, one row per kernel offset in
  ``kernel_offsets`` order.  :func:`build_subm_rulebook` and
  :func:`subm_conv` here are the plain PyTorch versions of the rulebook and
  subm-conv kernels (ops/rulebook.py, ops/subm_conv.py), which the model
  calls through their wrappers.
* Strided conv k=2 s=2 (SparseConv3d) and its inverse share one
  :class:`DownsampleRulebook` (spconv ``indice_key`` sharing).  The JAX
  package runs these outside Pallas (model/blocks.py:64-72), and so does the
  port: one wide matmul, a corner select and a sum over the parents'
  corner slots / a gather.  Nothing here adds with atomics, so a launch on
  the card gives the same bits every time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .hashing import SENTINEL, decode_keys, encode_keys, lookup, sort_unique


class SparseGrid(NamedTuple):
    """Active voxel set of one U-Net level."""

    keys: torch.Tensor      # (V,) sorted int32
    coords: torch.Tensor    # (V, 4) int32 (b, x, y, z)
    spatial_shape: tuple    # (X, Y, Z) python ints

    @property
    def n_active(self) -> int:
        return self.keys.shape[0]


def grid_from_sorted_keys(keys: torch.Tensor, spatial_shape) -> SparseGrid:
    spatial_shape = tuple(int(s) for s in spatial_shape)
    return SparseGrid(keys=keys, coords=decode_keys(keys, spatial_shape),
                      spatial_shape=spatial_shape)


def kernel_offsets(kernel_size: int, device=None) -> torch.Tensor:
    """(K, 3) int32 offsets, lexicographic (dx slowest, dz fastest)."""
    r = kernel_size // 2
    ax = torch.arange(-r, kernel_size - r, dtype=torch.int32, device=device)
    dx, dy, dz = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)], dim=1)


def build_subm_rulebook(grid: SparseGrid, kernel_size: int = 3) -> torch.Tensor:
    """Plain rulebook: (K, V) int32 into V, -1 = no input voxel.

    out[i] = sum_k W[k] @ feat[rule[k, i]]; neighbor probes are input-gathers
    at out + offset (torch/spconv SubMConv3d cross-correlation).  One binary
    search of the sorted keys per (offset, voxel).
    """
    offs = kernel_offsets(kernel_size, grid.keys.device)
    coords = grid.coords
    v = coords.shape[0]
    rows = []
    for chunk in offs.split(27):     # 27 offsets' probes a pass
        nbr = coords[None].repeat(chunk.shape[0], 1, 1)
        nbr[:, :, 1:] += chunk[:, None, :]
        rows.append(lookup(grid.keys, encode_keys(
            nbr.view(-1, 4), grid.spatial_shape)).view(chunk.shape[0], v))
    return torch.cat(rows, dim=0)


def build_subm_rulebook_banded(grid: SparseGrid) -> torch.Tensor:
    """Plain k=3 rulebook in band form, the algorithm of csrc/rulebook.cu:
    the same (27, V) int32 rule as :func:`build_subm_rulebook`.

    z is the fastest key digit, so the three dz targets of a (dx, dy) band
    have adjacent keys T-1, T, T+1 and sit in consecutive slots from
    ``p = lower_bound(T-1)``: one search per band (none for the centre band,
    whose candidates are slots i-1, i, i+1), then the keys at p, p+1, p+2
    are matched against the three targets by key, under the x/y guards of
    the band and the z guards of dz = -1 and dz = +1.
    """
    keys = grid.keys
    v = keys.shape[0]
    sx, sy, sz = grid.spatial_shape
    rule = torch.full((27, v), -1, dtype=torch.int32, device=keys.device)
    if v == 0:
        return rule
    keys64 = keys.long()
    x, y, z = (grid.coords[:, a].long() for a in (1, 2, 3))
    z_ok = (z > 0, torch.ones_like(z, dtype=torch.bool), z < sz - 1)
    slots = torch.arange(v, device=keys.device)
    for band in range(9):
        dx, dy = band // 3 - 1, band % 3 - 1
        ok = ((x + dx >= 0) & (x + dx < sx) & (y + dy >= 0) & (y + dy < sy))
        first = keys64 + (dx * sy * sz + dy * sz - 1)
        p = slots - 1 if band == 4 else torch.searchsorted(keys64, first)
        for j in range(3):
            slot = p + j
            inside = (slot >= 0) & (slot < v)
            d = keys64[slot.clamp(0, v - 1)] - first
            for dz in range(3):
                hit = ok & inside & (d == dz) & z_ok[dz]
                rule[band * 3 + dz] = torch.where(
                    hit, slot.to(torch.int32), rule[band * 3 + dz])
    return rule


class DownsampleRulebook(NamedTuple):
    """Child->parent map of a k=2 s=2 strided conv and its inverse."""

    parent_idx: torch.Tensor  # (V_in,) int64 into V_out, -1 = dropped child
    corner: torch.Tensor      # (V_in,) int64 in [0, 8)
    out_grid: SparseGrid


def build_downsample(grid: SparseGrid) -> DownsampleRulebook:
    """Output set + rulebook of SparseConv3d(k=2, s=2, pad=0): output dim =
    in // 2 per axis, and children whose parent falls outside are dropped
    (spconv's valid-window rule)."""
    out_shape = tuple(s // 2 for s in grid.spatial_shape)
    child = grid.coords
    parent_xyz = child[:, 1:] // 2
    hi = torch.tensor(out_shape, dtype=child.dtype, device=child.device)
    valid = torch.all(parent_xyz < hi[None, :], dim=1)
    parent_keys = encode_keys(torch.cat([child[:, :1], parent_xyz], dim=1),
                              out_shape)
    parent_keys = torch.where(valid, parent_keys, SENTINEL)
    out_keys, inverse = sort_unique(parent_keys)
    parent_idx = torch.where(valid, inverse, -1)
    cxyz = (child[:, 1:] - parent_xyz * 2).long()
    corner = (cxyz[:, 0] * 2 + cxyz[:, 1]) * 2 + cxyz[:, 2]
    corner = torch.where(parent_idx >= 0, corner, 0)
    return DownsampleRulebook(parent_idx=parent_idx, corner=corner,
                              out_grid=grid_from_sorted_keys(out_keys,
                                                             out_shape))


def subm_conv(feats: torch.Tensor, weight: torch.Tensor, rule: torch.Tensor,
              n_live=None) -> torch.Tensor:
    """Plain rulebook conv: feats (V_in, Cin), weight (K, Cin, Cout),
    rule (K, V_out) -> (V_out, Cout) in feats' dtype.

    Products of the working type are summed in float32, as the CUDA kernel
    (ops/subm_conv.py) and the Pallas kernel it replaces do; rows at or past
    ``n_live`` (default V_out) are zero.
    """
    v_out = rule.shape[1]
    cout = weight.shape[2]
    w = weight.to(feats.dtype).float()
    acc = torch.zeros((v_out, cout), dtype=torch.float32, device=feats.device)
    for k in range(rule.shape[0]):
        idx = rule[k].long()
        m = idx >= 0
        if not bool(m.any()):
            continue
        rows = torch.nonzero(m).squeeze(1)
        acc.index_add_(0, rows, feats[idx[rows]].float() @ w[k])
    if n_live is not None and n_live < v_out:
        acc[n_live:] = 0
    return acc.to(feats.dtype)


def _corner_select(wide: torch.Tensor, corner: torch.Tensor) -> torch.Tensor:
    return wide[torch.arange(wide.shape[0], device=wide.device), corner]


def down_conv(feats: torch.Tensor, weight: torch.Tensor,
              rb: DownsampleRulebook) -> torch.Tensor:
    """Strided conv k=2 s=2: feats (V_in, Cin), weight (8, Cin, Cout) ->
    (V_out, Cout): one wide matmul (V_in, Cin) @ (Cin, 8*Cout), a per-row
    corner select, and each parent's sum over its 8 corner slots (a child
    is the only one in its (parent, corner) slot), in corner order: an
    ``index_add_`` would add with atomics on the card, in an order that
    changes from launch to launch."""
    cin, cout = weight.shape[1], weight.shape[2]
    w = weight.to(feats.dtype).permute(1, 0, 2).reshape(cin, 8 * cout)
    wide = (feats @ w).reshape(-1, 8, cout)
    contrib = _corner_select(wide, rb.corner)
    keep = rb.parent_idx >= 0
    slots = torch.zeros((rb.out_grid.n_active * 8, cout), dtype=feats.dtype,
                        device=feats.device)
    slots[rb.parent_idx[keep] * 8 + rb.corner[keep]] = contrib[keep]
    return slots.view(-1, 8, cout).sum(1)


def inverse_conv(coarse_feats: torch.Tensor, weight: torch.Tensor,
                 rb: DownsampleRulebook) -> torch.Tensor:
    """Inverse conv k=2 (SparseInverseConv3d): coarse (V_out, Cin) -> fine
    (V_in, Cout) through the transposed rulebook; dropped children get
    zeros."""
    cin, cout = weight.shape[1], weight.shape[2]
    w = weight.to(coarse_feats.dtype).permute(1, 0, 2).reshape(cin, 8 * cout)
    keep = rb.parent_idx >= 0
    if coarse_feats.shape[0] == 0:
        return coarse_feats.new_zeros((rb.parent_idx.shape[0], cout))
    gathered = coarse_feats[rb.parent_idx.clamp(min=0)]
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    wide = (gathered @ w).reshape(-1, 8, cout)
    out = _corner_select(wide, rb.corner)
    return torch.where(keep[:, None], out, torch.zeros_like(out))


def subm_conv_dw(x: torch.Tensor, g: torch.Tensor,
                 rule: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient of :func:`subm_conv`: x (V_in, Cin), g (V_out,
    Cout) in one working type, rule (K, V_out) -> (K, Cin, Cout) float32,
    ``dW[k] = sum_i x[rule[k, i]]^T g[i]``: per offset, the gathered rows'
    transpose times g, products of the working type summed in float32 (the
    counterpart of rule_conv_dw_xla, pallas_conv.py:563-575)."""
    k_off, cin, cout = rule.shape[0], x.shape[1], g.shape[1]
    dw = torch.zeros((k_off, cin, cout), dtype=torch.float32, device=x.device)
    gf = g.float()
    for k in range(k_off):
        idx = rule[k].long()
        rows = torch.nonzero(idx >= 0).squeeze(1)
        if rows.numel():
            dw[k] = x[idx[rows]].float().t() @ gf[rows]
    return dw
