"""Neighborhood moments for verticality — kernel 4 of the port.

Replaces the Pallas kernel ``_vert_kernel`` / ``_vert_pallas_call``
(treelearn_tpu/ops/pallas_vert.py:68,137, driven by ``verticality_banded``
:216).  The TPU kernel walks banded DMA windows of the xy-cell-sorted refs
per tile of 64 queries and flags tiles whose neighborhood overflows the
window.  Nothing ties a GPU thread to xy columns, so here the cells are
three-dimensional and prune in z too:

* refs and queries are sorted by the key ``(ix * ny + iy) * nz + iz`` with z
  fastest, so for each of the 9 (dx, dy) neighbors the three cells iz - 1 ..
  iz + 1 are one contiguous range of sorted refs: a query has 9 short
  ranges instead of 3 whole columns.  The ranges come from a dense
  cell-start table over the bounding box; a box too large for it
  (``DENSE_CELLS``) takes the xy table in the same form (nz = 1, each of the
  9 ranges one xy cell's column).
* queries of one cell (a *group*, a run of equal keys) share their ranges.
  The kernel (csrc/vert.cu) gives a warp one work item of
  :func:`group_items`: up to 32 queries of a group x 32 / ``qs`` partitions
  of the group's candidates, staged through shared memory as 16-byte records
  so that every staged ref serves all the item's queries.

xy cell indices are ``floor(x * f32(1 / radius))`` — never ``x / radius`` —
as the JAX package computes them (pallas_vert.py:149-155).  The z cell is a
hair larger than the radius (``radius * (1 + 2**-10)``): the TPU kernel has
no z cells, so the z cells here must never hide an in-radius ref, and with a
cell of exactly the radius a ref at ``dz == radius`` could land two cells up
when the query sits a rounding error below a cell boundary.  The margin
covers the rounding of the products for |z| up to thousands of cells.

The 10 moments are float32 sums of ref - query (never bf16: E[x^2] - E[x]^2
cancels); the eigen step (ops/features.py:verticality_from_cov6) runs in
PyTorch afterwards, and the result is rounded through float16 as
pallas_vert.py:213 does, so thresholding at ``tau_vert`` sees the same
rounding.

Bound on the card: the float32 rate (about 30 operations per in-radius
pair) on dense clouds, memory on sparse ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

DENSE_CELLS = 1 << 26     # largest dense cell-start table (cells)
WARP = 32                 # an item's lanes: queries x candidate partitions
Z_CELL_MARGIN = 1.0 + 2.0 ** -10


class VertProblem(NamedTuple):
    """Refs and queries sorted by cell key, the groups' ranges and items."""

    refs4: torch.Tensor    # (R, 4) f32 records (x, y, z, 0), key-sorted
    queries: torch.Tensor  # (Q, 3) f32, key-sorted
    groups: torch.Tensor   # (G + 1,) int32 starts of the runs of equal key
    ranges: torch.Tensor   # (G, 18) int32 [lo, hi) of the 9 (dx, dy) neighbors
    items: torch.Tensor    # (N, 4) int32 work items, see group_items
    q_order: torch.Tensor  # (Q,) int64: sorted row -> input row
    radius: float
    r2: float              # float32(radius * radius)
    table: str             # "xyz" or "xy"


def _cells(points: torch.Tensor, queries: torch.Tensor, radius: float):
    """Integer cells of refs and queries from the bounding box's corner, and
    the box's size in cells (one host sync)."""
    inv_xy = float(np.float32(1.0) / np.float32(radius))
    inv_z = float(np.float32(1.0) / np.float32(radius * Z_CELL_MARGIN))
    scale = torch.tensor([inv_xy, inv_xy, inv_z], dtype=torch.float32,
                         device=points.device)
    c_r = torch.floor(points[:, :3] * scale).long()
    c_q = torch.floor(queries[:, :3] * scale).long()
    held = [c for c in (c_r, c_q) if c.shape[0]]
    if not held:
        return c_r, c_q, (1, 1, 1)
    lo = torch.stack([c.amin(0) for c in held]).amin(0)
    hi = torch.stack([c.amax(0) for c in held]).amax(0)
    c_r -= lo
    c_q -= lo
    return c_r, c_q, tuple((hi - lo + 1).tolist())


def prepare(points: torch.Tensor, queries: torch.Tensor, radius: float,
            table: str = None) -> VertProblem:
    """Sort refs and queries by cell key, build the dense cell-start table
    and from it each query group's 9 ranges and the work items.  ``table``
    forces the 3-D (``"xyz"``) or the xy table; by default the 3-D one
    wherever its dense table has fewer than ``DENSE_CELLS`` cells."""
    dev = points.device
    c_r, c_q, (nx, ny, nz) = _cells(points, queries, radius)
    if table is None:
        table = "xyz" if nx * ny * nz < DENSE_CELLS else "xy"
    if table == "xy":
        nz = 1
        c_r[:, 2] = 0
        c_q[:, 2] = 0
    n_cells = nx * ny * nz
    if n_cells >= 2**31 - 1:
        raise ValueError(f"verticality cell grid {nx} x {ny} x {nz} too large")
    key_r = (c_r[:, 0] * ny + c_r[:, 1]) * nz + c_r[:, 2]
    key_q = (c_q[:, 0] * ny + c_q[:, 1]) * nz + c_q[:, 2]
    key_r, order_r = torch.sort(key_r, stable=True)
    key_q, order_q = torch.sort(key_q, stable=True)
    cell_start = torch.zeros(n_cells + 1, dtype=torch.int64, device=dev)
    cell_start[1:] = torch.cumsum(torch.bincount(key_r, minlength=n_cells), 0)
    g_key, g_count = torch.unique_consecutive(key_q, return_counts=True)
    groups = torch.zeros(g_key.shape[0] + 1, dtype=torch.int64, device=dev)
    groups[1:] = torch.cumsum(g_count, 0)
    gx = g_key // (ny * nz)
    gy = (g_key // nz) % ny
    gz = g_key % nz
    z_lo = torch.clamp(gz - 1, min=0)
    z_hi = torch.clamp(gz + 1, max=nz - 1)
    bounds = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cx, cy = gx + dx, gy + dy
            ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
            base = (torch.clamp(cx, 0, nx - 1) * ny
                    + torch.clamp(cy, 0, ny - 1)) * nz
            bounds.append(torch.where(ok, cell_start[base + z_lo], 0))
            bounds.append(torch.where(ok, cell_start[base + z_hi + 1], 0))
    refs4 = torch.zeros((points.shape[0], 4), dtype=torch.float32, device=dev)
    refs4[:, :3] = points[order_r, :3]
    groups = groups.to(torch.int32)
    ranges = torch.stack(bounds, 1).to(torch.int32).contiguous()
    return VertProblem(
        refs4=refs4, queries=queries[order_q, :3].contiguous(), groups=groups,
        ranges=ranges, items=group_items(groups, ranges), q_order=order_q,
        radius=float(radius), r2=float(np.float32(radius * radius)),
        table=table)


def group_items(groups: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """Cut the groups into the kernel's work items: (N, 4) int32 rows (first
    sorted query, queries, ``qs``, group).  A warp gives ``qs`` of its lanes
    a query each, ``32 / qs`` times over: that many partitions share the
    group's candidates (partition p takes positions p, p + 32 / qs, ... of
    the 9 ranges laid end to end).  ``qs`` is the power of two that holds the
    group's queries, at most 32, so a group of few queries splits its
    candidates over the lanes that would idle.  The items are ordered by
    their walk's length, longest first: a block's eight warps then take
    about equally long, and the longest walks do not start last (measured on
    the H100: a fifth faster than group order; cutting long lists further
    among more warps was slower at every length, a staged ref serving fewer
    queries).  From the counts alone."""
    dev = groups.device
    g0 = groups[:-1].long()
    n_groups = g0.shape[0]
    if n_groups == 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=dev)
    nq = groups[1:].long() - g0
    rg = ranges.long()
    cand = (rg[:, 1::2] - rg[:, 0::2]).sum(1)
    pow2 = 2 ** torch.arange(0, 5, device=dev)                # 1 .. 16
    # the power of two >= min(nq, 32)
    qs = 2 ** (torch.clamp(nq, max=WARP)[:, None] > pow2[None, :]).sum(1)
    n_slices = -(-nq // qs)
    gid = torch.repeat_interleave(torch.arange(n_groups, device=dev),
                                  n_slices)
    before = torch.cumsum(n_slices, 0) - n_slices
    q0 = g0[gid] + (torch.arange(gid.shape[0], device=dev)
                    - before[gid]) * qs[gid]
    left = g0[gid] + nq[gid] - q0
    items = torch.stack([q0, torch.minimum(left, qs[gid]), qs[gid], gid], 1)
    steps = cand[gid] * qs[gid]          # the walk's length x 32
    order = torch.argsort(steps, descending=True, stable=True)
    return items[order].to(torch.int32).contiguous()


def moments_plain(p: VertProblem, max_block: int = 1 << 24) -> torch.Tensor:
    """(Q, 10) float32 moments, the kernel's arithmetic in PyTorch: range by
    range, the refs of each query's range gathered in query chunks that keep
    each (chunk, span) block under ``max_block`` entries."""
    nq = p.queries.shape[0]
    dev = p.queries.device
    out = torch.zeros((nq, 10), dtype=torch.float32, device=dev)
    if nq == 0:
        return out
    counts = (p.groups[1:] - p.groups[:-1]).long()
    rg = p.ranges.long()[torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts)]   # (Q, 18)
    refs = p.refs4
    r2 = torch.tensor(p.r2, dtype=torch.float32, device=dev)
    for band in range(9):
        s = rg[:, 2 * band]
        span = rg[:, 2 * band + 1] - s
        if int(span.max()) == 0:
            continue
        lo = 0
        while lo < nq:
            width = max(int(span[lo:lo + 4096].max()), 1)
            hi = min(nq, lo + max(1, max_block // width))
            width = max(int(span[lo:hi].max()), 1)
            hi = min(hi, lo + max(1, max_block // width))
            offs = torch.arange(width, device=dev)
            idx = s[lo:hi, None] + offs[None, :]
            m = offs[None, :] < span[lo:hi, None]
            idx = torch.where(m, idx, 0)
            q = p.queries[lo:hi]
            dx = refs[idx, 0] - q[:, 0:1]
            dy = refs[idx, 1] - q[:, 1:2]
            dz = refs[idx, 2] - q[:, 2:3]
            d2 = dx * dx + dy * dy + dz * dz
            w = (m & (d2 <= r2)).to(torch.float32)
            wx, wy, wz = w * dx, w * dy, w * dz
            out[lo:hi] += torch.stack([
                w.sum(1), wx.sum(1), wy.sum(1), wz.sum(1),
                (wx * dx).sum(1), (wx * dy).sum(1), (wx * dz).sum(1),
                (wy * dy).sum(1), (wy * dz).sum(1), (wz * dz).sum(1)], dim=1)
            lo = hi
    return out


def moments(p: VertProblem) -> torch.Tensor:
    """(Q, 10) float32 moments in key-sorted query order.  CPU tensors take
    :func:`moments_plain`; CUDA tensors launch the kernel, one warp per work
    item of ``p.items``."""
    if not p.queries.is_cuda:
        return moments_plain(p)
    for t, name in ((p.refs4, "refs4"), (p.queries, "queries")):
        _cuda.require(t, f"vert {name}", torch.float32, 2)
    for t, name in ((p.ranges, "ranges"), (p.items, "items")):
        _cuda.require(t, f"vert {name}", torch.int32, 2)
    nq = p.queries.shape[0]
    if (p.refs4.shape[1] != 4 or p.queries.shape[1] != 3
            or p.ranges.shape[1] != 18 or p.items.shape[1] != 4):
        raise ValueError(f"vert: shapes refs4 {tuple(p.refs4.shape)}, queries "
                         f"{tuple(p.queries.shape)}, ranges "
                         f"{tuple(p.ranges.shape)}, items "
                         f"{tuple(p.items.shape)}")
    out = torch.empty((nq, 10), dtype=torch.float32, device=p.queries.device)
    if nq == 0:
        return out
    _cuda.record("vert", problem=p)
    code = _cuda.library().tl_vert_moments(
        p.refs4.data_ptr(), p.queries.data_ptr(), p.ranges.data_ptr(),
        p.items.data_ptr(), p.items.shape[0], p.r2, out.data_ptr(),
        _cuda.stream_ptr(p.queries))
    _cuda.check(code, "tl_vert_moments")
    _cuda.LAUNCHES["vert"] += 1
    return out


def vert_from_moments(m: torch.Tensor):
    """(vert, cnt) float32 from (Q, 10) moments, rounded through float16 as
    the Pallas path returns them (pallas_vert.py:203-213)."""
    from .features import verticality_from_cov6

    cnt = m[:, 0]
    c = torch.clamp(cnt, min=1.0)
    ex, ey, ez = m[:, 1] / c, m[:, 2] / c, m[:, 3] / c
    nz = verticality_from_cov6(
        m[:, 4] / c - ex * ex, m[:, 5] / c - ex * ey, m[:, 6] / c - ex * ez,
        m[:, 7] / c - ey * ey, m[:, 8] / c - ey * ez, m[:, 9] / c - ez * ez)
    out = torch.stack([1.0 - nz, cnt], dim=1).to(torch.float16).float()
    return out[:, 0], out[:, 1]


def verticality(points: torch.Tensor, queries: torch.Tensor, radius: float):
    """Exact radius-neighborhood verticality of ``queries`` against
    ``points``: (vert (Q,), cnt (Q,)) float32 in input query order."""
    p = prepare(points, queries, radius)
    vert_s, cnt_s = vert_from_moments(moments(p))
    vert = torch.empty_like(vert_s)
    cnt = torch.empty_like(cnt_s)
    vert[p.q_order] = vert_s
    cnt[p.q_order] = cnt_s
    return vert, cnt
