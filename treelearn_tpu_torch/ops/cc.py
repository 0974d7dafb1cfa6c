"""Eps-graph connected components — kernel 5 of the port.

Replaces the Pallas kernel ``_cc_kernel`` / ``_cc_pallas_call``
(treelearn_tpu/ops/pallas_cc.py:51,116, driven by ``cc_labels_banded``
:210).  DBSCAN(eps, min_samples=2) with the tau_min size filter is the
connected components of the eps-ball graph (ops/cluster.py).  With xy cells
of eps / sqrt(2) each cell is a clique, so per point 25 "found" bits — does
cell (di, dj), di, dj in [-2, 2], hold a point within eps? — carry the whole
graph.  No banded windows, so no overflow fallback, and none of the
window-padding invariants of pallas_cc.py:257-261.  The union-find over cell
representatives stays on the host (scipy), as at pallas_cc.py:280-319.

Which cells neighbor a cell is the cell's answer, not the point's.  The CUDA
kernel (csrc/cc.cu) gives a warp one work item of :func:`cell_items`, up to
32 points of one cell, and looks the 25 neighbor cells up once per item in
band form: the keys of cells (i + di, j - 2 .. j + 2) are consecutive
integers, so one lower bound per row di and a look at the next five entries
finds the row's cells (:func:`neighbor_cells_banded` is that lookup in
PyTorch, :func:`neighbor_cells_probes` the 25 searches it replaces).  Before
a neighbor cell is walked, each point is tested against the bounding box of
that cell's points (:func:`cell_boxes`, :func:`box_rejects`): farther than
eps from the box means no hit and no walk, which is what keeps dense,
far-apart clumps (offset-shifted coordinates under a trained head) from
costing a cell's size squared.  The point's own cell is never walked: the
point itself is within eps.

Cell indices are ``floor(x * f32(1 / cell))``, computed here once and handed
to the kernel.  Bound on the card: memory (16 B read and 4 B written per
point).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

GRID_WIDTH = 30000  # cell-key stride, as treelearn_tpu/ops/cluster.py
WARP = 32           # points of a work item
PROBE = 32          # the plain banded route's first walk, points a cell


class CCProblem(NamedTuple):
    pts: torch.Tensor         # (N, 2) f32, sorted by cell key
    cell_keys: torch.Tensor   # (C,) int32 sorted unique cell keys
    cell_start: torch.Tensor  # (C + 1,) int32 sorted-row start of each cell
    cell_box: torch.Tensor    # (C, 4) f32 (xmin, ymin, xmax, ymax) of its points
    items: torch.Tensor       # (M, 3) int32 work items, see cell_items
    skeys: torch.Tensor       # (N,) int64 cell key of each sorted point
    order: torch.Tensor       # (N,) int64 sorted row -> input row
    eps2: float               # float32(eps * eps)


def prepare(points_xy: torch.Tensor, eps: float) -> CCProblem:
    """Sort the points by cell key (cell = f32(eps / sqrt 2)); per cell its
    points' bounding box; the kernel's work items."""
    cell = np.float32(float(eps) / np.sqrt(2.0))
    inv_cell = float(np.float32(1.0) / cell)
    ij = torch.floor(points_xy[:, :2] * inv_cell).long()
    ij -= ij.min(0).values
    i_max, j_max = ij.amax(0).tolist()
    if j_max >= GRID_WIDTH or (i_max + 3) * GRID_WIDTH >= 2**31:
        raise ValueError("cc: plot too wide for the int32 cell-key grid")
    keys = ij[:, 0] * GRID_WIDTH + ij[:, 1]
    skeys, order = torch.sort(keys, stable=True)
    cell_keys, cell_id, counts = torch.unique_consecutive(
        skeys, return_inverse=True, return_counts=True)
    cell_start = torch.zeros(len(cell_keys) + 1, dtype=torch.int64,
                             device=points_xy.device)
    cell_start[1:] = torch.cumsum(counts, 0)
    pts = points_xy[order, :2].contiguous()
    cell_start = cell_start.to(torch.int32)
    return CCProblem(
        pts=pts, cell_keys=cell_keys.to(torch.int32), cell_start=cell_start,
        cell_box=cell_boxes(pts, cell_id, len(cell_keys)),
        items=cell_items(cell_start), skeys=skeys, order=order,
        eps2=float(np.float32(float(eps) * float(eps))))


def cell_boxes(pts: torch.Tensor, cell_id: torch.Tensor,
               n_cells: int) -> torch.Tensor:
    """(C, 4) float32 (xmin, ymin, xmax, ymax) over each cell's points."""
    idx = cell_id[:, None].expand(-1, 2)
    lo = torch.full((n_cells, 2), torch.inf, dtype=pts.dtype,
                    device=pts.device).scatter_reduce_(0, idx, pts, "amin")
    hi = torch.full((n_cells, 2), -torch.inf, dtype=pts.dtype,
                    device=pts.device).scatter_reduce_(0, idx, pts, "amax")
    return torch.cat([lo, hi], 1).contiguous()


def cell_items(cell_start: torch.Tensor) -> torch.Tensor:
    """Cut the cells into the kernel's work items: (M, 3) int32 rows (cell,
    first sorted point, points), at most ``WARP`` points each, every point
    in exactly one; densest cells first, so the longest walks do not start
    last.  (Smaller slices of dense cells, more lanes a point, were slower
    on the H100 at every size tried: the walks end early, and every item
    pays the neighbor lookup.)"""
    dev = cell_start.device
    cs = cell_start.long()
    counts = cs[1:] - cs[:-1]
    by = torch.argsort(counts, descending=True, stable=True)
    n_slices = (-(-counts // WARP))[by]
    blk = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), n_slices)
    nth = (torch.arange(blk.shape[0], device=dev)
           - (torch.cumsum(n_slices, 0) - n_slices)[blk])
    cid = by[blk]
    first = cs[cid] + nth * WARP
    rows = torch.clamp(cs[cid + 1] - first, max=WARP)
    return torch.stack([cid, first, rows], 1).to(torch.int32).contiguous()


def _cell_rows(p: CCProblem) -> torch.Tensor:
    """(N,) int64 cell of each sorted point."""
    cs = p.cell_start.long()
    return torch.repeat_interleave(
        torch.arange(cs.shape[0] - 1, device=cs.device), cs[1:] - cs[:-1])


def neighbor_cells_probes(cell_keys: torch.Tensor) -> torch.Tensor:
    """(C, 25) int64: for every cell and neighbor offset (di + 2) * 5 +
    (dj + 2) the neighbor cell's position in ``cell_keys`` or -1, by one
    search per offset."""
    keys = cell_keys.long()
    n_cells = keys.shape[0]
    ci0, cj0 = keys // GRID_WIDTH, keys % GRID_WIDTH
    out = []
    for di in range(-2, 3):
        for dj in range(-2, 3):
            ci, cj = ci0 + di, cj0 + dj
            key = ci * GRID_WIDTH + cj
            c = torch.searchsorted(keys, key).clamp_(max=n_cells - 1)
            ok = ((ci >= 0) & (cj >= 0) & (cj < GRID_WIDTH)
                  & (keys[c] == key))
            out.append(torch.where(ok, c, -1))
    return torch.stack(out, 1)


def neighbor_cells_banded(cell_keys: torch.Tensor) -> torch.Tensor:
    """:func:`neighbor_cells_probes` by the kernel's band-form lookup: per
    row di one lower bound of the key of (i + di, j - 2), clipped to the
    grid, and a look at the five entries from there (the row's cells have
    consecutive keys); the own row needs no search, its cells lie within two
    entries of the cell itself."""
    keys = cell_keys.long()
    n_cells = keys.shape[0]
    own = torch.arange(n_cells, device=keys.device)
    ci0, cj0 = keys // GRID_WIDTH, keys % GRID_WIDTH
    out = torch.full((n_cells, 25), -1, dtype=torch.int64, device=keys.device)
    for di in range(-2, 3):
        row = ci0 + di
        center = row * GRID_WIDTH + cj0
        k_lo = row * GRID_WIDTH + torch.clamp(cj0 - 2, min=0)
        k_hi = row * GRID_WIDTH + torch.clamp(cj0 + 2, max=GRID_WIDTH - 1)
        first = own - 2 if di == 0 else torch.searchsorted(keys, k_lo)
        for e in range(5):
            idx = first + e
            inside = (idx >= 0) & (idx < n_cells) & (row >= 0)
            k = keys[torch.clamp(idx, 0, n_cells - 1)]
            hit = inside & (k >= k_lo) & (k <= k_hi)
            col = (di + 2) * 5 + torch.clamp(k - center + 2, 0, 4)
            out[own[hit], col[hit]] = idx[hit]
    return out


def box_rejects(p: CCProblem, nbr: torch.Tensor) -> torch.Tensor:
    """(N, 25) bool: the neighbor cell exists but its points' bounding box
    lies farther than eps from the point, so the cell holds no hit.  The
    lower bound goes through the same rounded steps as the distance test
    (subtract, square, add; each monotone), so it never exceeds the computed
    distance to a point of the box and cannot reject a true hit."""
    cell = _cell_rows(p)
    c = nbr[cell]                                  # (N, 25)
    box = p.cell_box[torch.clamp(c, min=0)]        # (N, 25, 4)
    x, y = p.pts[:, 0:1], p.pts[:, 1:2]
    zero = torch.zeros((), dtype=p.pts.dtype, device=p.pts.device)
    dx = torch.maximum(torch.maximum(box[..., 0] - x, x - box[..., 2]), zero)
    dy = torch.maximum(torch.maximum(box[..., 1] - y, y - box[..., 3]), zero)
    eps2 = torch.tensor(p.eps2, dtype=torch.float32, device=p.pts.device)
    return (c >= 0) & ~(dx * dx + dy * dy <= eps2)


def box_accepts(p: CCProblem, nbr: torch.Tensor) -> torch.Tensor:
    """(N, 25) bool: the neighbor cell exists and even the farthest corner
    of its points' bounding box lies within eps of the point, so every point
    of the cell is a hit.  The upper bound goes through the same rounded
    steps as the distance test (each monotone), so it is never below the
    computed distance to a point of the box."""
    cell = _cell_rows(p)
    c = nbr[cell]
    box = p.cell_box[torch.clamp(c, min=0)]
    x, y = p.pts[:, 0:1], p.pts[:, 1:2]
    dx = torch.maximum(x - box[..., 0], box[..., 2] - x)
    dy = torch.maximum(y - box[..., 1], box[..., 3] - y)
    eps2 = torch.tensor(p.eps2, dtype=torch.float32, device=p.pts.device)
    return (c >= 0) & (dx * dx + dy * dy <= eps2)


def _walk_hits(p: CCProblem, q: torch.Tensor, s: torch.Tensor,
               span: torch.Tensor, max_block: int) -> torch.Tensor:
    """(len(q),) bool: whether any of the ``span[i]`` sorted points from row
    ``s[i]`` lies within eps of sorted point ``q[i]``, gathered in chunks of
    at most ``max_block`` candidates."""
    dev = p.pts.device
    m = q.shape[0]
    hit = torch.zeros(m, dtype=torch.bool, device=dev)
    eps2 = torch.tensor(p.eps2, dtype=torch.float32, device=dev)
    lo = 0
    while lo < m:
        width = max(int(span[lo:lo + 4096].max()), 1)
        hi = min(m, lo + max(1, max_block // width))
        width = max(int(span[lo:hi].max()), 1)
        hi = min(hi, lo + max(1, max_block // width))
        offs = torch.arange(width, device=dev)
        mk = offs[None, :] < span[lo:hi, None]
        idx = torch.where(mk, s[lo:hi, None] + offs[None, :], 0)
        qp = p.pts[q[lo:hi]]
        dx = p.pts[idx, 0] - qp[:, 0:1]
        dy = p.pts[idx, 1] - qp[:, 1:2]
        hit[lo:hi] = (mk & (dx * dx + dy * dy <= eps2)).any(1)
        lo = hi
    return hit


def found_bits_plain(p: CCProblem, max_block: int = 1 << 24,
                     banded: bool = False) -> torch.Tensor:
    """(N,) int32 found-bit masks in sorted order, the kernel's arithmetic in
    PyTorch: per neighbor offset, the neighbor cell's row range, gathered in
    point chunks of at most ``max_block`` candidates.  With ``banded`` the
    kernel's own route: the band-form cell lookup, the own cell's bit set
    without a walk, and no walk where :func:`box_rejects`; on top of it two
    shortcuts that cannot change a bit and keep the CPU pass from costing a
    cell's size squared where eps is coarse: the bit set without a walk
    where :func:`box_accepts`, and a first walk of ``PROBE`` points, after
    which only the points it left unfound walk the rest (the kernel's walk
    ends at its first hit)."""
    n = p.pts.shape[0]
    dev = p.pts.device
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    cs = p.cell_start.long()
    cell = _cell_rows(p)
    if banded:
        nbr = neighbor_cells_banded(p.cell_keys)
        accept = box_accepts(p, nbr)
        skip = box_rejects(p, nbr) | accept
        skip[:, 12] = True
        accept[:, 12] = True
    else:
        nbr = neighbor_cells_probes(p.cell_keys)
    rows = torch.arange(n, device=dev)
    for bit in range(25):
        c = nbr[cell, bit]
        ok = c >= 0
        if banded:
            out |= accept[:, bit].to(torch.int32) << bit
            ok &= ~skip[:, bit]
        c = torch.clamp(c, min=0)
        s = torch.where(ok, cs[c], 0)
        span = torch.where(ok, cs[c + 1] - cs[c], 0)
        if int(span.max()) == 0:
            continue
        if not banded:
            hit = _walk_hits(p, rows, s, span, max_block)
        else:
            hit = _walk_hits(p, rows, s, torch.clamp(span, max=PROBE),
                             max_block)
            rest = torch.nonzero(~hit & (span > PROBE)).squeeze(1)
            if rest.shape[0]:
                hit[rest] = _walk_hits(p, rest, s[rest] + PROBE,
                                       span[rest] - PROBE, max_block)
        out |= hit.to(torch.int32) << bit
    return out


def _check(p: CCProblem) -> torch.Tensor:
    """Wrapper-side checks of a CUDA problem; returns the empty output."""
    _cuda.require(p.pts, "cc pts", torch.float32, 2)
    _cuda.require(p.cell_box, "cc cell_box", torch.float32, 2)
    for t, name in ((p.cell_keys, "cell_keys"), (p.cell_start, "cell_start"),
                    (p.items, "items")):
        _cuda.require(t, f"cc {name}", torch.int32)
    n_cells = p.cell_keys.shape[0]
    if (p.pts.shape[1] != 2 or p.cell_box.shape != (n_cells, 4)
            or p.cell_start.shape != (n_cells + 1,)
            or p.items.shape[1:] != (3,)):
        raise ValueError(f"cc: shapes pts {tuple(p.pts.shape)}, cell_box "
                         f"{tuple(p.cell_box.shape)}, cell_start "
                         f"{tuple(p.cell_start.shape)}, items "
                         f"{tuple(p.items.shape)}")
    return torch.empty(p.pts.shape[0], dtype=torch.int32, device=p.pts.device)


def found_bits(p: CCProblem) -> torch.Tensor:
    """(N,) int32 found-bit masks in sorted order.  CPU tensors take
    :func:`found_bits_plain` on the kernel's route (``banded``); CUDA
    tensors launch the kernel, one warp per work item of ``p.items``."""
    if not p.pts.is_cuda:
        return found_bits_plain(p, banded=True)
    out = _check(p)
    if out.shape[0] == 0:
        return out
    _cuda.record("cc", problem=p)
    code = _cuda.library().tl_cc_found_bits(
        p.pts.data_ptr(), p.cell_keys.data_ptr(), p.cell_start.data_ptr(),
        p.cell_box.data_ptr(), p.items.data_ptr(), p.items.shape[0],
        p.cell_keys.shape[0], GRID_WIDTH, p.eps2, out.data_ptr(),
        _cuda.stream_ptr(p.pts))
    _cuda.check(code, "tl_cc_found_bits")
    _cuda.LAUNCHES["cc"] += 1
    return out


def components_from_bits(masks: np.ndarray, skeys: np.ndarray,
                         order: np.ndarray) -> np.ndarray:
    """Host union-find over cell representatives (pallas_cc.py:280-319):
    (N,) int64 labels, each the minimum input index of its component."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as scipy_cc

    n = len(skeys)
    found = ((masks[:, None] >> np.arange(25)[None, :]) & 1).astype(bool)
    first = np.ones(n, bool)
    first[1:] = skeys[1:] != skeys[:-1]
    cell_id = np.cumsum(first) - 1
    n_cells = int(cell_id[-1]) + 1
    starts = np.flatnonzero(first)
    cell_found = np.bitwise_or.reduceat(found, starts, axis=0)
    cell_keys = skeys[starts]
    cij = np.stack([cell_keys // GRID_WIDTH, cell_keys % GRID_WIDTH], axis=1)
    qi = cij[:, 0:1] + np.arange(-2, 3).repeat(5)[None, :]
    qj = cij[:, 1:2] + np.tile(np.arange(-2, 3), 5)[None, :]
    nbr_keys = qi.astype(np.int64) * GRID_WIDTH + qj
    nbr_cell = np.searchsorted(cell_keys, nbr_keys.ravel(),
                               side="left").reshape(n_cells, 25)
    src = np.broadcast_to(np.arange(n_cells)[:, None],
                          (n_cells, 25))[cell_found]
    dst = np.minimum(nbr_cell, n_cells - 1)[cell_found]
    graph = coo_matrix((np.ones(len(src), np.int8), (src, dst)),
                       shape=(n_cells, n_cells))
    _, cell_comp = scipy_cc(graph, directed=False)
    comp = cell_comp[cell_id]
    comp_min = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(comp_min, comp, order)
    labels = np.empty(n, np.int64)
    labels[order] = comp_min[comp]
    return labels


def cc_labels(points_xy: torch.Tensor, eps: float) -> np.ndarray:
    """Connected components of the eps-ball graph over 2-D points (on any
    device): (N,) int64 labels, each the minimum input index of its
    component — the contract of pallas_cc.py:cc_labels_banded."""
    n = points_xy.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    p = prepare(points_xy, eps)
    masks = found_bits(p).cpu().numpy()
    return components_from_bits(masks, p.skeys.cpu().numpy(),
                                p.order.cpu().numpy())
