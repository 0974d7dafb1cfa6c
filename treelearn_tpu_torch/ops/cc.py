"""Eps-graph connected components — kernel 4 of the port.

Replaces the Pallas kernel ``_cc_kernel`` / ``_cc_pallas_call``
(treelearn_tpu/ops/pallas_cc.py:51,116, driven by ``cc_labels_banded``
:210).  DBSCAN(eps, min_samples=2) with the tau_min size filter is the
connected components of the eps-ball graph (ops/cluster.py).  With xy cells
of eps / sqrt(2) each cell is a clique, so per point 25 "found" bits — does
cell (di, dj), di, dj in [-2, 2], hold a point within eps? — carry the whole
graph.  The CUDA kernel (csrc/cc.cu) gives each point a thread that looks
the 25 neighbor cells up in the sorted unique cell keys and walks each
until it finds a point within eps.  No banded windows, so no overflow
fallback, and none of the window-padding invariants of pallas_cc.py:257-261.
The union-find over cell representatives stays on the host (scipy), as at
pallas_cc.py:280-319.

Cell indices are ``floor(x * f32(1 / cell))``, computed here once and handed
to the kernel.  Bound on the card: memory (16 B read and 4 B written per
point; the neighbor-cell walks hit L1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

GRID_WIDTH = 30000  # cell-key stride, as treelearn_tpu/ops/cluster.py


class CCProblem(NamedTuple):
    pts: torch.Tensor         # (N, 2) f32, sorted by cell key
    cell_ij: torch.Tensor     # (N, 2) int32 (i, j) of each sorted point
    cell_keys: torch.Tensor   # (C,) int32 sorted unique cell keys
    cell_start: torch.Tensor  # (C + 1,) int32 sorted-row start of each cell
    skeys: torch.Tensor       # (N,) int64 cell key of each sorted point
    order: torch.Tensor       # (N,) int64 sorted row -> input row
    eps2: float               # float32(eps * eps)


def prepare(points_xy: torch.Tensor, eps: float) -> CCProblem:
    """Sort the points by cell key (cell = f32(eps / sqrt 2))."""
    cell = np.float32(float(eps) / np.sqrt(2.0))
    inv_cell = float(np.float32(1.0) / cell)
    ij = torch.floor(points_xy[:, :2] * inv_cell).long()
    ij -= ij.min(0).values
    if int(ij[:, 1].max()) >= GRID_WIDTH or \
            (int(ij[:, 0].max()) + 3) * GRID_WIDTH >= 2**31:
        raise ValueError("cc: plot too wide for the int32 cell-key grid")
    keys = ij[:, 0] * GRID_WIDTH + ij[:, 1]
    skeys, order = torch.sort(keys, stable=True)
    cell_keys, counts = torch.unique_consecutive(skeys, return_counts=True)
    cell_start = torch.zeros(len(cell_keys) + 1, dtype=torch.int64,
                             device=points_xy.device)
    cell_start[1:] = torch.cumsum(counts, 0)
    return CCProblem(
        pts=points_xy[order, :2].contiguous(),
        cell_ij=ij[order].to(torch.int32).contiguous(),
        cell_keys=cell_keys.to(torch.int32),
        cell_start=cell_start.to(torch.int32),
        skeys=skeys, order=order,
        eps2=float(np.float32(float(eps) * float(eps))))


def found_bits_plain(p: CCProblem, max_block: int = 1 << 24) -> torch.Tensor:
    """(N,) int32 found-bit masks in sorted order, the kernel's arithmetic in
    PyTorch: per neighbor offset, the neighbor cell's row range, gathered in
    point chunks of at most ``max_block`` candidates."""
    n = p.pts.shape[0]
    dev = p.pts.device
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    keys = p.cell_keys.long()
    cs = p.cell_start.long()
    n_cells = keys.shape[0]
    ci0 = p.cell_ij[:, 0].long()
    cj0 = p.cell_ij[:, 1].long()
    eps2 = torch.tensor(p.eps2, dtype=torch.float32, device=dev)
    for di in range(-2, 3):
        for dj in range(-2, 3):
            bit = (di + 2) * 5 + (dj + 2)
            ci, cj = ci0 + di, cj0 + dj
            ok = (ci >= 0) & (cj >= 0) & (cj < GRID_WIDTH)
            key = ci * GRID_WIDTH + cj
            c = torch.searchsorted(keys, key).clamp_(max=n_cells - 1)
            ok &= keys[c] == key
            s = torch.where(ok, cs[c], 0)
            span = torch.where(ok, cs[c + 1] - cs[c], 0)
            if n == 0 or int(span.max()) == 0:
                continue
            lo = 0
            while lo < n:
                width = max(int(span[lo:lo + 4096].max()), 1)
                hi = min(n, lo + max(1, max_block // width))
                width = max(int(span[lo:hi].max()), 1)
                offs = torch.arange(width, device=dev)
                m = offs[None, :] < span[lo:hi, None]
                idx = torch.where(m, s[lo:hi, None] + offs[None, :], 0)
                dx = p.pts[idx, 0] - p.pts[lo:hi, 0:1]
                dy = p.pts[idx, 1] - p.pts[lo:hi, 1:2]
                hit = (m & (dx * dx + dy * dy <= eps2)).any(1)
                out[lo:hi] |= hit.to(torch.int32) << bit
                lo = hi
    return out


def found_bits(p: CCProblem) -> torch.Tensor:
    """(N,) int32 found-bit masks in sorted order.  CPU tensors take
    :func:`found_bits_plain`; CUDA tensors launch the kernel."""
    if not p.pts.is_cuda:
        return found_bits_plain(p)
    _cuda.require(p.pts, "cc pts", torch.float32, 2)
    for t, name in ((p.cell_ij, "cell_ij"), (p.cell_keys, "cell_keys"),
                    (p.cell_start, "cell_start")):
        _cuda.require(t, f"cc {name}", torch.int32)
    n = p.pts.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=p.pts.device)
    if n == 0:
        return out
    _cuda.record("cc", problem=p)
    lib = _cuda.library()
    code = lib.tl_cc_found_bits(
        p.pts.data_ptr(), p.cell_ij.data_ptr(), p.cell_keys.data_ptr(),
        p.cell_start.data_ptr(), n, p.cell_keys.shape[0], GRID_WIDTH, p.eps2,
        out.data_ptr(), _cuda.stream_ptr(p.pts))
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
