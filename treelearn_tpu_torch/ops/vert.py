"""Neighborhood moments for verticality — kernel 3 of the port.

Replaces the Pallas kernel ``_vert_kernel`` / ``_vert_pallas_call``
(treelearn_tpu/ops/pallas_vert.py:68,137, driven by ``verticality_banded``
:216).  The TPU kernel walks banded DMA windows of the cell-sorted refs per
tile of 64 queries and flags tiles whose neighborhood overflows the window;
the CUDA kernel (csrc/vert.cu) gives each query its own thread, which walks
the 3 x 3 xy cells around it through a dense cell-start table.  There is no
window, so there is no overflow path.

Cell indices are ``floor(x * f32(1 / radius))`` — never ``x / radius`` —
computed once here in PyTorch and handed to the kernel, so the host-side
sort and the device walk can never disagree on a boundary point
(pallas_vert.py:149-155).  The 10 moments are float32 sums of ref - query
(never bf16: E[x^2] - E[x]^2 cancels); the eigen step
(ops/features.py:verticality_from_cov6) runs in PyTorch afterwards, and the
result is rounded through float16 as pallas_vert.py:213 does, so
thresholding at ``tau_vert`` sees the same rounding.

Bound on the card: memory for sparse clouds, the float32 rate for dense
ones (about 30 operations per candidate ref).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _cuda


class VertProblem(NamedTuple):
    """Refs sorted by xy cell, queries sorted by xy cell, and the table."""

    refs: torch.Tensor        # (R, 3) f32, cell-sorted
    queries: torch.Tensor     # (Q, 3) f32, cell-sorted
    q_cell: torch.Tensor      # (Q, 2) int32 (i, j) cell of each query
    cell_start: torch.Tensor  # (ni * nj + 1,) int32
    q_order: torch.Tensor     # (Q,) int64: sorted row -> input row
    ni: int
    nj: int
    r2: float                 # float32(radius * radius)


def prepare(points: torch.Tensor, queries: torch.Tensor,
            radius: float) -> VertProblem:
    """Sort refs and queries by xy cell (cell = radius) and build the dense
    cell-start table over the cells' bounding box."""
    inv_cell = float(np.float32(1.0) / np.float32(radius))
    ij_r = torch.floor(points[:, :2] * inv_cell).long()
    ij_q = torch.floor(queries[:, :2] * inv_cell).long()
    mins = torch.minimum(ij_r.min(0).values, ij_q.min(0).values)
    ij_r -= mins
    ij_q -= mins
    ni = int(max(int(ij_r[:, 0].max()), int(ij_q[:, 0].max()))) + 1
    nj = int(max(int(ij_r[:, 1].max()), int(ij_q[:, 1].max()))) + 1
    if ni * nj >= 2**31 - 1:
        raise ValueError(f"verticality cell grid {ni} x {nj} too large")
    lin_r = ij_r[:, 0] * nj + ij_r[:, 1]
    lin_r, order_r = torch.sort(lin_r, stable=True)
    lin_q = ij_q[:, 0] * nj + ij_q[:, 1]
    _, order_q = torch.sort(lin_q, stable=True)
    counts = torch.bincount(lin_r, minlength=ni * nj)
    cell_start = torch.zeros(ni * nj + 1, dtype=torch.int64,
                             device=points.device)
    cell_start[1:] = torch.cumsum(counts, 0)
    return VertProblem(
        refs=points[order_r].contiguous(),
        queries=queries[order_q].contiguous(),
        q_cell=ij_q[order_q].to(torch.int32).contiguous(),
        cell_start=cell_start.to(torch.int32),
        q_order=order_q, ni=ni, nj=nj,
        r2=float(np.float32(radius * radius)))


def moments_plain(p: VertProblem, max_block: int = 1 << 24) -> torch.Tensor:
    """(Q, 10) float32 moments, the kernel's arithmetic in PyTorch: per cell
    row, the contiguous ref range of the query's 3 cells, gathered in query
    chunks that keep each (chunk, span) block under ``max_block`` entries."""
    nq = p.queries.shape[0]
    dev = p.queries.device
    out = torch.zeros((nq, 10), dtype=torch.float32, device=dev)
    qi = p.q_cell[:, 0].long()
    qj = p.q_cell[:, 1].long()
    jlo = torch.clamp(qj - 1, min=0)
    jhi = torch.clamp(qj + 1, max=p.nj - 1)
    cs = p.cell_start.long()
    r2 = torch.tensor(p.r2, dtype=torch.float32, device=dev)
    for di in (-1, 0, 1):
        ci = qi + di
        ok = (ci >= 0) & (ci < p.ni)
        base = torch.clamp(ci, 0, p.ni - 1) * p.nj
        s = torch.where(ok, cs[base + jlo], 0)
        e = torch.where(ok, cs[base + jhi + 1], 0)
        span = e - s
        if nq == 0 or int(span.max()) == 0:
            continue
        lo = 0
        while lo < nq:
            width = max(int(span[lo:lo + 4096].max()), 1)
            hi = min(nq, lo + max(1, max_block // width))
            width = max(int(span[lo:hi].max()), 1)
            offs = torch.arange(width, device=dev)
            idx = s[lo:hi, None] + offs[None, :]
            m = offs[None, :] < span[lo:hi, None]
            idx = torch.where(m, idx, 0)
            q = p.queries[lo:hi]
            dx = p.refs[idx, 0] - q[:, 0:1]
            dy = p.refs[idx, 1] - q[:, 1:2]
            dz = p.refs[idx, 2] - q[:, 2:3]
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
    """(Q, 10) float32 moments in cell-sorted query order.  CPU tensors take
    :func:`moments_plain`; CUDA tensors launch the kernel."""
    if not p.queries.is_cuda:
        return moments_plain(p)
    for t, name in ((p.refs, "refs"), (p.queries, "queries")):
        _cuda.require(t, f"vert {name}", torch.float32, 2)
    _cuda.require(p.q_cell, "vert q_cell", torch.int32, 2)
    _cuda.require(p.cell_start, "vert cell_start", torch.int32, 1)
    nq = p.queries.shape[0]
    out = torch.empty((nq, 10), dtype=torch.float32, device=p.queries.device)
    if nq == 0:
        return out
    _cuda.record("vert", problem=p)
    lib = _cuda.library()
    code = lib.tl_vert_moments(
        p.refs.data_ptr(), p.queries.data_ptr(), p.q_cell.data_ptr(),
        p.cell_start.data_ptr(), nq, p.ni, p.nj, p.r2, out.data_ptr(),
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
